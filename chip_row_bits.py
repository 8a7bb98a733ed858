"""Does a row's result on the card depend on how many rows share the call?

    python3 chip_row_bits.py

An engine split across ranks runs each rank's rows on their own, and its
tokens must equal one process's bit for bit, so every op of the serving
path must give a row the same bits at any row count. For llama3.2-1b
(16 layers; scopes head and all) and deepseek-v2-lite-16b (4 layers;
scopes moe and all) at published widths, random weights from seed 0 and
``chip_smoke.py``'s serving geometry, this runs one decode step of 8 slots
(after the 8-request wave's admission and a first step) and one prefill
``[8, 8]``, then the same programs on rows 0-3 alone; deepseek's 8 rows
form 2 MoE dispatch groups (a stand-in mesh), its 4 rows one, as an
engine across 2 ranks runs them. The model's layer functions are wrapped
to keep their outputs, and each program prints whether rows 0-3 of the
hidden states (and, for decode, of the head's logits) are bit-identical,
and the first layer function whose rows differ, with its largest
difference. The last line is one JSON object of those results beside the
card's name and power limit. It checks nothing (a diagnostic); needs a
CUDA device and exits 1 without one.
"""
from __future__ import annotations

import contextlib
import functools
import json
import sys

import chip_smoke as cs

WRAPPED = ("apply_norm", "apply_mla", "apply_moe", "route", "dense",
           "dense_fanout", "apply_mlp", "_rows_matmul", "_rows_mean",
           "_sum_in_order", "rope")
ATTENTION = ("_softmax_attend",)
PATHS = ((cs.LLAMA, ("head", "all")), (cs.DEEPSEEK, ("moe", "all")))
ROWS, HALF = 8, 4


def _wrap(mod, name, log):
    fn = getattr(mod, name)

    @functools.wraps(fn)
    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        outs = out if isinstance(out, (tuple, list)) else [out]
        log.append((name, [o.detach().clone() if hasattr(o, "detach")
                           else None for o in outs]))
        return out

    setattr(mod, name, wrapped)
    return fn


def _first_difference(full, half) -> dict:
    """The first wrapped call whose outputs' rows of the half run differ
    from the full run's first rows."""
    for (name, o8), (_, o4) in zip(full, half):
        for a, b in zip(o8, o4):
            if a is None or b is None:
                continue
            if a.shape != b.shape and a.dim() == b.dim() \
                    and a.shape[0] == 2 * b.shape[0]:
                a = a[: b.shape[0]]
            if a.shape == b.shape and not bool((a == b).all()):
                return dict(function=name, shape=list(b.shape),
                            max_abs=float((a.float() - b.float()).abs().max()))
    return {}


def probe(dev, log) -> list:
    import torch

    from repro_torch.dist.sharding import StandInMesh, axis_rules
    from repro_torch.ft.heads import ft_logits_decode
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.tree import tree_map

    results = []
    for arch, scopes in PATHS:
        cfg, model, params = cs.init_model(dev, arch)

        def groups(n):  # deepseek's full rows as 2 dispatch groups
            return (axis_rules(StandInMesh({"data": 2}))
                    if cfg.moe and n == ROWS else contextlib.nullcontext())

        gen = torch.Generator(device=dev).manual_seed(5)
        tokens = torch.randint(0, cfg.vocab_size, (ROWS, 8), generator=gen,
                               device=dev)
        lengths = torch.tensor([8, 5, 8, 3, 8, 8, 6, 8], device=dev)
        for scope in scopes:
            with groups(ROWS):
                eng = ServeEngine(cfg, cs._mesh_scfg(scope), params,
                                  device=dev)
                cs._wave_submit(eng, cfg)
                eng.step()
                eng.step()
            ftx = eng._model_ft(None)
            ftx = ftx.with_plans(None) if ftx is not None else None
            tok = torch.as_tensor(eng.last_tok[:, None], device=dev)
            pos = torch.as_tensor(eng.pos, device=dev)
            runs = {}
            for n in (ROWS, HALF):
                log.clear()
                cache = tree_map(lambda t: t[:, :n].clone(), eng.cache)
                with torch.no_grad(), groups(n):
                    h, _ = model.decode_hidden(eng.ft_params, tok[:n], cache,
                                               pos[:n], cfg, ft=ftx)
                    logits = eng._head_logits(
                        h, torch.ones(n, dtype=torch.bool, device=dev), None,
                        ft_logits_decode)
                decode = (list(log), h, logits)
                log.clear()
                cache = model.init_cache(cfg, n, cs.SERVE["max_seq"],
                                         device=dev)
                with torch.no_grad(), groups(n):
                    hp, _ = model.prefill_chunk(
                        eng.ft_params, tokens[:n], cfg, cache, pos0=0,
                        lengths=lengths[:n], ft=ftx)
                torch.cuda.synchronize()
                runs[n] = (decode, (list(log), hp))
            for i, program in enumerate(("decode", "prefill")):
                full, half = runs[ROWS][i], runs[HALF][i]
                rec = dict(arch=arch, scope=scope, program=program,
                           hidden_equal=bool(torch.equal(full[1][:HALF],
                                                         half[1])),
                           first_difference=_first_difference(full[0],
                                                              half[0]))
                if program == "decode":
                    rec["logits_equal"] = bool(torch.equal(full[2][:HALF],
                                                           half[2]))
                cs.log(f"[row-bits] {json.dumps(rec)}")
                results.append(rec)
            del eng, runs
            cs.free_cuda()
        del params, model
        cs.free_cuda()
    return results


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_row_bits: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.models import attention_core, layers

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = cs.nvidia_smi()
    cs.phase_build([k for k in cs.kernel_table()
                    if k["name"].startswith("entangled_matmul")])
    log: list = []
    saved = [(layers, n, _wrap(layers, n, log)) for n in WRAPPED]
    saved += [(attention_core, n, _wrap(attention_core, n, log))
              for n in ATTENTION]
    try:
        results = probe(dev, log)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    print(json.dumps({"row_bits": results, "device": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
