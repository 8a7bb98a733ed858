"""A rank of tests/test_torch_serve_mesh.py's gloo groups, or one of its
one-process oracles (imports torch and the port only, never JAX):

    python tests/_serve_mesh_worker.py rank RANK WORLD DIR
    python tests/_serve_mesh_worker.py alone N DIR

``rank`` joins the group through the file store ``DIR/store``, reads the
waves to serve from ``DIR/cases.json`` and writes ``DIR/rank<RANK>.json``:
per wave the tokens of every request, a digest of every head projection's
logits row by request, a digest of the engine's host state after every
step (:func:`host_state`), the rank's rows of the slot batch, its
protected-shape census and the plans' misses. ``alone`` serves the same
waves in one process (the oracles): a one-rank engine for N = 1, else
under a stand-in mesh of N ``data`` shards; it writes ``DIR/alone<N>.json``.
Every wave runs on params made from a seed.
"""
import hashlib
import json
import pathlib
import sys

import numpy as np
import torch
import torch.distributed as dist


def host_state(eng, reqs) -> str:
    """A digest of everything the engine decides on the host: slots,
    positions, last tokens, the queue, the in-flight admission batches,
    reservations, recycled slots, metrics, census, call counters and each
    request's status and clock stamps."""
    state = (
        [None if s is None else (s["req"].rid, s["toks"]) for s in eng.slots],
        eng.pos.tolist(), eng.last_tok.tolist(),
        [r.rid for r in eng.queue],
        [([(i, r and r.rid) for i, r in p["reqs"]], p["pos0"],
          p["rowpos"].tolist()) for p in eng._inflight],
        sorted(eng._reserved), list(eng._dirty),
        sorted(eng.metrics.items()),
        sorted((k, sorted(v.items())) for k, v in eng.census.items()
               if k in ("prefill", "decode")),
        eng.decode_calls, eng.prefill_calls, eng.scatter_calls,
        [(r.rid, r.status, r.t_submit, r.t_first, r.t_done) for r in reqs])
    return hashlib.sha1(repr(state).encode()).hexdigest()


def counter_clock():
    """A clock that advances 1 ms a call: every engine of a wave reads the
    same times when it makes the same calls."""
    t = [0.0]

    def clock() -> float:
        t[0] += 1e-3
        return t[0]

    return clock


def build(case: dict):
    """(cfg, ServeConfig, params) of a wave: the arch's smoke config (with
    the case's MoE capacity factor and dispatch), params from seed 0."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model
    from repro_torch.serve import ServeConfig

    cfg = get_smoke_config(case["arch"])
    if cfg.moe is not None and case.get("moe"):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, **case["moe"]))
    params = get_model(cfg).init(torch.Generator().manual_seed(0), cfg,
                                 max_seq=case["scfg"]["max_seq"],
                                 device="cpu")
    scfg = ServeConfig(**case["scfg"], clock=counter_clock())
    return cfg, scfg, params


def requests(case: dict, vocab: int) -> list:
    from repro_torch.serve import Request

    rng = np.random.default_rng(31)
    return [Request(rid=r, max_new=m, deadline_ms=case.get("deadline_ms"),
                    prompt=rng.integers(0, vocab, size=n).astype(np.int32))
            for r, (n, m) in enumerate(zip(case["lengths"],
                                           case["max_new"]))]


def _recording():
    """A ServeEngine that keeps a digest of every head projection's logits
    row of a live request, by request id, in program order."""
    from repro_torch.serve import ServeEngine

    class Recording(ServeEngine):
        _landing = None

        def _land(self, p, failed_group, src, src_rows):
            self._landing = p
            try:
                super()._land(p, failed_group, src, src_rows)
            finally:
                self._landing = None

        def _head_logits(self, h, mask, failed_group, ft_fn):
            logits = super()._head_logits(h, mask, failed_group, ft_fn)
            if self._landing is not None:  # this process's batch rows
                lo = self.lay.span(self.Bp)[0]
                reqs = self._landing["reqs"]
                rows = [reqs[lo + j][1] if lo + j < len(reqs) else None
                        for j in range(logits.shape[0])]
            else:  # this process's slots
                rows = [s and s["req"]
                        for s in self.slots[self.slot_lo:self.slot_hi]]
            for j, req in enumerate(rows):
                if req is not None:
                    self.logits_log.setdefault(str(req.rid), []).append(
                        hashlib.sha1(logits[j].numpy().tobytes()).hexdigest())
            return logits

    return Recording


def serve(case: dict, built=None) -> dict:
    """Serve one wave; returns its tokens, logits digests, step digests,
    the engine's rows of the slot batch, its protected census and its
    plans' misses."""
    cfg, scfg, params = built or build(case)
    eng = _recording()(cfg, scfg, params, device="cpu")
    eng.logits_log = {}
    reqs = requests(case, cfg.vocab_size)
    for r in reqs:
        eng.submit(r)
    states = []
    while not eng.idle():
        eng.step(failed_group=case.get("failed_group"))
        states.append(host_state(eng, reqs))
        assert len(states) < 500, "the wave failed to drain"
    return {"tokens": {str(r.rid): np.asarray(r.out).tolist() for r in reqs},
            "logits": eng.logits_log,
            "states": states,
            "rows": [eng.slot_lo, eng.slot_hi],
            "census": sorted(repr(k) for k in eng.protected_census),
            "misses": None if eng.plans is None else eng.plans.misses}


def alone(n: int, cases: dict) -> dict:
    """Every wave served in this process: with n = 1 by the one-rank
    engine, else under a stand-in mesh of n ``data`` shards."""
    from repro_torch.dist.sharding import StandInMesh, axis_rules

    if n == 1:
        return {name: serve(case) for name, case in cases.items()}
    with axis_rules(StandInMesh({"data": n})):
        return {name: serve(case) for name, case in cases.items()}


def main(argv: list) -> None:
    torch.set_num_threads(1)
    if argv[0] == "alone":
        n, d = int(argv[1]), pathlib.Path(argv[2])
        cases = json.loads((d / "cases.json").read_text())
        (d / f"alone{n}.json").write_text(json.dumps(alone(n, cases)))
        return
    rank, world, d = int(argv[1]), int(argv[2]), pathlib.Path(argv[3])
    dist.init_process_group("gloo", init_method=f"file://{d / 'store'}",
                            rank=rank, world_size=world)
    cases = json.loads((d / "cases.json").read_text())
    out = {name: serve(case) for name, case in cases.items()}
    (d / f"rank{rank}.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
