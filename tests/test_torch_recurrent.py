"""The port's recurrent families against the reference, at their smoke
configs: falcon-mamba-7b (Mamba-1) and recurrentgemma-2b (RG-LRU blocks
and rolling-window MQA, window 16), on the reference's params bridged
over.

Blocks: the Mamba, RG-LRU and local-attention mixers run the same call
sequence in both packages on the same bfloat16 inputs: a bucketed prefill
in chunks of 8 at offsets 0, 8, 16 (ragged lengths 20 / 13 / 5 / 24, so
the window of 16 wraps and pad steps occur), decode at per-row positions
up to 29, and a token-packed call with mixed per-row offsets (0 and 16)
over a cache row the engine would have zeroed. The conv tails and the
rolling K/V are copies of bf16 projections and must be bit-identical but
where the projection's float32 sum cancels to a tiny value; the
outputs and the float32 state h within a tolerance: XLA's ``exp`` is its
own polynomial (one float32 ulp apart from torch's on about a tenth of
the inputs), so the scans' states drift by a few float32 ulps and
about one bf16 output in a thousand rounds one ulp apart.

Whole models: ``prefill_chunk``, ``prefill_packed``, ``decode_hidden``
and the whole-prompt ``prefill`` within a tolerance of a few bf16 ulps at
the hidden states' scale (the reference's scanned layer body runs under
XLA's fusion, which keeps some bf16 intermediates in float32, and the
recurrence carries those flips forward), and greedy decoding along the
reference's tokens agrees but at near-ties.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.models import get_model as jget_model
from repro.models import layers as JL
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.registry import PORTED
from repro_torch.models import get_model
from repro_torch.models import layers as TL

ARCHS = ("falcon-mamba-7b", "recurrentgemma-2b")
B, C, T_ALL, MAX_SEQ = 4, 8, 24, 48
LENGTHS = np.array([20, 13, 5, 24], np.int64)
DECODE_STEPS = 6
# a few float32 ulps of a state of magnitude ~2 (see the module docstring)
STATE_TOL = dict(rtol=0.0, atol=2e-6)
# one bf16 ulp at the block outputs' magnitude (< 2)
BLOCK_TOL = dict(rtol=0.0, atol=2.0 ** -7)
# a few bf16 ulps at the final hidden states' magnitude (~4)
HIDDEN_TOL = dict(rtol=0.0, atol=0.125)
NEAR_TIE = 2.0 ** -6  # as in test_torch_serve.py
LOGIT_TOL = 2.0 ** -5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the scans are thousands of tiny ops, which
    thread handoffs only slow down (the more so beside other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _t(a):
    return a.float().numpy()


def _to_torch(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


@functools.lru_cache(maxsize=None)
def _jparams(arch):
    """The reference's smoke params of ``arch``, made once per module."""
    cfg = jget_smoke(arch)
    return jget_model(cfg).init(jax.random.PRNGKey(0), cfg, max_seq=MAX_SEQ)


# ---------------------------------------------------------------- blocks ----

BLOCK_KINDS = ("mamba", "rglru", "local_attn")


def _block(kind):
    """(cfg, reference mixer params, call(pkg, p, x, cache, pos, mode,
    lengths) -> (out, cache), reference cache, port cache)."""
    arch = "falcon-mamba-7b" if kind == "mamba" else "recurrentgemma-2b"
    cfg = jget_smoke(arch)
    jp = _jparams(arch)
    unit = 2 if kind == "local_attn" else 0
    blk = jax.tree.map(lambda t: t[0], jp["stack"][0][unit])
    p = {"mamba": blk, "rglru": blk.get("rec"),
         "local_attn": blk.get("attn")}[kind]
    tcfg = get_smoke_config(arch)

    @functools.partial(jax.jit, static_argnames=("off", "mode"))
    def jcall(p, x, cache, pos, lengths, off, mode):
        pos = off if pos is None else pos
        if kind == "local_attn":
            return JL.apply_attention(
                p, x, cfg=cfg, cache=cache, pos=pos, mode=mode,
                window=cfg.local_window, rope_theta=cfg.rope_theta,
                lengths=lengths)
        fn = JL.apply_mamba if kind == "mamba" else JL.apply_rglru
        return fn(p, x, cfg=cfg, cache=cache, pos=pos, mode=mode,
                  lengths=lengths)

    def call(pkg, p, x, cache, pos, mode, lengths):
        if pkg == "jax":  # an int offset is static, as in the reference
            static = isinstance(pos, int)
            return jcall(p, x, cache, None if static else pos, lengths,
                         pos if static else None, mode)
        if kind == "local_attn":
            return TL.apply_attention(
                p, x, cfg=tcfg, cache=cache, pos=pos, mode=mode,
                window=tcfg.local_window, rope_theta=tcfg.rope_theta,
                lengths=lengths)
        fn = TL.apply_mamba if kind == "mamba" else TL.apply_rglru
        return fn(p, x, cfg=tcfg, cache=cache, pos=pos, mode=mode,
                  lengths=lengths), cache

    if kind == "local_attn":
        jc = JL.init_attn_cache(cfg, B, MAX_SEQ, window=cfg.local_window)
        tc = TL.init_attn_cache(tcfg, 1, B, MAX_SEQ, "cpu",
                                window=tcfg.local_window)
    elif kind == "mamba":
        jc = JL.init_mamba_cache(cfg, B, MAX_SEQ)
        tc = TL.init_mamba_cache(tcfg, 1, B, MAX_SEQ, "cpu")
    else:
        jc = JL.init_rglru_cache(cfg, B, MAX_SEQ)
        tc = TL.init_rglru_cache(tcfg, 1, B, MAX_SEQ, "cpu")
    tc = {k: v[0] for k, v in tc.items()}
    return cfg, p, call, jc, tc


def _assert_copies(got, want, what):
    """Copies of a bf16 projection: bit-identical but where the GEMM's
    float32 sum cancels to far below its terms (|value| < 1e-3; there its
    bf16 rounding follows the summation order, as in
    test_torch_decoders.py), and there within 1e-5."""
    diff = got != want
    assert diff.mean() <= 0.005, (what, int(diff.sum()))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=what)
    assert np.all(np.abs(want[diff]) < 1e-3), what


def _cmp_cache(jc, tc, what):
    for name in jc:
        a, b = _np(jc[name]), _t(tc[name])
        assert a.shape == b.shape, (what, name)
        if name == "h":
            np.testing.assert_allclose(b, a, **STATE_TOL, err_msg=what)
        else:  # conv tail / rolling K, V: copies of bf16 projections
            _assert_copies(b, a, f"{what} {name}")


@pytest.fixture(scope="module", params=BLOCK_KINDS)
def block(request):
    kind = request.param
    cfg, p, call, jc, tc = _block(kind)
    tp = _to_torch(p)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, T_ALL, cfg.d_model)).astype(np.float32)
    xd = rng.standard_normal((DECODE_STEPS, B, 1, cfg.d_model)).astype(
        np.float32)
    steps = []  # (what, reference out, port out, reference / port cache)
    jlen, tlen = jnp.asarray(LENGTHS), torch.from_numpy(LENGTHS)
    for off in range(0, T_ALL, C):
        jx = jnp.asarray(x[:, off:off + C]).astype(jnp.bfloat16)
        tx = torch.from_numpy(x[:, off:off + C]).to(torch.bfloat16)
        jo, jc = call("jax", p, jx, jc, off, "prefill", jlen)
        to, tc = call("torch", tp, tx, tc, off, "prefill", tlen)
        steps.append((f"chunk at {off}", _np(jo), _t(to), jc,
                      {k: v.clone() for k, v in tc.items()}))
        if off == C:  # the state a packed call at offset 16 resumes from
            mid = (jc, {k: v.clone() for k, v in tc.items()})
    pos = LENGTHS.copy()
    for t in range(DECODE_STEPS):
        jo, jc = call("jax", p, jnp.asarray(xd[t]).astype(jnp.bfloat16), jc,
                      jnp.asarray(pos), "decode", None)
        to, tc = call("torch", tp, torch.from_numpy(xd[t]).to(
            torch.bfloat16), tc, torch.from_numpy(pos), "decode", None)
        steps.append((f"decode at {pos.tolist()}", _np(jo), _t(to), jc,
                      {k: v.clone() for k, v in tc.items()}))
        pos += 1
    # token-packed: rows 0, 2, 3 resume at 16, row 1 restarts at 0 on a
    # zeroed cache row (as the engine stages a fresh row)
    offs = np.array([16, 0, 16, 16], np.int64)
    xp = np.stack([x[b, o:o + C] for b, o in enumerate(offs)])
    jc_p = jax.tree.map(lambda a: a.at[1].set(0), mid[0])
    tc_p = {k: v.clone() for k, v in mid[1].items()}
    for v in tc_p.values():
        v[1] = 0
    jo, jc_p = call("jax", p, jnp.asarray(xp).astype(jnp.bfloat16), jc_p,
                    jnp.asarray(offs), "prefill", jlen)
    to, tc_p = call("torch", tp, torch.from_numpy(xp).to(torch.bfloat16),
                    tc_p, torch.from_numpy(offs), "prefill", tlen)
    steps.append(("packed at [16, 0, 16, 16]", _np(jo), _t(to), jc_p,
                  {k: v.clone() for k, v in tc_p.items()}))
    return dict(kind=kind, steps=steps, packed_row1=to[1],
                chunk0_row1=torch.from_numpy(steps[0][2][1]))


@pytest.mark.parametrize("phase", ["prefill", "decode", "packed"])
def test_block_matches_reference(block, phase):
    """Outputs within one bf16 ulp, h within a few float32 ulps, the conv
    tails and rolling K/V bit-identical, after every call of the phase."""
    sel = {"prefill": lambda w: w.startswith("chunk"),
           "decode": lambda w: w.startswith("decode"),
           "packed": lambda w: w.startswith("packed")}[phase]
    n = 0
    for what, jo, to, jc, tc in block["steps"]:
        if not sel(what):
            continue
        np.testing.assert_allclose(to, jo, **BLOCK_TOL,
                                   err_msg=f"{block['kind']} {what}")
        _cmp_cache(jc, tc, f"{block['kind']} {what}")
        n += 1
    assert n


def test_packed_fresh_row_equals_fresh_prefill(block):
    """A packed row at offset 0 reads its zeroed cache row; its output is
    bit-identical to the fresh-state prefill of the same chunk."""
    torch.testing.assert_close(block["packed_row1"].float(),
                               block["chunk0_row1"], rtol=0, atol=0)


def test_window_pieces_match_reference():
    """The rolling buffer's slot positions, the window mask and the
    time-major valid mask equal the reference's bit for bit, the buffer
    wrapped (positions past the window) and not."""
    from repro.models import attention_core as JA
    from repro_torch.models import attention_core as TA

    for window in (0, 5, 16):
        pos = np.array([-1, 0, 3, 4, 5, 15, 16, 17, 40], np.int64)
        S = min(48, window) if window else 48
        np.testing.assert_array_equal(
            TL._cache_abs_pos(S, torch.from_numpy(pos), window).numpy(),
            np.asarray(JL._cache_abs_pos(S, jnp.asarray(pos), window)))
    info = JA.MaskInfo("window", 5, 0, 3)
    want = np.asarray(JA._block_mask(info, jnp.arange(3, 11),
                                     jnp.arange(12)))
    got = TA._mask(TA.MaskInfo("window", 0, 3, 5), 8, 12, "cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    for off in (3, np.array([0, 4, 9, 2])):
        lens = np.array([5, 13, 9, 2])
        for tm in (False, True):
            want = np.asarray(JL._prefill_valid(
                jnp.asarray(off) if np.ndim(off) else off, 6,
                jnp.asarray(lens), time_major=tm))
            got = TL._prefill_valid(
                torch.from_numpy(off) if np.ndim(off) else off, 6,
                torch.from_numpy(lens), time_major=tm)
            np.testing.assert_array_equal(got.numpy(), want)


def test_recurrent_float_pieces():
    """``softplus`` is ``jax.nn.softplus``'s formula (``F.softplus``
    returns its input above 20); ``log_sigmoid`` stays within a float32
    ulp or two of ``jax.nn``'s; the pairwise sum is
    exact on integers and within rounding of ``sum``; the port's own
    ``dt`` bias init is the reference's log(expm1(0.01))."""
    rng = np.random.default_rng(4)
    a = (rng.standard_normal(4096) * 12).astype(np.float32)
    a[:3] = (25.0, -30.0, 0.0)
    ta, ja = torch.from_numpy(a), jnp.asarray(a)
    np.testing.assert_allclose(TL.softplus(ta).numpy(),
                               np.asarray(jax.nn.softplus(ja)), rtol=3e-7,
                               atol=0)
    np.testing.assert_allclose(TL.log_sigmoid(ta).numpy(),
                               np.asarray(jax.nn.log_sigmoid(ja)),
                               rtol=3e-7, atol=1e-12)
    ints = torch.from_numpy(rng.integers(-100, 100, (5, 16)).astype(
        np.float32))
    torch.testing.assert_close(TL._sum_last(ints), ints.sum(-1), rtol=0,
                               atol=0)
    odd = torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32))
    torch.testing.assert_close(TL._sum_last(odd), odd.sum(-1))
    cfg = get_smoke_config("falcon-mamba-7b")
    b = TL.init_mamba(torch.Generator().manual_seed(0), cfg, 1)[
        "dt_proj"]["b"]
    np.testing.assert_array_equal(
        b.numpy(), np.full(b.shape, np.float32(jnp.log(jnp.expm1(
            jnp.float32(0.01))))))


# ------------------------------------------------------------ whole model --

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_reference(arch):
    assert arch in PORTED
    for t, j in ((get_config(arch), jget_config(arch)),
                 (get_smoke_config(arch), jget_smoke(arch))):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert list(t.layer_pattern()) == list(j.layer_pattern())
    full = get_config(arch)
    for n in range(1, full.n_layers + 1):  # a cut depth (--n-layers)
        assert list(dataclasses.replace(full, n_layers=n).layer_pattern()) \
            == list(dataclasses.replace(jget_config(arch),
                                        n_layers=n).layer_pattern())


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """The reference's calls on its own params: chunked prefill, decode
    past the window, a packed call, a whole-prompt prefill, and greedy
    decode of a batch; every result as numpy."""
    arch = request.param
    cfg = jget_smoke(arch)
    jm = jget_model(cfg)
    jp = _jparams(arch)
    prefill_chunk = jax.jit(functools.partial(jm.prefill_chunk, cfg=cfg),
                            static_argnames=("pos0",))
    decode_hidden = jax.jit(functools.partial(jm.decode_hidden, cfg=cfg))
    decode_step = jax.jit(functools.partial(jm.decode_step, cfg=cfg))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, T_ALL)).astype(np.int32)
    nxt = rng.integers(0, cfg.vocab_size, (DECODE_STEPS, B, 1)).astype(
        np.int32)
    out = {"chunks": [], "decode": []}
    cache = jm.init_cache(cfg, B, MAX_SEQ)
    for off in range(0, T_ALL, C):
        h, cache = prefill_chunk(jp, jnp.asarray(toks[:, off:off + C]),
                                 cache=cache, pos0=off,
                                 lengths=jnp.asarray(LENGTHS))
        out["chunks"].append(_np(h))
    pos = LENGTHS.copy()
    for t in range(DECODE_STEPS):
        h, cache = decode_hidden(jp, jnp.asarray(nxt[t]), cache,
                                 jnp.asarray(pos))
        out["decode"].append(_np(h))
        pos += 1
    # packed rows of other offsets over a fresh row cache (all rows at
    # offset 0 read zeros; the offsets are the rows' own)
    offs = np.array([0, 8, 0, 16], np.int64)
    ptoks = np.stack([toks[b, o:o + C] for b, o in enumerate(offs)])
    h, _ = jm.prefill_packed(jp, jnp.asarray(ptoks), cfg,
                             jm.init_cache(cfg, B, MAX_SEQ),
                             pos0=jnp.asarray(offs),
                             lengths=jnp.asarray(LENGTHS))
    out["packed"] = (offs, ptoks, _np(h))
    logits, cache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, cfg,
                               jm.init_cache(cfg, B, MAX_SEQ))
    out["whole"] = np.asarray(logits)
    # greedy decode from the whole prompts, the reference's own tokens
    greedy, glog = [np.asarray(logits).argmax(-1)], []
    for t in range(6):
        lg, cache = decode_step(jp, jnp.asarray(greedy[-1][:, None]),
                                cache, jnp.full((B,), T_ALL + t))
        glog.append(np.asarray(lg))
        greedy.append(glog[-1].argmax(-1))
    out["greedy"] = (np.stack(greedy), np.stack(glog))
    return dict(arch=arch, toks=toks, nxt=nxt, out=out,
                params=_to_torch(jp))


def test_model_prefill_and_decode_hidden(model):
    cfg = get_smoke_config(model["arch"])
    m = get_model(cfg)
    p, out = model["params"], model["out"]
    cache = m.init_cache(cfg, B, MAX_SEQ, device="cpu")
    for i, off in enumerate(range(0, T_ALL, C)):
        h, cache = m.prefill_chunk(
            p, torch.from_numpy(model["toks"][:, off:off + C]).long(), cfg,
            cache, pos0=off, lengths=torch.from_numpy(LENGTHS))
        np.testing.assert_allclose(_t(h), out["chunks"][i], **HIDDEN_TOL,
                                   err_msg=f"chunk at {off}")
    pos = torch.from_numpy(LENGTHS)
    for t in range(DECODE_STEPS):
        h, cache = m.decode_hidden(p, torch.from_numpy(model["nxt"][t])
                                   .long(), cache, pos, cfg)
        np.testing.assert_allclose(_t(h), out["decode"][t], **HIDDEN_TOL,
                                   err_msg=f"decode step {t}")
        pos = pos + 1


def test_model_prefill_packed(model):
    cfg = get_smoke_config(model["arch"])
    m = get_model(cfg)
    offs, ptoks, want = model["out"]["packed"]
    h, _ = m.prefill_packed(model["params"], torch.from_numpy(ptoks).long(),
                            cfg, m.init_cache(cfg, B, MAX_SEQ, device="cpu"),
                            pos0=torch.from_numpy(offs),
                            lengths=torch.from_numpy(LENGTHS))
    np.testing.assert_allclose(_t(h), want, **HIDDEN_TOL)


def test_model_whole_prompt_and_greedy_decode(model):
    """``prefill`` of whole 24-token prompts (the window of 16 wraps in
    the whole-prompt write) and six greedy decode steps along the
    reference's tokens: logits within LOGIT_TOL of the largest |logit|,
    and the port's own argmax differs only at a near-tie in both."""
    cfg = get_smoke_config(model["arch"])
    m = get_model(cfg)
    p = model["params"]
    logits, cache = m.prefill(p, {"tokens": torch.from_numpy(
        model["toks"]).long()}, cfg, m.init_cache(cfg, B, MAX_SEQ,
                                                  device="cpu"))
    want = model["out"]["whole"]
    np.testing.assert_allclose(logits.numpy(), want, rtol=0,
                               atol=LOGIT_TOL * np.abs(want).max())
    toks, jlog = model["out"]["greedy"]
    got = [logits.numpy()]
    for t in range(6):
        lg, cache = m.decode_step(p, torch.from_numpy(toks[t][:, None])
                                  .long(), cache, T_ALL + t, cfg)
        got.append(lg.numpy())
    jall = np.concatenate([want[None], jlog])
    np.testing.assert_allclose(np.stack(got), jall, rtol=0,
                               atol=LOGIT_TOL * np.abs(jall).max())
    for t, (a, b) in enumerate(zip(got, jall)):
        for r in range(B):
            own, ref = int(a[r].argmax()), int(toks[t][r])
            if own != ref:
                gp = (a[r].max() - a[r][ref]) / abs(a[r].max())
                gj = (b[r].max() - b[r][own]) / abs(b[r].max())
                assert gp <= NEAR_TIE and gj <= NEAR_TIE, (t, r, gp, gj)


def test_window_buffer_shorter_than_the_window():
    """With max_seq below the window (the serving geometry: 256 slots for
    a window of 2048) the buffer holds max_seq slots; a bucketed prefill
    with pads and a packed call keep every write inside it and give the
    reference's K/V and outputs (the reference drops the pads' out-of-range
    writes)."""
    cfg, p, call, _, _ = _block("local_attn")
    tcfg = get_smoke_config("recurrentgemma-2b")
    S = 12  # < window 16
    jc = JL.init_attn_cache(cfg, B, S, window=cfg.local_window)
    tc = {k: v[0] for k, v in TL.init_attn_cache(
        tcfg, 1, B, S, "cpu", window=tcfg.local_window).items()}
    tp = _to_torch(p)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, 8, cfg.d_model)).astype(np.float32)
    lens = np.array([3, 8, 5, 1], np.int64)
    for what, pos in (("chunk at 0", 0), ("packed", np.array([0, 4, 2, 0]))):
        tpos = pos if isinstance(pos, int) else torch.from_numpy(pos)
        jpos = pos if isinstance(pos, int) else jnp.asarray(pos)
        jo, jc = call("jax", p, jnp.asarray(x).astype(jnp.bfloat16), jc,
                      jpos, "prefill", jnp.asarray(lens + 4))
        to, tc = call("torch", tp, torch.from_numpy(x).to(torch.bfloat16),
                      tc, tpos, "prefill", torch.from_numpy(lens + 4))
        np.testing.assert_allclose(_t(to), _np(jo), **BLOCK_TOL, err_msg=what)
        _cmp_cache(jc, tc, what)
