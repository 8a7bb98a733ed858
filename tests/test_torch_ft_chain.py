"""The rest of the port's ``ft`` library surface against the reference:
``chain_budget`` and ``entangled_chain`` (one entangle, N GEMMs, one
extraction, or a fallback to per-hop extraction when the plan has no
headroom for the chain), ``ProtectedLinear``, the library head
``ft_logits`` (contiguous groups), and ``core.plan.checksum_output_bits``
(Table I's checksum column); and the port's examples (the counterparts
of ``examples/quickstart.py`` and ``examples/train_lm.py``) run to their
end on the CPU at their smallest settings.

Every comparison is exact. The two packages quantize onto the same
integer grids (the same float32 steps in the same order), the entangled
GEMMs agree bit for bit mod 2**32, and the dequantize is the same float32
division, so the float outputs are compared with ``assert_array_equal``
for every failed stream, and each injected run equals the healthy one.
The reference runs its kernels through its plain ``reference`` backend
(``repro.kernels.ref``, which its own tests hold its Pallas kernels to),
and ``ProtectedLinear`` / ``ft_logits`` through their Pallas kernels in
interpret mode; each chain's results are computed once per module.
"""
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.plan import checksum_output_bits as jchecksum_output_bits
from repro.core.plan import make_plan as jmake_plan
from repro.ft import ProtectedLinear as JProtectedLinear
from repro.ft import PlanRegistry as JPlanRegistry
from repro.ft import entangled_chain as jentangled_chain
from repro.ft.heads import ft_logits as jft_logits
from repro.ft.quantize import chain_budget as jchain_budget
from repro.ft.quantize import quantize_weight as jquantize_weight
from repro.ft.quantize import quantize_weight_stacked as jquantize_stacked
from repro_torch.core import checksum_output_bits
from repro_torch.core.plan import make_plan
from repro_torch.ft import (PlanRegistry, ProtectedLinear, chain_budget,
                            entangled_chain, protected_matmul,
                            quantize_weight, quantize_weight_stacked)
from repro_torch.ft.heads import ft_logits

# (M, depths, N of the last hop, packed weights): feasible 2- and 3-hop
# chains, infeasible ones that fall back per hop (one of them a small
# stand-in for llama's 2048 -> 8192 -> 2048 at M = 4), a single hop
CHAINS = [
    (4, (8, 6), 5, False),
    (4, (8, 6), 5, True),
    (8, (4, 3, 2), 3, False),
    (8, (64, 64), 32, True),
    (4, (8, 6, 4), 5, False),
    (4, (64, 256), 64, True),
    (4, (9,), 5, False),
]
ROWS = 7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chain_case(M, depths, n_last, packed):
    """(x, per-hop reference weights, per-hop port weights): float masters,
    or (packed int8, scale) pairs quantized by each package."""
    rng = np.random.default_rng(M * 1000 + sum(depths) + n_last + packed)
    dims = list(depths) + [n_last]
    x = rng.standard_normal((ROWS, depths[0])).astype(np.float32)
    ws = [rng.standard_normal((dims[i], dims[i + 1])).astype(np.float32)
          for i in range(len(depths))]
    if not packed:
        return x, [jnp.asarray(w) for w in ws], [torch.from_numpy(w)
                                                 for w in ws]
    jws = [jquantize_stacked(jnp.asarray(w)[None], packed=True) for w in ws]
    tws = [quantize_weight_stacked(torch.from_numpy(w)[None], packed=True)
           for w in ws]
    return (x, [(q["w"][0], q["scale"][0]) for q in jws],
            [(q["w"][0], q["scale"][0]) for q in tws])


@functools.lru_cache(maxsize=None)
def _reference_chain(case):
    """The reference's chain outputs for ``case``: healthy, then failed
    stream r = 0..M-1."""
    M, depths, n_last, packed = case
    x, jws, _ = _chain_case(*case)
    plan = jmake_plan(M, 32)
    return [np.asarray(jentangled_chain(jnp.asarray(x), jws, plan=plan,
                                        failed_group=r, backend="reference"))
            for r in [None] + list(range(M))]


def test_chain_budget_matches_reference_on_a_grid():
    plans = [(M, w) for M in range(3, 9) for w in (16, 32)
             if not (M > 4 and w == 16)]
    depths = [(1,), (8,), (2048,), (8, 6), (4, 3, 2), (8, 6, 4), (64, 64),
              (2048, 8192), (1, 1, 1, 1), (127, 2), (16, 16, 16)]
    n = 0
    for (M, w), d in itertools.product(plans, depths):
        assert chain_budget(make_plan(M, w), d) == \
            jchain_budget(jmake_plan(M, w), d), (M, w, d)
        n += chain_budget(make_plan(M, w), d) > 0
    assert 0 < n < len(plans) * len(depths)  # both outcomes occur


def test_checksum_output_bits_matches_reference():
    for M, w in itertools.product(range(2, 17), (8, 16, 32)):
        assert checksum_output_bits(M, w) == jchecksum_output_bits(M, w)
    assert checksum_output_bits(3) == 30 and checksum_output_bits(8) == 29


@pytest.mark.parametrize("case", CHAINS, ids=lambda c: f"M{c[0]}-{c[1]}"
                         f"x{c[2]}{'-packed' if c[3] else ''}")
def test_entangled_chain_matches_reference_every_failed_stream(case):
    M, depths, n_last, packed = case
    x, _, tws = _chain_case(*case)
    plan = make_plan(M, 32)
    want = _reference_chain(case)
    feasible = chain_budget(plan, depths) >= 1 and len(depths) > 1
    assert feasible == (case in CHAINS[:4])
    for r, ref in zip([None] + list(range(M)), want):
        got = entangled_chain(torch.from_numpy(x), tws, plan=plan,
                              failed_group=r)
        assert got.dtype == torch.float32 and got.shape == (ROWS, n_last)
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=f"r={r}")
        np.testing.assert_array_equal(ref, want[0], err_msg=f"r={r}")
    if not feasible:  # the fallback is per-hop protected_matmul
        y = torch.from_numpy(x)
        for w in tws:
            y = protected_matmul(y, w, plan=plan)
        np.testing.assert_array_equal(y.numpy(), want[0])


def test_protected_linear_matches_reference():
    """Dense and grouped (per-expert) sites, every failed stream, on
    float weights that each package quantizes; the port's plans come from
    its registry as the reference's do."""
    rng = np.random.default_rng(11)
    M, K, N, E, C = 4, 24, 10, 3, 5
    jplan, plan = jmake_plan(M, 32), make_plan(M, 32)
    jreg, reg = JPlanRegistry(jplan), PlanRegistry(plan)
    x = rng.standard_normal((2, 5, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)
    xg = rng.standard_normal((2, E, C, K)).astype(np.float32)
    wg = rng.standard_normal((E, K, N)).astype(np.float32)
    dense = (JProtectedLinear(jreg.entry("site.d", 10, K, N,
                                         "interpret_cpu")),
             ProtectedLinear(reg.entry("site.d", 10, K, N)))
    grouped = (JProtectedLinear(jreg.entry("site.g", 2 * C, K, N,
                                           "interpret_cpu", groups=E)),
               ProtectedLinear(reg.entry("site.g", 2 * C, K, N, groups=E)))
    assert grouped[1].plan.grouped and not dense[1].plan.grouped
    for (jl, tl), a, b in ((dense, x, w), (grouped, xg, wg)):
        healthy = None
        for r in [None] + list(range(M)):
            want = np.asarray(jl(jnp.asarray(a), jnp.asarray(b),
                                 failed_group=r))
            got = tl(torch.from_numpy(a), torch.from_numpy(b),
                     failed_group=r).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"r={r}")
            healthy = want if healthy is None else healthy
            np.testing.assert_array_equal(got, healthy)
    want = np.asarray(dense[0](jnp.asarray(x), jnp.asarray(w),
                               contiguous=True))
    got = dense[1](torch.from_numpy(x), torch.from_numpy(w), contiguous=True)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fuse_epilogue", [True, False])
def test_ft_logits_matches_reference(fuse_epilogue):
    rng = np.random.default_rng(12)
    B, D, V = 8, 32, 50
    h = rng.standard_normal((B, D)).astype(np.float32)
    head = rng.standard_normal((D, V)).astype(np.float32)
    jq, js = jquantize_weight(jnp.asarray(head))
    tq, ts = quantize_weight(torch.from_numpy(head))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    healthy = None
    for r in [None, 0, 1, 2, 3]:
        want = np.asarray(jft_logits(jnp.asarray(h), jq, js, M=4,
                                     failed_group=r,
                                     fuse_epilogue=fuse_epilogue))
        got = ft_logits(torch.from_numpy(h), tq, ts, M=4, failed_group=r,
                        fuse_epilogue=fuse_epilogue).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"r={r}")
        healthy = got if healthy is None else healthy
        np.testing.assert_array_equal(got, healthy)
    with pytest.raises(ValueError, match="M=4"):
        ft_logits(torch.from_numpy(h[:6]), tq, ts, M=4)


def test_quickstart_example_runs_on_the_cpu(capsys):
    from repro_torch.examples import quickstart

    quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "recovered EXACTLY from 2 streams" in out
    for mode in ("entangle", "checksum", "mr"):
        assert f"{mode:9s}: recovered=True" in out


def test_train_lm_example_runs_on_the_cpu(tmp_path, capsys):
    from repro_torch.examples import train_lm

    losses = train_lm.main(["--small", "--steps", "4", "--seq", "32",
                            "--device", "cpu", "--ckpt-dir",
                            str(tmp_path)])
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert "fail-stop injected at step 2" in capsys.readouterr().out
