"""The port's dry-run and cost tools: ``launch/input_specs.py``,
``launch/dryrun.py``, ``launch/op_cost.py`` and ``launch/roofline.py``.

  * every kind of cell (train, prefill, decode) builds from meta-device
    stand-ins and runs once on the meta device, the counterpart of
    ``test_system.py::test_sharded_aot_compile_smoke`` (the reference
    lowers and compiles on a one-device mesh; the port runs its eager step
    on shapes alone);
  * op_cost: a plain matmul's FLOPs exact; a 1-, 2- and 4-layer smoke
    decoder's counts grow by exactly the same amount per layer (no
    trip-count pass: eager code runs every layer); the kernels counted as
    their own work; collective bytes over a one-rank gloo group;
  * roofline.param_counts equal to the reference's for every arch, as
    exact integers;
  * the smoke llama forward's matmul FLOPs against the reference's
    ``hlo_cost.analyze_text`` of the same program with only its dot and
    convolution FLOPs counted (its elementwise set emptied).
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_smoke_config as jget_smoke
from repro.launch import hlo_cost as jhlo
from repro.launch import roofline as jroofline
from repro.models.api import get_model as jget_model
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.configs.base import ShapeCell
from repro_torch.core.plan import make_plan
from repro_torch.ft import FTContext, PlanRegistry, prepare_params
from repro_torch.launch import dryrun, op_cost, roofline
from repro_torch.launch import input_specs as ispecs
from repro_torch.models.api import get_model


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-v2-lite-16b",
                                  "falcon-mamba-7b", "recurrentgemma-2b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_dryrun_build_smoke(arch, kind):
    cfg = get_smoke_config(arch)
    cell = ShapeCell("t", 32, 2, kind)
    name, mesh = dryrun.mesh_for(False)
    fn, args, groups, _ = dryrun.build(cfg, cell, mesh)
    leaves = [t for t in torch.utils._pytree.tree_flatten(args)[0]
              if isinstance(t, torch.Tensor)]
    assert leaves and all(t.is_meta for t in leaves)
    out, cost = op_cost.count(fn, *args)
    assert cost.flops > 0 and cost.bytes > 0
    if kind == "train":
        state, metrics = out
        assert metrics["loss"].shape == () and state["step"].is_meta
    else:
        logits = out[0]
        assert logits.shape == (2, cfg.vocab_size)
    per = {k: dryrun.per_device_bytes(t, sh) for k, (t, sh) in groups.items()}
    assert set(per) == ({"params", "opt", "batch"} if kind == "train"
                        else {"params", "cache", "batch"})
    assert name == "pod_16x16" and all(v > 0 for v in per.values())


def test_input_specs_vlm_and_encdec_batches():
    """The stub front ends' embeddings ride in the batch, as in the
    reference."""
    cell = ShapeCell("t", 300, 2, "prefill")
    vlm = ispecs.input_specs(get_smoke_config("internvl2-2b"), cell)["batch"]
    P = get_smoke_config("internvl2-2b").vision.n_patches
    assert vlm["patch_embeds"].shape[:2] == (2, P)
    assert vlm["tokens"].shape == (2, 300 - P)
    enc = ispecs.input_specs(get_smoke_config("whisper-small"), cell)["batch"]
    assert enc["frames"].shape[0] == 2 and enc["tokens"].shape == (2, 300)


def test_op_cost_matmul_flops_exact():
    a = torch.empty((256, 128), device="meta")
    b = torch.empty((128, 64), device="meta")
    _, cost = op_cost.count(torch.matmul, a, b)
    assert cost.flops == 2 * 256 * 128 * 64
    assert cost.bytes == 4 * (256 * 128 + 128 * 64 + 256 * 64)


def _decode_cost(layers: int):
    """One smoke llama decode step on the meta device, its sites protected
    at scope all (the kernels counted as their own work)."""
    cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"),
                              n_layers=layers)
    model = get_model(cfg)
    p = prepare_params(ispecs.params_specs(cfg, 64), scope="all")
    ftx = FTContext(registry=PlanRegistry(make_plan(4, 32)), scope="all")
    s = ispecs.input_specs(cfg, ShapeCell("t", 32, 4, "decode"))
    _, cost = op_cost.count(model.decode_hidden, p, s["tok"], s["cache"],
                            s["pos"], cfg, ft=ftx)
    return cost


def test_op_cost_per_layer_counts_exact():
    """Eager code runs every layer, so the 2 -> 4 layer growth is exactly
    twice the 1 -> 2 one, for every count."""
    c1, c2, c4 = (_decode_cost(n) for n in (1, 2, 4))
    for field in ("flops", "bytes", "int_ops", "kernel_bytes", "ops"):
        a, b, d = (getattr(c, field) for c in (c1, c2, c4))
        assert b > a and d - b == 2 * (b - a), field
    # a layer's 7 protected GEMMs (q, k, v, o, gate, up, down), fused
    assert (c2.kernel_calls["entangled_matmul"]
            - c1.kernel_calls["entangled_matmul"]) == 7
    cfg = get_smoke_config("llama3.2-1b")
    D, F = cfg.d_model, cfg.d_ff
    kv = cfg.n_kv_heads * cfg.resolved_head_dim
    qn = cfg.n_heads * cfg.resolved_head_dim
    macs = D * (qn + 2 * kv) + qn * D + 2 * D * F + F * D
    # 4 rows pad to M = 4 streams of 1 row; 3 computed streams, 2 ops a MAC
    assert c2.int_ops - c1.int_ops == 2 * 3 * 1 * macs


def test_op_cost_collectives_one_rank_gloo():
    made = not dist.is_initialized()
    if made:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    try:
        t = torch.ones(1000)
        out = torch.empty(1000)

        def sync():
            dist.all_reduce(t)
            dist.all_reduce(t)
            dist.all_gather_into_tensor(out, t)

        _, cost = op_cost.count(sync)
    finally:
        if made:
            dist.destroy_process_group()
    assert cost.collective_counts == {"allreduce": 2, "_allgather_base": 1}
    assert cost.collective_bytes == 3 * 4000
    assert cost.collective_bytes_by_op["allreduce"] == 8000


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_match_reference(arch):
    got, want = roofline.param_counts(arch), jroofline.param_counts(arch)
    for k in ("total", "embedding", "expert", "nonemb"):
        assert got[k] == want[k] and isinstance(got[k], int), k
    assert got["active"] == want["active"]


def test_forward_matmul_flops_match_hlo_cost(monkeypatch):
    """op_cost's FLOPs of the smoke llama forward (meta device) equal the
    dot FLOPs that the reference's trip-count-aware HLO model counts in
    the compiled program of the same forward, exactly (tolerance 0): both
    count 2 per multiply-add of every matmul and attention product; the
    port runs no GEMM_ROWS padding on the meta device (on the card it
    would add zero rows), and the reference's scanned layers are
    multiplied by their trip count."""
    monkeypatch.setattr(jhlo, "_ELEMENTWISE_FLOP_OPS", set())
    B, T = 2, 32
    jcfg = jget_smoke("llama3.2-1b")
    jm = jget_model(jcfg)
    jp = jax.eval_shape(lambda k: jm.init(k, jcfg, max_seq=64),
                        jax.random.PRNGKey(0))
    batch = {"tokens": jax.ShapeDtypeStruct((B, T), jnp.int32)}
    text = jax.jit(lambda p, b: jm.forward_train(p, b, jcfg)).lower(
        jp, batch).compile().as_text()
    want = jhlo.analyze_text(text)["flops_per_device"]
    cfg = get_smoke_config("llama3.2-1b")
    p = ispecs.params_specs(cfg, 64)
    tok = torch.empty((B, T), dtype=torch.int64, device="meta")
    _, cost = op_cost.count(get_model(cfg).forward_train, p,
                            {"tokens": tok}, cfg)
    assert cost.flops == want
