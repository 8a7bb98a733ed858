"""The port's distribution layer (``repro_torch.dist``, ``launch.mesh``)
against the reference.

  * sharding rules: ``logical_to_spec``, ``_param_spec`` and ``_batch_spec``
    read only ``mesh.shape``, so on a stand-in holding the production
    meshes' shapes ({data: 16, model: 16} and {pod: 2, data: 16, model:
    16}) the port's entries equal the reference's ``PartitionSpec`` for
    every leaf shape of every arch's smoke params; ``spec_to_placements``
    gives the DTensor placements of those entries;
  * ``available_mesh_shape``: the reference's rule (its ``available_mesh``
    run with ``jax.make_mesh`` recording its arguments) for 1, 4, 6, 48,
    256 and 512 devices;
  * one spawn of 4 gloo ranks for the module (tests/_dist_worker.py,
    about 10 s): ``ft_grad_sync`` across the ranks, both codecs, the group
    given as a process group and as the mesh dimension "data" under
    ``axis_rules``, with every failed block, bit-identical on every rank
    and equal bit for bit to an oracle composed of the reference's own
    functions (the ranks' amax maximum, ``_pow2_scale``,
    ``repro.core.entangle.entangle`` per rank, the int32 sum mod 2^32,
    ``disentangle``), and within 1e-3 of the mean (the bound of
    tests/test_pipeline_elastic.py); ``checksum_grad_sync`` the same on
    every rank, within 1e-6 of the float32 sum of the ranks' blocks and
    1e-3 of the mean; ``pipeline_stack`` over 4 stages against the
    reference test's sequential oracle (L=8, D=16, MB=4, N=6, error <
    1e-5); an elastic restore from a (2, 2) data x model mesh onto (4, 1):
    values equal, placements as asked; ``constrain`` on a ``DTensor`` and
    the meshes of ``serve_mesh`` / ``available_mesh`` on the 4 ranks.
"""
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import ARCH_IDS
from repro.configs import get_smoke_config as jsmoke
from repro.core.entangle import disentangle as jdisentangle
from repro.core.entangle import entangle as jentangle
from repro.core.plan import make_plan as jmake_plan
from repro.dist import collectives as jcoll
from repro.dist import params as jparams
from repro.dist import sharding as jsharding
from repro.launch import mesh as jmesh
from repro.models import get_model as jget_model
from repro_torch.dist import params as tparams
from repro_torch.dist import sharding as tsharding
from repro_torch.launch import mesh as tmesh

WORLD = 4
M = 4
FAILED = (None, 0, 1, 2, 3)
# gradient leaves of odd sizes: every block split pads
GRAD_SHAPES = {"a": (33, 17), "b": (1000,), "c": (4, 8, 5)}
MEAN_TOL = 1e-3  # tests/test_pipeline_elastic.py's bound on the mean
CHECKSUM_TOL = 1e-6  # float32 sums of 4 ranks in another order
PIPE = dict(L=8, D=16, MB=4, N=6)
PIPE_TOL = 1e-5
MESHES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16})


class _Stand:
    """A mesh stand-in: the rules read only ``shape``."""

    def __init__(self, shape):
        self.shape = shape


def _fb(fb) -> str:
    return "none" if fb is None else str(fb)


# ----------------------------------------------------------- rules ----

@pytest.fixture(scope="module")
def leaf_shapes():
    """Every distinct leaf shape of every arch's smoke params."""
    shapes = set()
    for arch in ARCH_IDS:
        cfg = jsmoke(arch)
        p = jax.eval_shape(
            lambda k, cfg=cfg: jget_model(cfg).init(k, cfg, 64),
            jax.random.PRNGKey(0))
        shapes |= {tuple(x.shape) for x in jax.tree.leaves(p)}
    return sorted(shapes)


@pytest.mark.parametrize("mesh", MESHES, ids=["data_model", "pod"])
def test_param_and_batch_specs_equal_reference(leaf_shapes, mesh):
    stand = _Stand(mesh)
    for shape in leaf_shapes + [(16,), (32, 7), (512, 3, 2), (2,), ()]:
        assert tparams._param_spec(shape, stand) == tuple(
            jparams._param_spec(shape, stand)), shape
        assert tparams._batch_spec(shape, stand) == tuple(
            jparams._batch_spec(shape, stand)), shape


@pytest.mark.parametrize("mesh", MESHES, ids=["data_model", "pod"])
def test_logical_to_spec_equals_reference(leaf_shapes, mesh):
    """Every rule name (and None) at every position of every leaf shape,
    with and without the shape (the divisibility drop)."""
    stand = _Stand(mesh)
    names = list(jsharding._RULES) + [None, "unknown"]
    assert tsharding._RULES == jsharding._RULES
    n = 0
    for shape in leaf_shapes:
        for k in range(len(names)):
            logical = [names[(k + i) % len(names)] for i in range(len(shape))]
            for shp in (shape, None):
                assert tsharding.logical_to_spec(logical, stand, shp) == \
                    tuple(jsharding.logical_to_spec(logical, stand, shp)), (
                        logical, shp)
                n += 1
    assert n > 500


def test_axis_extent_and_constrain_outside_rules():
    import torch

    x = torch.ones(4, 6)
    assert tsharding.axis_extent("batch") == 1
    assert tsharding.constrain(x, "batch", "embed") is x
    stand = _Stand({"pod": 2, "data": 16, "model": 16})
    with tsharding.axis_rules(stand):
        assert tsharding.axis_extent("batch") == 32
        assert tsharding.axis_extent("heads") == 16
        assert tsharding.axis_extent("seq") == 1
        assert tsharding.constrain(x, "batch", "embed") is x  # a local tensor
    assert tsharding.current_mesh() is None
    assert tsharding.serve_mesh() is None  # one process


def test_spec_to_placements():
    from torch.distributed.tensor import Replicate, Shard

    class _Named:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 16, 16)

    mesh = _Named()
    assert tsharding.spec_to_placements((), mesh) == (Replicate(),) * 3
    assert tsharding.spec_to_placements((("pod", "data"), None, "model"),
                                        mesh) == (Shard(0), Shard(0),
                                                  Shard(2))
    assert tsharding.spec_to_placements((None, "data"), mesh) == (
        Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="twice"):
        tsharding.spec_to_placements(("data", "data"), mesh)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_available_mesh_shape_is_the_reference_rule(monkeypatch, multi_pod):
    monkeypatch.setattr(jmesh.jax, "make_mesh",
                        lambda shape, axes: (tuple(shape), tuple(axes)))
    for n in (1, 4, 6, 48, 256, 512):
        assert tmesh.available_mesh_shape(n, multi_pod=multi_pod) == \
            jmesh.available_mesh(n, multi_pod=multi_pod), n
    assert tmesh.production_mesh_shape(multi_pod=multi_pod) == \
        jmesh.make_production_mesh(multi_pod=multi_pod)


# ------------------------------------------------------ 4 gloo ranks ----

def _inputs():
    rng = np.random.default_rng(0)
    out = {f"g{r}_{n}": rng.standard_normal(s).astype(np.float32)
           * (10.0 ** (r - 2))
           for r in range(WORLD) for n, s in GRAD_SHAPES.items()}
    # the reference test's pipeline inputs
    L, D, MB, N = (PIPE[k] for k in ("L", "D", "MB", "N"))
    out["pipe_W"] = np.asarray(jax.random.normal(
        jax.random.PRNGKey(0), (L, D, D)) * (0.5 / np.sqrt(D)))
    out["pipe_x"] = np.asarray(jax.random.normal(
        jax.random.PRNGKey(1), (N, MB, D)))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the 4 ranks once; returns (inputs, [each rank's outputs])."""
    d = tmp_path_factory.mktemp("dist")
    inp = _inputs()
    np.savez(d / "inputs.npz", **inp)
    repo = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(repo / "src"), OMP_NUM_THREADS="1")
    worker = str(repo / "tests" / "_dist_worker.py")
    procs = [subprocess.Popen([sys.executable, worker, str(r), str(WORLD),
                               str(d)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r][-3000:]}"
    return inp, [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]


def _oracle(inp, name):
    """The reference's functions composed into the cross-replica sync of
    leaf ``name``: max of the ranks' amax, ``_pow2_scale``, ``entangle``
    per rank, the int32 sum mod 2^32, ``disentangle``, the mean."""
    plan = jmake_plan(M, 32)
    blocks = []
    for r in range(WORLD):
        b, n = jcoll._to_blocks(jnp.asarray(inp[f"g{r}_{name}"]).reshape(-1),
                                M)
        blocks.append(b)
    amax = max(jnp.max(jnp.abs(b)) for b in blocks)
    scale = jcoll._pow2_scale(amax, plan.max_output_magnitude, WORLD)
    eps = sum(np.asarray(jentangle(jnp.round(b * scale).astype(jnp.int32),
                                   plan)).astype(np.int64) for b in blocks)
    eps = ((eps + 2**31) % 2**32 - 2**31).astype(np.int32)
    rec = jdisentangle(jnp.asarray(eps), plan)
    out = rec.astype(jnp.float32) / (scale * WORLD)
    return np.asarray(out.reshape(-1)[:n].reshape(GRAD_SHAPES[name]))


def test_ft_grad_sync_across_ranks_matches_reference_oracle(ranks):
    inp, outs = ranks
    for name in GRAD_SHAPES:
        want = _oracle(inp, name)
        mean = np.mean([inp[f"g{r}_{name}"] for r in range(WORLD)], axis=0)
        np.testing.assert_allclose(want, mean, rtol=0, atol=MEAN_TOL)
        for r, out in enumerate(outs):
            for fb in FAILED:
                for how in ("plain", "kernel", "mesh"):
                    got = out[f"ft_{how}_{_fb(fb)}_{name}"]
                    np.testing.assert_array_equal(
                        got, want, err_msg=f"{name} rank {r} {how} "
                                           f"failed={fb}")


def test_checksum_grad_sync_across_ranks(ranks):
    inp, outs = ranks
    for name in GRAD_SHAPES:
        mean = np.mean([inp[f"g{r}_{name}"] for r in range(WORLD)], axis=0)
        total = np.sum([inp[f"g{r}_{name}"] for r in range(WORLD)], axis=0)
        for fb in FAILED:
            key = f"cs_{_fb(fb)}_{name}"
            for r in range(1, WORLD):
                np.testing.assert_array_equal(outs[r][key], outs[0][key])
            got = outs[0][key]
            np.testing.assert_allclose(got * WORLD, total, rtol=0,
                                       atol=CHECKSUM_TOL * max(
                                           1.0, np.abs(total).max()))
            np.testing.assert_allclose(got, mean, rtol=0, atol=MEAN_TOL)


def test_pipeline_stack_matches_sequential(ranks):
    inp, outs = ranks
    Ws = jnp.asarray(inp["pipe_W"])

    def seq(x):  # the reference test's sequential oracle
        for i in range(PIPE["L"]):
            x = jnp.tanh(x @ Ws[i])
        return x

    ref = np.asarray(jax.vmap(seq)(jnp.asarray(inp["pipe_x"])))
    for r, out in enumerate(outs):
        err = float(np.abs(out["pipeline"] - ref).max())
        assert err < PIPE_TOL, (r, err)


def test_constrain_and_meshes_across_ranks(ranks):
    """``constrain`` redistributes a replicated ``DTensor`` on the (2, 2)
    data x model mesh to the rules' placements (batch on data, heads on
    model) and leaves a local tensor alone; ``serve_mesh`` is every rank on
    ``data``, ``available_mesh`` (1, 4) as the rule gives for 4 devices."""
    _, outs = ranks
    for r, out in enumerate(outs):
        assert bool(out["constrain_ok"]), r
        assert bool(out["meshes_ok"]), r


def test_shardings_trees_follow_the_specs():
    """``param_shardings`` / ``batch_shardings`` / ``cache_shardings`` put
    each leaf's spec (the reference's, per the tests above) on the mesh,
    tree for tree."""
    import torch

    stand = _Stand({"data": 4, "model": 16})
    tree = {"w": torch.empty(64, 32, device="meta"),
            "s": [torch.empty(8, device="meta"), torch.empty(6, 5)]}
    for fn, spec in ((lambda t: tparams.param_shardings(None, stand, t),
                      tparams._param_spec),
                     (lambda t: tparams.batch_shardings(stand, t),
                      tparams._batch_spec),
                     (lambda t: tparams.cache_shardings(None, stand, t),
                      tparams._batch_spec)):
        got = fn(tree)
        for leaf, sh in ((tree["w"], got["w"]), (tree["s"][0], got["s"][0]),
                         (tree["s"][1], got["s"][1])):
            assert sh.mesh is stand
            assert sh.spec == spec(tuple(leaf.shape), stand)
    assert tparams.param_shardings(None, stand, tree)["w"].spec == (
        "model", None)
    assert tparams.batch_shardings(stand, tree)["s"][0].spec == ("data",)


def test_elastic_restore_onto_another_mesh(ranks):
    _, outs = ranks
    full = np.arange(64.0, dtype=np.float32).reshape(8, 8)
    for r, out in enumerate(outs):
        assert bool(out["elastic_placements_ok"]), r
        np.testing.assert_array_equal(out["elastic_full"], full)
        np.testing.assert_array_equal(out["elastic_local"],
                                      full[2 * r:2 * r + 2])
        np.testing.assert_array_equal(out["local_mesh"], [WORLD, 1])
