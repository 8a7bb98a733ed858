"""One rank of tests/test_torch_dist.py's gloo group (imports torch and the
port only, never JAX):

    python tests/_dist_worker.py RANK WORLD DIR

It joins the group through the file store ``DIR/store``, reads the
module's inputs from ``DIR/inputs.npz`` and writes what it computed to
``DIR/rank<RANK>.npz``: the cross-replica ``ft_grad_sync`` (both codecs,
the group given as a process group and as a mesh dimension's name under
``axis_rules``) and ``checksum_grad_sync`` for every failed block, the
4-stage ``pipeline_stack``, an elastic checkpoint restore from a (2, 2)
data x model mesh onto (4, 1), ``constrain`` of a ``DTensor`` under
``axis_rules`` and the meshes of ``serve_mesh`` and ``available_mesh``.
"""
import pathlib
import sys

import numpy as np
import torch
import torch.distributed as dist

FAILED = (None, 0, 1, 2, 3)


def _fb(fb) -> str:
    return "none" if fb is None else str(fb)


def main(rank: int, world: int, d: pathlib.Path) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d / 'store'}",
                            rank=rank, world_size=world)
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (Replicate, Shard, DTensor,
                                          distribute_tensor)

    from repro_torch.dist.collectives import checksum_grad_sync, ft_grad_sync
    from repro_torch.dist.pipeline import (make_layer_stage, pipeline_stack,
                                           split_stages)
    from repro_torch.dist.sharding import (NamedSharding, axis_rules,
                                           constrain, serve_mesh)
    from repro_torch.launch.mesh import available_mesh, make_local_mesh
    from repro_torch.train.checkpoint import CheckpointManager

    inp = np.load(d / "inputs.npz")
    names = [k[len("g0_"):] for k in inp.files if k.startswith("g0_")]
    grads = {n: torch.from_numpy(inp[f"g{rank}_{n}"]) for n in names}
    out = {}
    local = make_local_mesh()
    out["local_mesh"] = np.array(local.shape)
    for fb in FAILED:
        for codec in ("plain", "kernel"):
            got, diag = ft_grad_sync(grads, axis_name=dist.group.WORLD,
                                     n_replicas=world, M=4, failed_block=fb,
                                     codec=codec)
            assert diag["ne_failed"] == (-1 if fb is None else fb)
            for n in names:
                out[f"ft_{codec}_{_fb(fb)}_{n}"] = got[n].numpy()
        with axis_rules(local):
            got, _ = ft_grad_sync(grads, axis_name="data", n_replicas=world,
                                  M=4, failed_block=fb)
        for n in names:
            out[f"ft_mesh_{_fb(fb)}_{n}"] = got[n].numpy()
        got, diag = checksum_grad_sync(grads, axis_name=dist.group.WORLD,
                                       n_replicas=world, M=4,
                                       failed_block=fb)
        for n in names:
            out[f"cs_{_fb(fb)}_{n}"] = got[n].numpy()
    for n in names:  # the reduces never write into the caller's gradients
        assert np.array_equal(grads[n].numpy(), inp[f"g{rank}_{n}"])

    Ws = torch.from_numpy(inp["pipe_W"])
    res = pipeline_stack(
        make_layer_stage(lambda W, x: torch.tanh(x @ W)),
        split_stages(Ws, world), torch.from_numpy(inp["pipe_x"]))
    out["pipeline"] = res.numpy()

    mesh_a = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    sm, am = serve_mesh(), available_mesh()
    out["meshes_ok"] = np.array(
        sm.mesh_dim_names == ("data",) and tuple(sm.shape) == (world,)
        and am.mesh_dim_names == ("data", "model")
        and tuple(am.shape) == (1, world))
    x = distribute_tensor(torch.arange(48.0).reshape(4, 12), mesh_a,
                          [Replicate(), Replicate()])
    with axis_rules(mesh_a):
        y = constrain(x, "batch", "heads")
        z = constrain(torch.ones(3), "batch")
    out["constrain_ok"] = np.array(
        tuple(y.placements) == (Shard(0), Shard(1))
        and torch.equal(y.full_tensor(), x.full_tensor())
        and not isinstance(z, DTensor))
    w = distribute_tensor(torch.arange(64.0).reshape(8, 8), mesh_a,
                          [Shard(0), Shard(1)])
    mgr = CheckpointManager(str(d / "ckpt"))
    mgr.save({"w": w}, 1, blocking=True)
    mesh_b = init_device_mesh("cpu", (4, 1), mesh_dim_names=("data", "model"))
    sh_b = {"w": NamedSharding(mesh_b, ("data", None))}
    restored, step = mgr.restore({"w": w}, shardings=sh_b)
    r = restored["w"]
    assert step == 1 and isinstance(r, DTensor)
    out["elastic_placements_ok"] = np.array(
        tuple(r.placements) == (Shard(0), Replicate())
        and r.device_mesh is mesh_b)
    out["elastic_local"] = r.to_local().numpy()
    out["elastic_full"] = r.full_tensor().numpy()
    np.savez(d / f"rank{rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), pathlib.Path(sys.argv[3]))
