"""Production mesh construction (port of :mod:`repro.launch.mesh`) over
``torch.distributed.device_mesh``.

Functions, not module-level constants: importing this module never
creates a process group or a mesh. A mesh spans the ranks of the default
process group, one device each (a card per process under NCCL, the CPU
under gloo); the shape arithmetic is the reference's
(:func:`available_mesh_shape`), the mesh itself
:func:`repro_torch.dist.sharding.make_mesh`.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.dist.sharding import make_mesh, world_size


def production_mesh_shape(*, multi_pod: bool = False) -> tuple:
    """Single pod: (16, 16) data x model = 256 devices. Multi-pod: (2, 16,
    16) pod x data x model = 512 devices. Returns ``(shape, axes)``."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False):
    return make_mesh(*production_mesh_shape(multi_pod=multi_pod))


def make_local_mesh():
    """Every rank of the default group on ``data`` (one process: a (1, 1)
    mesh), axes kept compatible with the production mesh."""
    return make_mesh((world_size(), 1), ("data", "model"))


def available_mesh_shape(n: int, *, multi_pod: bool = False) -> tuple:
    """``(shape, axes)`` of the largest mesh constructible from ``n``
    surviving devices: the production meshes from 256 (512 with
    ``multi_pod``), else the model axis kept at most 16 and halved until it
    divides n, the rest folded into data."""
    if multi_pod and n >= 512:
        return production_mesh_shape(multi_pod=True)
    if n >= 256:
        return production_mesh_shape(multi_pod=False)
    model = min(16, n)
    while n % model:
        model //= 2
    return (n // model, model), ("data", "model")


def available_mesh(target_devices: Optional[int] = None, *,
                   multi_pod: bool = False):
    """Elastic helper: after a node loss, the trainer remeshes to the
    surviving ranks and restores the latest checkpoint onto the new mesh
    (``CheckpointManager.restore(..., shardings=...)``)."""
    n = target_devices or world_size()
    return make_mesh(*available_mesh_shape(n, multi_pod=multi_pod))
