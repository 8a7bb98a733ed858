"""Logical-axis sharding: MaxText-style named-rule annotations (port of
:mod:`repro.dist.sharding` over ``torch.distributed``'s ``DeviceMesh``).

Code annotates tensors with *logical* axis names (``constrain(x, "batch",
"seq", "embed")``); this module maps them to *mesh* dimensions through the
mesh installed by :func:`axis_rules`. Outside any ``axis_rules`` context,
or on a mesh of one device, ``constrain`` is the identity, so the same
code runs unsharded in unit tests and on one card.

Rules (logical -> mesh dimensions), the reference's table:

  batch                    -> ("pod", "data")  (whichever exist in the mesh)
  experts / heads / kv_heads /
  mlp / vocab / embed_model -> ("model",)
  seq / embed / frames / None -> replicated

A mesh-dimension assignment is dropped per tensor when the dimension size
is not divisible by the mesh extent, which keeps every rule total over
every shape.

A *spec* is the reference's ``PartitionSpec`` as a tuple of entries, one
per leading tensor dimension: ``None`` (replicated), a mesh dimension's
name, or a tuple of names (the first the major one); trailing ``None``
entries are trimmed. :func:`spec_to_placements` turns one into the DTensor
placements of a ``DeviceMesh``, and :class:`NamedSharding` pairs the two.
Only ``mesh.shape`` is read by the rules, so a stand-in holding a ``shape``
mapping (a production mesh of 256 devices, in one process) works too.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Optional, Sequence

_STATE = threading.local()

# logical name -> candidate mesh dimensions (in order; all present are used)
_RULES: dict = {
    "batch": ("pod", "data"),
    "experts": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "vocab": ("model",),
    "embed_model": ("model",),
    "seq": (),
    "embed": (),
    "frames": (),
}


def mesh_shape(mesh) -> dict:
    """``{dimension name: size}`` of a ``DeviceMesh`` (its
    ``mesh_dim_names`` and ``shape``) or of a stand-in with a ``shape``
    mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def current_mesh():
    """The mesh installed by the innermost :func:`axis_rules`, or None."""
    return getattr(_STATE, "mesh", None)


@contextlib.contextmanager
def axis_rules(mesh):
    """Install ``mesh`` as the target of logical-axis annotations."""
    prev = current_mesh()
    _STATE.mesh = mesh
    try:
        yield mesh
    finally:
        _STATE.mesh = prev


def _mesh_axes_for(name: Optional[str], shape: dict) -> tuple:
    if name is None:
        return ()
    return tuple(a for a in _RULES.get(name, ()) if a in shape)


def _extent(axes: Sequence[str], shape: dict) -> int:
    return math.prod(shape[a] for a in axes) if axes else 1


def logical_to_spec(logical: Sequence[Optional[str]], mesh,
                    shape: Optional[Sequence[int]] = None) -> tuple:
    """The spec entries for logical axis names, dropping a dimension's mesh
    axes where its size does not divide their extent."""
    ms = mesh_shape(mesh)
    entries: list = []
    for i, name in enumerate(logical):
        axes = _mesh_axes_for(name, ms)
        if shape is not None and axes and shape[i] % _extent(axes, ms):
            axes = ()
        if not axes:
            entries.append(None)
        elif len(axes) == 1:
            entries.append(axes[0])
        else:
            entries.append(tuple(axes))
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def spec_to_placements(spec: Sequence, mesh) -> tuple:
    """DTensor placements on ``mesh`` (a ``DeviceMesh``) for ``spec``: a
    mesh dimension named by entry i shards tensor dimension i, every other
    one replicates; a tuple entry shards one tensor dimension over several
    mesh dimensions, the first the major one, as in the reference."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if not isinstance(out[names.index(axis)], Replicate):
                raise ValueError(f"mesh dimension {axis!r} appears twice in "
                                 f"the spec {spec}")
            out[names.index(axis)] = Shard(dim)
    return tuple(out)


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A spec on a ``DeviceMesh``: where each dimension of a tensor lives
    (the reference's ``jax.sharding.NamedSharding``)."""
    mesh: Any
    spec: tuple = ()

    @property
    def placements(self) -> tuple:
        return spec_to_placements(self.spec, self.mesh)


def constrain(x, *logical: Optional[str]):
    """``x`` laid out as the logical axis names say on the active mesh.

    The identity outside :func:`axis_rules`, on a mesh of one device, and
    on a plain (local) tensor; a ``DTensor`` is redistributed to the
    placements the rules give."""
    mesh = current_mesh()
    if mesh is None or math.prod(mesh_shape(mesh).values()) == 1:
        return x
    if len(logical) != x.dim():
        raise ValueError(f"{len(logical)} logical names for a tensor of "
                         f"shape {tuple(x.shape)}")
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    spec = logical_to_spec(logical, mesh, tuple(x.shape))
    return x.redistribute(mesh, spec_to_placements(spec, mesh))


def world_size() -> int:
    """Ranks of the default process group (1 when there is none)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(shape: tuple, axes: tuple):
    """A ``DeviceMesh`` of ``shape`` over the default group's ranks, its
    dimensions named ``axes``: on the cards under an NCCL group, on the CPU
    under gloo."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def serve_mesh(min_devices: int = 2):
    """Mesh for the batched serving engine: every rank on one ``data``
    dimension, or None with fewer than ``min_devices`` ranks (one process,
    one card: the engine runs unsharded). A rank is one process on one
    device, so the mesh exists only inside a process group of that many
    ranks."""
    n = world_size()
    if n < min_devices:
        return None
    return make_mesh((n,), ("data",))


def axis_extent(name: str) -> int:
    """Number of shards the logical axis ``name`` is split into (1 when no
    rule context is active)."""
    mesh = current_mesh()
    if mesh is None:
        return 1
    ms = mesh_shape(mesh)
    return _extent(_mesh_axes_for(name, ms), ms)


class StandInMesh:
    """A mesh that holds only a ``shape`` mapping (the rules read nothing
    else): the layout of a mesh of several devices whose every shard one
    process computes, as the reference's one-process mesh does."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)

    def __repr__(self) -> str:
        return f"StandInMesh({self.shape})"


def is_device_mesh(mesh) -> bool:
    """True for a ``DeviceMesh`` (one rank, one process, per coordinate),
    False for a stand-in that holds only a ``shape`` mapping."""
    return getattr(mesh, "mesh_dim_names", None) is not None


def local_extent(name: str) -> int:
    """How many of the shards of the logical axis ``name`` a tensor of
    this process holds.

    On a stand-in mesh, one process computes every shard (as the
    reference's one-process mesh of several devices does): the tensor
    holds all :func:`axis_extent` of them. On a ``DeviceMesh`` each rank
    holds its own shard only, so the answer is 1; so it is with no rules
    active."""
    mesh = current_mesh()
    if mesh is None or is_device_mesh(mesh):
        return 1
    return axis_extent(name)


def axis_group(name: str):
    """The process group the logical axis ``name`` is split over: the
    group of its mesh dimension on a ``DeviceMesh`` of more than one rank
    along it, else None (no rules, a stand-in, or an axis not split)."""
    mesh = current_mesh()
    if mesh is None or not is_device_mesh(mesh):
        return None
    ms = mesh_shape(mesh)
    axes = _mesh_axes_for(name, ms)
    if _extent(axes, ms) == 1:
        return None
    if len(axes) != 1:
        raise NotImplementedError(f"axis {name!r} spans the mesh dimensions "
                                  f"{axes}; one is supported")
    return mesh.get_group(axes[0])
