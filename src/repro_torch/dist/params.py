"""Sharding assignment for parameter / batch / cache trees (port of
:mod:`repro.dist.params`).

These helpers map each leaf of a tree (anything with a ``shape``: tensors,
meta tensors) to a :class:`~repro_torch.dist.sharding.NamedSharding` on a
mesh. The policy is the reference's, structural (no per-model tables):
tensor-parallel ("model") on the largest divisible weight axis,
data-parallel ("data", plus "pod" when present) on the leading batch axis
of inputs and caches, replicate whatever does not divide.
"""
from __future__ import annotations

import math
from typing import Any

from repro_torch.dist.sharding import NamedSharding, mesh_shape
from repro_torch.tree import tree_map


def _data_axes(shape: dict) -> tuple:
    return tuple(a for a in ("pod", "data") if a in shape)


def _param_spec(shape: tuple, mesh) -> tuple:
    """``model`` on the largest axis that it divides, the trailing one on
    ties (output-feature sharding keeps a matmul's reduction local)."""
    ext = mesh_shape(mesh).get("model", 1)
    if ext > 1 and len(shape) >= 1:
        order = sorted(range(len(shape)), key=lambda i: (shape[i], i),
                       reverse=True)
        for i in order:
            if shape[i] >= ext and shape[i] % ext == 0:
                entries: list = [None] * len(shape)
                entries[i] = "model"
                return tuple(entries)
    return ()


def _batch_spec(shape: tuple, mesh) -> tuple:
    """The leading axis over the data axes when they divide it."""
    ms = mesh_shape(mesh)
    axes = _data_axes(ms)
    ext = math.prod(ms[a] for a in axes) if axes else 1
    if axes and len(shape) >= 1 and shape[0] % ext == 0 and shape[0] >= ext:
        return (axes if len(axes) > 1 else axes[0],)
    return ()


def param_shardings(cfg, mesh, p_specs) -> Any:
    """A tree of shardings matching ``p_specs`` (model / tensor parallel).
    ``cfg`` is kept, as in the reference, for per-arch overrides."""
    del cfg
    return tree_map(lambda s: NamedSharding(
        mesh, _param_spec(tuple(s.shape), mesh)), p_specs)


def batch_shardings(mesh, batch_specs) -> Any:
    """Shard the leading (global-batch) axis over the data axes."""
    return tree_map(lambda s: NamedSharding(
        mesh, _batch_spec(tuple(s.shape), mesh)), batch_specs)


def cache_shardings(cfg, mesh, cache_specs) -> Any:
    """KV / conv / SSM caches: batch-major leaves shard like batches."""
    del cfg
    return batch_shardings(mesh, cache_specs)
