"""Params bridge: the reference's params, as numpy, into the port's tensors.

torch cannot reproduce ``jax.random``, so the tests build params with the
JAX package, convert every leaf with ``np.asarray`` on the JAX side, and
hand the nested structure here. The copy is exact (float32 masters, int32
q8 copies) and keeps the structure — dicts, lists and tuples — so both
packages then compute from the same weights.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device="cpu"):
    """Nested dicts / lists / tuples of numpy arrays -> the same structure
    of torch tensors on ``device`` (dtype and values unchanged)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return torch.from_numpy(np.array(tree, copy=True)).to(device)
