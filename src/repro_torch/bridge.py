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

from repro_torch import resolve_device


def params_from_numpy(tree, device=None):
    """Nested dicts / lists / tuples of numpy arrays -> the same structure
    of torch tensors on ``device`` (dtype and values unchanged). Like every
    entry point it runs on CUDA unless ``device`` says otherwise, and
    raises when no GPU is present."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return torch.from_numpy(np.array(node, copy=True)).to(dev)

    return walk(tree)
