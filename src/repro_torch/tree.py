"""Nested containers of tensors — the port's pytrees.

Params, gradients, optimizer moments and train states are nested dicts,
lists and tuples with tensor leaves, in the reference's layout. These
helpers walk them in the reference's (``jax.tree_util``) order: dict keys
sorted, sequences in order, so that a leaf's position and its path string
(``keystr``, e.g. ``['params']['stack'][0][0]['mlp']['up']['w']``) are the
reference's, which is what keeps checkpoints interchangeable.
"""
from __future__ import annotations


def tree_map(fn, node, *rest):
    """``fn`` over the tensor leaves of nested dicts / lists / tuples;
    further trees of the same structure give ``fn`` their matching leaves
    as extra arguments."""
    if isinstance(node, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(node))
    return fn(node, *rest)


def leaves_with_path(node, path: str = "") -> list:
    """``[(keystr path, leaf), ...]`` in the reference's flattening order."""
    if isinstance(node, dict):
        return [kv for k in sorted(node)
                for kv in leaves_with_path(node[k], f"{path}[{k!r}]")]
    if isinstance(node, (list, tuple)):
        return [kv for i, v in enumerate(node)
                for kv in leaves_with_path(v, f"{path}[{i}]")]
    return [(path, node)]


def leaves(node) -> list:
    """The leaves in the reference's flattening order."""
    return [leaf for _, leaf in leaves_with_path(node)]


def unflatten(node, new_leaves) -> object:
    """``node``'s structure with ``new_leaves`` (in :func:`leaves` order)."""
    it = iter(new_leaves)

    def walk(n):
        if isinstance(n, dict):
            vals = {k: walk(n[k]) for k in sorted(n)}
            return {k: vals[k] for k in n}
        if isinstance(n, (list, tuple)):
            return type(n)(walk(v) for v in n)
        return next(it)

    out = walk(node)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out
