"""Ahead-of-time protection planning (port of :mod:`repro.ft.plans`).

  :func:`compile_plans`   freezes the registry the startup census filled
                          into an immutable :class:`CompiledPlans`; the
                          forward pass then only looks plans up.
  :func:`prepare_params`  quantizes every in-scope protected site's
                          weights ONCE (per layer and per expert, via
                          :func:`~repro_torch.ft.quantize.quantize_weight_stacked`)
                          and installs the int8 copies, packed 4 per int32
                          word: a ``q8`` entry beside each dense site's
                          float master, a ``<key>_q8`` sibling beside each
                          raw array (the MoE expert stacks, the router).
"""
from __future__ import annotations

from typing import Iterable, Mapping, Optional

import torch

from repro_torch.ft.quantize import quantize_weight_stacked
from repro_torch.ft.registry import PlanRegistry, ProtectionPlan

# param-tree key -> scope category, for every protectable projection of
# the ported blocks. Dense sites are dicts holding a float "w"; raw sites
# (MoE expert stacks, the router) are bare arrays.
PROTECTED_WEIGHT_KEYS: dict[str, str] = {
    "wq": "qkv", "wk": "qkv", "wv": "qkv",          # GQA / MQA attention
    "wq_a": "qkv", "wq_b": "qkv", "wkv_a": "qkv",   # MLA low-rank q / kv
    "in_proj": "qkv",                               # Mamba
    "in_x": "qkv", "in_gate": "qkv",                # RG-LRU
    "gate": "mlp", "up": "mlp", "down": "mlp",      # MLP, MoE shared expert
    "router": "mlp",                                # raw [D, E] array
    "wo": "out",                                    # attention / MLA
    "out_proj": "out",                              # Mamba
    "out": "out",                                   # RG-LRU
    "we_gate": "moe", "we_up": "moe", "we_down": "moe",  # raw [E, D, F]
}

# subtrees the serving forward never reads, left as they are (deepseek-v3's
# MTP head is train-only)
_SKIP_SUBTREES = frozenset({"mtp"})


def _is_float_weight(v) -> bool:
    return (isinstance(v, torch.Tensor) and v.dim() >= 2
            and v.is_floating_point())


def prepare_params(params, *, scope: str):
    """Copy of ``params`` with int8 copies ({"w", "scale"}, packed) of
    every protected site in ``scope``'s categories: a ``q8`` entry inside a
    dense site's dict, a ``<key>_q8`` sibling beside a raw array. Stacked
    weights get one scale per leading index (``[repeat]``, or ``[repeat,
    E]`` for the expert stacks). Float masters and all other leaves are
    shared, not copied; the ``mtp`` subtree is shared whole, never
    quantized."""
    from repro_torch.ft.protected import SCOPES  # protected imports us

    cats = SCOPES[scope]

    def walk(node):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                cat = PROTECTED_WEIGHT_KEYS.get(k)
                if k in _SKIP_SUBTREES:
                    out[k] = v
                elif cat not in cats:
                    out[k] = walk(v)
                elif isinstance(v, dict) and _is_float_weight(v.get("w")):
                    out[k] = dict(v, q8=quantize_weight_stacked(
                        v["w"], packed=True))
                elif _is_float_weight(v):
                    out[k] = v
                    out[k + "_q8"] = quantize_weight_stacked(v, packed=True)
                else:
                    out[k] = walk(v)
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(walk(x) for x in node)
        return node

    return walk(params)


class CompiledPlans:
    """Immutable (site, shape) -> :class:`ProtectionPlan` map.

    Lookup misses return ``None`` and are counted in ``misses``; the
    serving engine must keep that at 0 (every shape it runs was in the
    startup census)."""

    def __init__(self, plans: Iterable[ProtectionPlan],
                 chains: Iterable[tuple] = ()):
        self._plans = {(p.site, p.shape): p for p in plans}
        self._chains = frozenset(tuple(c) for c in chains)
        self.misses = 0

    def lookup(self, site: str, shape: tuple) -> Optional[ProtectionPlan]:
        plan = self._plans.get((site, shape))
        if plan is None:
            self.misses += 1
        return plan

    def assert_covers(self, census: Mapping) -> None:
        """Raise if any censused (site, shape) lacks a compiled plan."""
        missing = [k for k in census if k not in self._plans]
        if missing:
            raise AssertionError(
                f"compiled plans miss {len(missing)} censused sites: "
                f"{sorted(missing)[:4]}...")

    @property
    def chains(self) -> frozenset:
        return self._chains

    def __len__(self) -> int:
        return len(self._plans)


def compile_plans(registry: PlanRegistry,
                  census: Optional[Mapping] = None) -> CompiledPlans:
    """Freeze the registry's entries (those in ``census``, if given)."""
    entries = registry.entries()
    if census is not None:
        entries = [e for e in entries if (e.site, e.shape) in census]
    return CompiledPlans(entries, chains=registry.chains())
