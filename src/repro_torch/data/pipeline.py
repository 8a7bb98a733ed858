"""Token-shard storage protected by numerical entanglement (port of
:mod:`repro.data.pipeline`).

The paper notes that inputs "can also be left in their native state
(stored in memory)" under op = identity: entanglement doubles as an
erasure code for data at rest with no extra streams. The store writes each
token-shard group as M entangled files plus a manifest; ANY single missing
or unreadable file of a group is recovered on read by disentanglement.
The files are the reference's (same names, ``.npy`` contents and
manifest), so a store written by either package reads in the other. The
codec is :mod:`repro_torch.core.entangle` on host (CPU) tensors: the data
is on disk, not on a device.
:class:`Prefetcher` keeps a consumer fed from a background thread.
"""
from __future__ import annotations

import json
import pathlib
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.core.entangle import disentangle, entangle
from repro_torch.core.plan import EntanglePlan, make_plan


class TokenShardStore:
    def __init__(self, root: str, M: int = 4, w: int = 32):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.plan = make_plan(M, w)

    def write_group(self, name: str, tokens: np.ndarray) -> list:
        """Write ``tokens`` (any int array) as M entangled shard files and a
        manifest; returns the shard paths."""
        M = self.plan.M
        flat = tokens.reshape(-1).astype(np.int32)
        pad = (-flat.size) % M
        blocks = np.pad(flat, (0, pad)).reshape(M, -1)
        eps = entangle(torch.from_numpy(blocks), self.plan).numpy()
        paths = []
        for m in range(M):
            p = self.root / f"{name}.shard{m}.npy"
            np.save(p, eps[m])
            paths.append(p)
        manifest = {"name": name, "M": M, "w": self.plan.w, "l": self.plan.l,
                    "k": self.plan.k, "orig_size": int(tokens.size),
                    "shape": list(tokens.shape), "pad": int(pad)}
        (self.root / f"{name}.json").write_text(json.dumps(manifest))
        return paths

    def read_group(self, name: str) -> np.ndarray:
        """Read a group back (int32, its written shape), surviving the loss
        of ANY single shard file; two lost shards raise ``IOError``."""
        man = json.loads((self.root / f"{name}.json").read_text())
        M = man["M"]
        shards, missing = [], []
        for m in range(M):
            try:
                shards.append(np.load(self.root / f"{name}.shard{m}.npy"))
            except (FileNotFoundError, ValueError):
                shards.append(None)
                missing.append(m)
        if len(missing) > 1:
            raise IOError(f"group {name}: {len(missing)} shards lost; "
                          f"single-failure code can recover only one")
        proto = next(s for s in shards if s is not None)
        eps = np.stack([s if s is not None else np.zeros_like(proto)
                        for s in shards])
        plan = EntanglePlan(M=M, w=man["w"], l=man["l"], k=man["k"],
                            temp="dualword")
        blocks = disentangle(torch.from_numpy(eps), plan,
                             missing[0] if missing else None).numpy()
        n = int(np.prod(man["shape"]))
        return blocks.reshape(-1)[:n].astype(np.int32).reshape(man["shape"])


class Prefetcher:
    """Background-thread prefetch of an iterator (depth-bounded queue)."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item
