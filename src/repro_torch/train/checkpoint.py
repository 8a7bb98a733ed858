"""Fault-tolerant checkpointing: atomic, async, hash-verified (port of
:mod:`repro.train.checkpoint`, with the reference's on-disk layout).

  * layout: ``step_%08d/manifest.json`` plus one ``leaf_%05d.npy`` per
    state leaf, numbered in the reference's flattening order; the manifest
    holds each leaf's keystr path, file, SHA-256, shape and dtype — so a
    checkpoint written by either package restores into the other;
  * atomic: written to ``step_N.tmp-<pid>`` then renamed — a crash
    mid-write never corrupts the latest checkpoint;
  * async: the device->host copy happens on the caller's thread, the file
    I/O on a background thread; ``wait`` re-raises a failed write;
  * verified: restore refuses a leaf whose SHA-256 does not match;
  * elastic: ``restore(..., shardings=...)`` places each leaf on a target
    ``DeviceMesh`` as a ``DTensor``: a checkpoint written on one mesh
    restores onto another (or onto one device without shardings).

bfloat16 leaves (the low-precision AdamW moments) have no numpy dtype.
The reference writes them through ``ml_dtypes`` as 2-byte void ``.npy``
files (header descr ``'<V2'``, manifest dtype ``"bfloat16"``); the port
writes the same bytes — so the same SHA-256 — and reads such a leaf back
by its manifest dtype, through a ``uint16`` view.

Under a process group of several ranks every rank calls ``save`` (a
sharded ``DTensor`` leaf is gathered, a collective every rank joins) and
rank 0 alone copies the state to the host and writes it; a blocking save
ends with a barrier that every rank reaches, rank 0 after its writer has
finished (or failed: it then raises after the barrier, so that no rank is
left waiting), so that every rank can restore it. Every rank restores by
reading the same files.
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.tree import leaves, leaves_with_path, tree_map, unflatten


BF16 = "bfloat16"


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _to_host(x):
    """A host copy of a leaf: a numpy array, or a CPU tensor for
    bfloat16 (which numpy cannot hold); a ``DTensor`` is gathered whole."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    if _is_dtensor(x):
        x = x.full_tensor()
    x = x.detach().to("cpu", copy=True)
    return x if x.dtype == torch.bfloat16 else x.numpy()


def _save_leaf(path: pathlib.Path, leaf) -> tuple:
    """Write one host leaf as ``.npy``; returns its (shape, dtype name). A
    bfloat16 tensor gets the reference's bytes: descr ``'<V2'``, then the
    raw little-endian 2-byte words."""
    if not isinstance(leaf, torch.Tensor):
        np.save(path, leaf)
        return list(np.shape(leaf)), str(leaf.dtype)
    words = leaf.contiguous().view(torch.int16).numpy()
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, {
            "descr": "<V2", "fortran_order": False, "shape": words.shape})
        f.write(words.astype("<i2", copy=False).tobytes())
    return list(leaf.shape), BF16


def _load_leaf(path: pathlib.Path, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _rank0() -> bool:
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------ save ----

    def save(self, state, step: int, blocking: bool = False) -> None:
        """Snapshot to host memory synchronously, write files async (on
        rank 0 of a process group)."""
        if not _rank0():  # a sharded leaf is gathered all the same
            for x in leaves(state):
                if _is_dtensor(x):
                    x.full_tensor()
        else:
            host = tree_map(_to_host, state)
            self.wait()
            self._thread = threading.Thread(
                target=self._write_guarded, args=(host, int(step)),
                daemon=True)
            self._thread.start()
        if blocking:
            try:
                self.wait()
            finally:
                _barrier()

    def wait(self) -> None:
        """Join the writer; re-raise its failure, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    def _write_guarded(self, host_state, step: int) -> None:
        try:
            self._write(host_state, step)
        except BaseException as err:  # handed to wait(), which re-raises
            self._error = err

    def _write(self, host_state, step: int) -> None:
        tmp = self.dir / f"step_{step:08d}.tmp-{os.getpid()}"
        final = self.dir / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "leaves": []}
        for i, (path, leaf) in enumerate(leaves_with_path(host_state)):
            fn = f"leaf_{i:05d}.npy"
            shape, dtype = _save_leaf(tmp / fn, leaf)
            digest = hashlib.sha256((tmp / fn).read_bytes()).hexdigest()
            manifest["leaves"].append(
                {"path": path, "file": fn, "sha256": digest,
                 "shape": shape, "dtype": dtype})
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # --------------------------------------------------------- restore ----

    def all_steps(self) -> list:
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                      if p.is_dir() and ".tmp-" not in p.name)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_like, step: Optional[int] = None,
                shardings=None) -> tuple:
        """Load step ``step`` (default: the latest) into the structure of
        ``state_like``; returns ``(state, step)``. Each leaf goes on the
        device of its ``state_like`` leaf, or, with ``shardings`` (a tree
        of the same structure of
        :class:`~repro_torch.dist.sharding.NamedSharding`, None leaves
        allowed), onto its sharding's mesh as a ``DTensor`` with its
        placements — the elastic path, a collective over the mesh. Raises
        ``IOError`` on a leaf whose hash does not match its manifest
        entry."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        by_path = {e["path"]: e for e in manifest["leaves"]}
        pairs = leaves_with_path(state_like)
        targets = (leaves(shardings) if shardings is not None
                   else [None] * len(pairs))
        out = []
        for (path, like), shd in zip(pairs, targets):
            entry = by_path[path]
            raw = (d / entry["file"]).read_bytes()
            if hashlib.sha256(raw).hexdigest() != entry["sha256"]:
                raise IOError(
                    f"checkpoint corruption detected in {entry['file']} "
                    f"(sha mismatch) — refusing to load")
            t = _load_leaf(d / entry["file"], entry["dtype"])
            if shd is not None:
                from torch.distributed.tensor import distribute_tensor

                out.append(distribute_tensor(
                    t.to(shd.mesh.device_type), shd.mesh, shd.placements))
            else:
                dev = like.device if isinstance(like, torch.Tensor) else "cpu"
                out.append(t.to(dev))
        return unflatten(state_like, out), step
