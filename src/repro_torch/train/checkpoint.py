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
  * verified: restore refuses a leaf whose SHA-256 does not match.

The reference's elastic re-sharding on restore (target shardings) needs a
mesh, which the port does not have yet: restore places each leaf on the
device of the matching leaf of ``state_like``.
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

from repro_torch.tree import leaves_with_path, tree_map, unflatten


def _to_host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.asarray(x)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------ save ----

    def save(self, state, step: int, blocking: bool = False) -> None:
        """Snapshot to host memory synchronously, write files async."""
        host = tree_map(_to_host, state)
        self.wait()
        self._thread = threading.Thread(
            target=self._write_guarded, args=(host, int(step)), daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

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
            np.save(tmp / fn, leaf)
            digest = hashlib.sha256((tmp / fn).read_bytes()).hexdigest()
            manifest["leaves"].append(
                {"path": path, "file": fn, "sha256": digest,
                 "shape": list(np.shape(leaf)), "dtype": str(leaf.dtype)})
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

    def restore(self, state_like, step: Optional[int] = None) -> tuple:
        """Load step ``step`` (default: the latest) into the structure of
        ``state_like``, each leaf on the device of its ``state_like`` leaf;
        returns ``(state, step)``. Raises ``IOError`` on a leaf whose hash
        does not match its manifest entry."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        by_path = {e["path"]: e for e in manifest["leaves"]}
        out = []
        for path, like in leaves_with_path(state_like):
            entry = by_path[path]
            raw = (d / entry["file"]).read_bytes()
            if hashlib.sha256(raw).hexdigest() != entry["sha256"]:
                raise IOError(
                    f"checkpoint corruption detected in {entry['file']} "
                    f"(sha mismatch) — refusing to load")
            arr = np.load(d / entry["file"])
            dev = like.device if isinstance(like, torch.Tensor) else "cpu"
            out.append(torch.from_numpy(arr).to(dev))
        return unflatten(state_like, out), step
