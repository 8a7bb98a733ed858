"""Build and load the port's CUDA sources: one ``nvcc`` per source into a
shared library with a plain C interface, bound with ``ctypes``.

Each library is named after a hash of its source AND of every file the
source includes with ``#include "..."`` (followed recursively, relative to
the including file), so an edit to a shared header such as
``csrc/codec.cuh`` rebuilds every source that includes it instead of
loading a stale library. Libraries go to ``_build/`` (listed in
``.gitignore``) at first use; nothing is compiled when a module is
imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import time

BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
# --split-compile 0: the device code of a source is optimized on every CPU
# thread, not one (entangled_matmul.cu's 40 kernel instances took 66-96 s
# on one thread)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--split-compile", "0", "-shared", "-Xcompiler", "-fPIC")
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

# loaded libraries by source path (a library is loaded once per process)
_libs: dict = {}


def sources(src: pathlib.Path) -> list:
    """``src`` and every file it includes with quotes, recursively, in the
    order first reached."""
    seen, todo = [], [pathlib.Path(src).resolve()]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for name in _INCLUDE.findall(path.read_text()):
            todo.append((path.parent / name).resolve())
    return seen


def digest(src: pathlib.Path) -> str:
    """Hash of the source and of everything it includes."""
    h = hashlib.sha256()
    for path in sources(src):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    return h.hexdigest()[:16]


def build(src: pathlib.Path, verbose: bool = False) -> tuple:
    """Compile ``src`` into ``_build/lib<stem>_<digest>.so`` if needed.

    Returns ``(path, seconds, compiler_log)``; ``seconds`` is 0 when the
    library was already built. ``verbose`` adds ``-Xptxas -v`` (registers,
    shared memory and spills per kernel) to the log and always compiles.
    """
    src = pathlib.Path(src)
    so = BUILD_DIR / f"lib{src.stem}_{digest(src)}.so"
    if so.exists() and not verbose:
        return so, 0.0, ""
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(
            f"nvcc not found (looked on PATH and at {nvcc}); the CUDA "
            f"kernels need the CUDA toolkit to build")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}) building {src}:\n"
            f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, so)
    return so, secs, res.stdout + res.stderr


def load(src: pathlib.Path, declare) -> ctypes.CDLL:
    """The library of ``src``, built if needed and loaded once;
    ``declare(lib)`` sets the ``argtypes`` / ``restype`` of its functions
    on first load. Every launch calls this, so after the first call it
    touches no file: the cache is keyed on ``src`` as given (the wrappers
    pass one absolute path each), since resolving a path costs a system
    call per component on every launch."""
    lib = _libs.get(src)
    if lib is None:
        so, _, _ = build(src)
        lib = ctypes.CDLL(str(so))
        declare(lib)
        _libs[src] = lib
    return lib
