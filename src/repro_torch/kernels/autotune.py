"""Launch-parameter autotuner of the port's kernel layer (port of
:mod:`repro.kernels.autotune`).

The port's CUDA kernels pick their launch parameters by rule: rows per
block ``bb`` and K splits ``splits`` for both GEMM kernels
(:func:`repro_torch.kernels.entangled_matmul.rule_blocks`), the route for
the convs (:func:`repro_torch.kernels.conv1d.route_for`) and the grid's
``blocks_per_sm`` for the codec passes
(:data:`repro_torch.kernels.entangle.BLOCKS_PER_SM`). Each is a value the
launcher passes at run time, so every candidate is the same kernel binary.
This module sweeps the candidates that the kernel takes once per (op,
shape signature, backend, flags) key and caches the winner:

  * in-process: a plain dict, hit on every later call in the process;
  * on disk: a JSON file (``REPRO_TORCH_AUTOTUNE_CACHE``, default
    ``~/.cache/repro_torch/autotune.json``; the reference's file is never
    shared), so winners survive restarts;
  * shipped: seed caches under ``repro_torch/kernels/pretuned/`` (one JSON
    per backend, ``cuda_sm90.json``, made on an H100 by
    ``ServeEngine.warm_autotune`` on an empty cache), loaded below the
    user file — a cold process whose shapes are covered never sweeps.

Cache file format — one flat JSON object::

    { "<op>|<shape-sig>|<backend>|<flags>": {"bb": 2, "splits": 4},
      "_meta": {"version": 1, ...} }

Keys come from :func:`cache_key`; values are the ``blocks`` dict the
wrapper passes to the kernel (``route`` a string, every other value an
int). The backend name is the key's namespace. A corrupt or wrongly
shaped file degrades to the seed with a warning, and entries of a backend
that is not registered are ignored.

:func:`tune` times each candidate with the backend's timer; the
``cuda_sm90`` backend's is :func:`cuda_graph_ms` (after a warm-up call, a
few calls captured in a CUDA graph, each replay between CUDA events, the
median of several replays: device time, without the host's launch gaps).
A backend without a timer (``plain``, ``reference``: the plain versions
have no launch parameters) is refused, so a CPU tensor is never swept. A
candidate that fails to launch raises: :func:`candidates_for` lists only
what the kernel takes, so a failure is a fault, never a reason to try the
next one.
"""
from __future__ import annotations

import json
import os
import pathlib
import statistics
import tempfile
import warnings
from typing import Any, Callable, Iterable, Optional

__all__ = [
    "AutotuneCache",
    "cache_key",
    "candidates_for",
    "cuda_graph_ms",
    "get_cache",
    "reset_cache",
    "stats",
    "tune",
]

_VERSION = 1
ENV = "REPRO_TORCH_AUTOTUNE_CACHE"

# shipped seed caches (one per backend), lowest precedence
PRETUNED_DIR = pathlib.Path(__file__).resolve().parent / "pretuned"

# candidate values of the grid-side parameters
SPLITS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)
BLOCKS_PER_SM = (1, 2, 4, 8, 16, 32)


def _gemm_candidates(M: int, E: int, Cg: int, K: int, N: int, *,
                     packed: bool, extract: bool, sms: int) -> list:
    """Every (bb, splits) the GEMM kernel of this call takes, from
    :data:`SPLITS` and every bb up to the kernel's limit (no larger than
    the smallest power of two covering Cg), the rule's choice first."""
    from repro_torch.kernels import entangled_matmul as emm

    route = "s8" if packed else "cuda_core"
    rule = emm.rule_blocks(route, M, E, Cg, K, N, extract, sms)
    top = emm.max_rows_per_block(route, M, extract)
    cover = 1
    while cover < Cg:
        cover *= 2
    if route == "s8":
        bbs = range(1, min(top, cover) + 1)
    else:
        bbs = [b for b in (1, 2, 4, 8) if b <= min(top, cover)]
    out = [rule]
    for bb in bbs:
        for splits in sorted(set(SPLITS) | {rule["splits"]}):
            cand = {"bb": bb, "splits": splits}
            if cand == rule:
                continue
            try:
                emm.check_blocks(route, M, E, Cg, K, cand, extract)
            except ValueError:
                continue
            out.append(cand)
    return out


def candidates_for(op: str, *, sms: Optional[int] = None,
                   **dims) -> list:
    """The launch parameters the ``op`` kernel takes at these dims, the
    rule's own choice first (so a tie keeps the rule).

    GEMMs (``entangled_matmul``, ``entangled_matmul_grouped``): dims M,
    E (1 for the dense form), Cg (rows per stream and expert), K, N,
    packed, extract; ``sms`` (default: an H100's 132) sizes the rule's
    split. Convs: both routes. Codec passes: :data:`BLOCKS_PER_SM`.
    """
    from repro_torch.kernels import conv1d as cv
    from repro_torch.kernels import entangle as ent
    from repro_torch.kernels.entangled_matmul import SMS_H100

    if op in ("entangled_matmul", "entangled_matmul_grouped"):
        return _gemm_candidates(
            dims["M"], dims.get("E", 1), dims["Cg"], dims["K"], dims["N"],
            packed=bool(dims["packed"]), extract=bool(dims["extract"]),
            sms=sms or SMS_H100)
    if op in ("entangled_conv1d", "conv1d_causal"):
        rule = cv.route_for(dims["kf"], dims["T"],
                            entangled=op == "entangled_conv1d")
        return [{"route": rule}] + [{"route": r} for r in cv.ROUTES
                                    if r != rule]
    if op in ("entangle", "disentangle", "checksum"):
        rule = ent.BLOCKS_PER_SM
        return [{"blocks_per_sm": rule}] + [
            {"blocks_per_sm": n} for n in BLOCKS_PER_SM if n != rule]
    raise KeyError(f"no candidate table for op {op!r}")


def sig_dims(op: str, shape_sig: tuple, flags: tuple = ()) -> dict:
    """The named dims :func:`candidates_for` takes, from a cache key's
    shape signature and flags (the wrappers' ``_*_flags``): the GEMMs'
    ``(M, B, K, N)`` / ``(M, E, Cg, K, N)``, the convs' ``(..., T, kf)``
    and the codec passes' ``(M, N)``."""
    extract = "fused" in flags or "chainf" in flags
    if op == "entangled_matmul":
        M, B, K, N = shape_sig
        return dict(M=M, E=1, Cg=B, K=K, N=N, packed="packed" in flags,
                    extract=extract)
    if op == "entangled_matmul_grouped":
        M, E, Cg, K, N = shape_sig
        return dict(M=M, E=E, Cg=Cg, K=K, N=N, packed="packed" in flags,
                    extract=extract)
    if op in ("entangled_conv1d", "conv1d_causal"):
        return dict(T=shape_sig[-2], kf=shape_sig[-1])
    if op in ("entangle", "disentangle", "checksum"):
        return {"N": shape_sig[-1]}
    raise KeyError(op)


def cache_key(op: str, shape_sig: tuple, backend: str,
              flags: tuple = ()) -> str:
    sig = "x".join(str(s) for s in shape_sig)
    fl = ",".join(str(f) for f in flags)
    return f"{op}|{sig}|{backend}|{fl}"


def _value(k: str, v):
    """One blocks entry: ``route`` a known route name, any other an int."""
    if k == "route":
        from repro_torch.kernels.conv1d import ROUTES

        if v not in ROUTES:
            raise ValueError(v)
        return v
    if isinstance(v, bool):
        raise TypeError(v)
    return int(v)


class AutotuneCache:
    """Two-level (in-process dict + JSON file) winner cache with counters,
    over the shipped seed caches (``seeds=False`` reads none of them).
    ``reports`` holds each sweep of this process: key -> [(candidate,
    ms), ...]."""

    def __init__(self, path: Optional[str] = None, *, seeds: bool = True):
        self.path = pathlib.Path(path).expanduser() if path else None
        self.seeds = seeds
        self._mem: dict = {}
        self._shipped: dict = {}
        self._loaded = False
        self.hits = 0
        self.sweeps = 0
        self.reports: dict = {}

    @staticmethod
    def _parse_cache_json(text: str, origin: str) -> dict:
        """Parse one cache file defensively: the cache is an optimization,
        so malformed content degrades to the seed or a fresh sweep with a
        warning, and one bad entry never drops the valid ones beside it."""
        try:
            data = json.loads(text)
        except ValueError as e:
            warnings.warn(
                f"autotune cache {origin} is not valid JSON ({e}); "
                f"ignoring it (winners fall back to the pretuned seed "
                f"cache or a fresh sweep)", RuntimeWarning, stacklevel=3)
            return {}
        if not isinstance(data, dict):
            warnings.warn(
                f"autotune cache {origin} must be a JSON object, got "
                f"{type(data).__name__}; ignoring it",
                RuntimeWarning, stacklevel=3)
            return {}
        out, bad = {}, []
        for k, v in data.items():
            if k == "_meta":
                continue
            try:
                out[k] = {kk: _value(kk, vv) for kk, vv in v.items()}
            except (AttributeError, TypeError, ValueError):
                bad.append(k)
        if bad:
            warnings.warn(
                f"autotune cache {origin}: skipped {len(bad)} malformed "
                f"entries (e.g. {bad[0]!r}); remaining winners kept",
                RuntimeWarning, stacklevel=3)
        return out

    @staticmethod
    def _known_namespace(key: str, *, ops_too: bool = False) -> bool:
        """True when the key names a backend registered in this process
        and, with ``ops_too`` (the shipped seeds), an op of the port."""
        from repro_torch.kernels import ops  # ops imports this module

        parts = key.split("|")
        if len(parts) < 3 or parts[2] not in ops.backend_names():
            return False
        return not ops_too or parts[0] in ops.REQUIRED_OPS

    def _load_file(self) -> None:
        if self._loaded:
            return
        self._loaded = True
        if self.path and self.path.exists():
            try:
                text = self.path.read_text()
            except OSError as e:
                warnings.warn(f"autotune cache {self.path} unreadable "
                              f"({e}); ignoring it", RuntimeWarning)
                text = "{}"
            stale = 0
            for k, v in self._parse_cache_json(text, str(self.path)).items():
                if self._known_namespace(k):
                    self._mem.setdefault(k, v)
                else:
                    stale += 1
            if stale:
                warnings.warn(
                    f"autotune cache {self.path}: ignored {stale} entries "
                    f"of backends not registered in this process; those "
                    f"shapes will re-tune", RuntimeWarning)
        # the shipped seeds: consulted after the in-process and file
        # winners, in a dict of their own so that `put` never writes them
        if self.seeds and PRETUNED_DIR.is_dir():
            for f in sorted(PRETUNED_DIR.glob("*.json")):
                try:
                    text = f.read_text()
                except OSError:
                    continue
                stale = 0
                for k, v in self._parse_cache_json(
                        text, f"pretuned/{f.name}").items():
                    if self._known_namespace(k, ops_too=True):
                        self._shipped.setdefault(k, v)
                    else:
                        stale += 1
                if stale:
                    warnings.warn(
                        f"autotune pretuned/{f.name}: dropped {stale} stale "
                        f"entries (op or backend unknown to this build)",
                        RuntimeWarning)

    def peek(self, key: str) -> Optional[dict]:
        """The cached winner of ``key``, or None; counts no hit."""
        self._load_file()
        hit = self._mem.get(key)
        return hit if hit is not None else self._shipped.get(key)

    def get(self, key: str) -> Optional[dict]:
        hit = self.peek(key)
        if hit is not None:
            self.hits += 1
        return hit

    def put(self, key: str, blocks: dict) -> None:
        self._load_file()
        self._mem[key] = dict(blocks)
        if not self.path:
            return
        self.path.parent.mkdir(parents=True, exist_ok=True)
        # re-read and merge before writing, so that processes sharing the
        # file keep each other's winners (ours win on a conflict)
        on_disk: dict = {}
        if self.path.exists():
            try:
                on_disk = self._parse_cache_json(self.path.read_text(),
                                                 str(self.path))
            except OSError:
                on_disk = {}
        payload = {"_meta": {"version": _VERSION}, **on_disk, **self._mem}
        # atomic replace: no process ever reads a torn file
        fd, tmp = tempfile.mkstemp(dir=str(self.path.parent),
                                   prefix=".autotune-")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass


_cache: Optional[AutotuneCache] = None


def default_path() -> str:
    return os.environ.get(ENV, str(pathlib.Path.home() / ".cache" /
                                   "repro_torch" / "autotune.json"))


def get_cache() -> AutotuneCache:
    global _cache
    if _cache is None:
        _cache = AutotuneCache(default_path() or None)
    return _cache


def reset_cache(path: Optional[str] = None) -> AutotuneCache:
    """Swap in a fresh cache (tests, or to point at another file)."""
    global _cache
    _cache = AutotuneCache(path)
    return _cache


def stats(backend: str = "cuda_sm90") -> dict:
    """Cache counters: sweeps = keys tuned in this process, hits = cache
    hits (in-process, the user file or a shipped seed), keys = distinct
    winners usable on ``backend``."""
    c = get_cache()
    c._load_file()
    usable = {k for k in set(c._mem) | set(c._shipped)
              if k.split("|")[2] == backend}
    return {"hits": c.hits, "sweeps": c.sweeps, "keys": len(usable)}


def cuda_graph_ms(thunk: Callable[[], Any], repeats: int = 5,
                  calls: int = 4) -> float:
    """Device ms of one call of ``thunk``: a warm-up call (on a side
    stream, as capture requires), then ``calls`` calls captured in one
    CUDA graph, replayed ``repeats`` times between two CUDA events; the
    median of the replays' means. A replay issues its launches at once, so
    the host's launch gaps are not counted: a candidate is ranked by what
    its kernels (and their split-K scratch fills) take on the card."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("cuda_graph_ms times kernels on a CUDA device; "
                           "none is available")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        thunk()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            thunk()
    graph.replay()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def tune(op: str, shape_sig: tuple, backend: str,
         bench: Callable[[dict], Callable[[], Any]], *,
         candidates: Optional[Iterable[dict]] = None, flags: tuple = (),
         sms: Optional[int] = None, repeats: int = 5,
         cache: Optional[AutotuneCache] = None,
         timer: Optional[Callable] = None) -> dict:
    """The winning launch parameters of ``op`` at ``shape_sig``.

    ``bench(blocks)`` returns a thunk that runs the kernel with those
    launch parameters on representative operands. Sweeps only on a cache
    miss: each candidate (default :func:`candidates_for` of the key's
    :func:`sig_dims` on a card of ``sms`` SMs, the kernel wrappers' way)
    is timed by ``timer(thunk, repeats)`` (default: the
    backend's timer), and the fastest, the first on a tie, is kept in the
    process and in the JSON file; the sweep's times go to
    ``cache.reports[key]``. Raises for a backend without a timer (the
    plain versions have no launch parameters) and on any candidate that
    fails.
    """
    cache = cache or get_cache()
    key = cache_key(op, shape_sig, backend, flags)
    cached = cache.get(key)
    if cached is not None:
        return dict(cached)
    if timer is None:
        from repro_torch.kernels import ops  # ops imports this module

        timer = ops.get_backend(backend).timer
        if timer is None:
            raise ValueError(
                f"blocks='auto' sweeps launch parameters on the card; "
                f"backend {backend!r} (the plain versions, or CPU tensors) "
                f"has none to tune")
    cands = (list(candidates) if candidates is not None
             else candidates_for(op, sms=sms,
                                 **sig_dims(op, shape_sig, flags)))
    if not cands:
        raise ValueError(f"autotune: no candidate for {key}")
    cache.sweeps += 1
    best_t, best = float("inf"), None
    times = cache.reports[key] = []
    for cand in cands:
        t = timer(bench(cand), repeats)
        times.append((dict(cand), t))
        if t < best_t:
            best_t, best = t, cand
    cache.put(key, best)
    return dict(best)
