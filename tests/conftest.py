"""Test-session setup: dependency gates + per-module JAX cache reclaim.

The image does not ship ``hypothesis`` and installing packages is forbidden,
so the property tests run against :mod:`tests._mini_hypothesis` (a seeded
random sweep with the same decorator surface). When the real package exists
it wins — the shim is only registered on ImportError.
"""
import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))


@pytest.fixture(autouse=True, scope="module")
def _reclaim_jax_caches():
    """Drop JAX's global compiled-executable caches after every module.

    XLA:CPU JIT-compiles each distinct program into fresh executable
    pages, and jax's process-global executable cache (pxla's weakref LRU)
    keeps every one alive — across the full suite the process accumulates
    tens of thousands of mmap regions and SEGFAULTS inside
    ``backend_compile`` when it crosses ``vm.max_map_count`` (65530
    default; observed ~40 min in). Nothing is shared across test modules
    (each builds its own engines/params, and jit closures are per-object
    anyway), so clearing at module teardown bounds the map count at the
    cost of re-compiling a handful of library-level helpers per module.
    """
    yield
    import jax

    jax.clear_caches()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "requires_cuda: needs a CUDA device (the port's hand-"
        "written kernels have no CPU mode); skips without one")


try:  # pragma: no cover - environment-dependent
    import hypothesis  # noqa: F401
except ImportError:
    import _mini_hypothesis

    sys.modules["hypothesis"] = _mini_hypothesis
    sys.modules["hypothesis.strategies"] = _mini_hypothesis.strategies
