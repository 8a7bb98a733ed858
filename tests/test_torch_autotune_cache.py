"""The port's autotune cache loader (``repro_torch.kernels.autotune``), the
counterparts of the five tests of ``tests/test_autotune_cache.py``, driven
through a fake timer instead of a card, and two checks of the shipped H100
seed ``kernels/pretuned/cuda_sm90.json``.

The cache is an optimization: a corrupt or partly written
``REPRO_TORCH_AUTOTUNE_CACHE`` file degrades to the shipped seed (or a
fresh sweep) with a warning, never a crash; malformed entries are skipped
one by one; a key missing from both sweeps once and persists; entries of
an unregistered backend are ignored; a user winner shadows the seed's.
"""
import json
import pathlib
import warnings

import pytest

from repro_torch.kernels import autotune, ops
from repro_torch.kernels.entangled_matmul import SMS_H100

SEED = autotune.PRETUNED_DIR / "cuda_sm90.json"
KEY = "entangled_matmul|4x2x2048x2048|cuda_sm90|l8,dualword,fused,packed"


@pytest.fixture
def pretuned_dir(tmp_path, monkeypatch):
    """Point the shipped-seed loader at a controlled directory."""
    d = tmp_path / "pretuned"
    d.mkdir()
    monkeypatch.setattr(autotune, "PRETUNED_DIR", d)
    yield d
    autotune.reset_cache(None)


def _seed(d: pathlib.Path, key: str, blocks: dict):
    (d / "cuda_sm90.json").write_text(json.dumps(
        {"_meta": {"version": 1}, key: blocks}))


def test_corrupt_user_cache_falls_back_to_pretuned(tmp_path, pretuned_dir):
    _seed(pretuned_dir, KEY, {"bb": 2, "splits": 4})
    user = tmp_path / "at.json"
    user.write_text('{"entangled_matmul|4x2x2048x2048|cuda')  # torn write
    cache = autotune.AutotuneCache(str(user))
    with pytest.warns(RuntimeWarning, match="not valid JSON"):
        got = cache.get(KEY)
    assert got == {"bb": 2, "splits": 4}, \
        "a corrupt user cache must fall back to the pretuned seed"
    assert cache.hits == 1


def test_wrong_structure_skips_bad_entries(tmp_path, pretuned_dir):
    _seed(pretuned_dir, KEY, {"bb": 2, "splits": 4})
    user = tmp_path / "at.json"
    user.write_text(json.dumps({
        "good|1x2|cuda_sm90|": {"bb": 1},
        "conv1d_causal|1x1x9x3|cuda_sm90|": {"route": "s8"},
        "bad1": "not-a-dict",
        "bad2": ["nor", "a", "dict"],
        "bad3": {"bb": "NaNish-garbage"},
        "bad4": {"route": "tensor-cores"},
    }))
    cache = autotune.AutotuneCache(str(user))
    with pytest.warns(RuntimeWarning, match="malformed"):
        assert cache.get("good|1x2|cuda_sm90|") == {"bb": 1}
    assert cache.get("conv1d_causal|1x1x9x3|cuda_sm90|") == {"route": "s8"}
    for bad in ("bad1", "bad3", "bad4"):
        assert cache.get(bad) is None
    # the pretuned seed is intact behind the half-bad user cache
    assert cache.get(KEY) == {"bb": 2, "splits": 4}

    top_level_list = tmp_path / "list.json"
    top_level_list.write_text(json.dumps(["not", "an", "object"]))
    cache2 = autotune.AutotuneCache(str(top_level_list))
    with pytest.warns(RuntimeWarning, match="JSON object"):
        assert cache2.get(KEY) == {"bb": 2, "splits": 4}


def test_missing_key_sweeps_and_persists(tmp_path, pretuned_dir):
    """A key in neither cache sweeps once (through the given timer) and
    lands in the user file; the plain backend, which has no timer, is
    refused."""
    user = tmp_path / "at.json"
    cache = autotune.AutotuneCache(str(user))
    ticks = []

    def bench(blocks):
        return lambda: ticks.append(blocks["blocks_per_sm"])

    times = {1: 2.0, 8: 1.0, 32: 3.0}
    won = autotune.tune(
        "entangle", (4, 64), "cuda_sm90", bench,
        candidates=[{"blocks_per_sm": n} for n in times], cache=cache,
        timer=lambda thunk, repeats: (thunk(), times[ticks[-1]])[1])
    assert won == {"blocks_per_sm": 8} and ticks == [1, 8, 32]
    assert cache.sweeps == 1
    key = autotune.cache_key("entangle", (4, 64), "cuda_sm90")
    assert json.loads(user.read_text())[key] == won
    assert [t for _, t in cache.reports[key]] == [2.0, 1.0, 3.0]
    # the second resolve is a pure hit: no sweep, no timing
    assert autotune.tune("entangle", (4, 64), "cuda_sm90", bench,
                         cache=cache) == won
    assert ticks == [1, 8, 32] and cache.sweeps == 1
    with pytest.raises(ValueError, match="on the card"):
        autotune.tune("entangle", (4, 64), "plain", bench, cache=cache)


def test_stale_backend_namespace_ignored(tmp_path, pretuned_dir):
    """Keys of the reference's namespaces or of an unregistered port can
    never match a lookup here: dropped at load with one warning."""
    old_key = "entangled_matmul|4x2x2048x2048|interpret_cpu|l8,dualword"
    user = tmp_path / "at.json"
    user.write_text(json.dumps({
        old_key: {"bb": 8, "bn": 32, "bk": 64},
        "entangled_matmul|4x2x2048x2048|some_unloaded_port|": {"bb": 1},
        KEY: {"bb": 1, "splits": 8},
    }))
    cache = autotune.AutotuneCache(str(user))
    with pytest.warns(RuntimeWarning, match="not registered"):
        assert cache.get(KEY) == {"bb": 1, "splits": 8}
    assert cache.get(old_key) is None
    assert old_key not in cache._mem


def test_user_cache_shadows_pretuned(tmp_path, pretuned_dir):
    _seed(pretuned_dir, KEY, {"bb": 2, "splits": 4})
    user = tmp_path / "at.json"
    user.write_text(json.dumps({KEY: {"bb": 1, "splits": 8}}))
    cache = autotune.AutotuneCache(str(user))
    assert cache.get(KEY) == {"bb": 1, "splits": 8}, \
        "user-tuned winners must take precedence over the shipped seed"


def test_shipped_seed_loads_without_warning(tmp_path):
    meta = json.loads(SEED.read_text())["_meta"]
    assert meta["backend"] == "cuda_sm90" and "H100" in meta["nvidia_smi"]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        cache = autotune.AutotuneCache(str(tmp_path / "none.json"))
        cache.peek(KEY)
    assert cache._shipped and not cache._mem


def test_shipped_seed_entries_are_candidates():
    """Every key of the seed parses (a known op, the cuda_sm90 namespace,
    an integer shape, the GEMMs' packed fused flags), and every winner is
    among candidates_for's list for its shape on an H100."""
    entries = {k: v for k, v in json.loads(SEED.read_text()).items()
               if k != "_meta"}
    assert entries
    for key, blocks in entries.items():
        op, sig, backend, flags = key.split("|")
        assert op in ops.REQUIRED_OPS and backend == "cuda_sm90", key
        shape = tuple(int(d) for d in sig.split("x"))
        flags = tuple(flags.split(","))
        assert "packed" in flags and "fused" in flags, key
        dims = autotune.sig_dims(op, shape, flags)
        assert blocks in autotune.candidates_for(op, sms=SMS_H100, **dims), \
            key
