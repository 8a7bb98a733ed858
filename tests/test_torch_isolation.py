"""The port stands alone: no module of ``src/repro_torch`` and nothing in
``chip_smoke.py`` imports JAX or the JAX package (the machine with the
GPU has no JAX)."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
_BAD = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)(\.|\s))",
                  re.MULTILINE)


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


@pytest.mark.parametrize("order", ["sorted", "reversed"])
def test_importing_every_module_loads_no_jax(order):
    """Every module imports (in either order, which also catches import
    cycles between subpackages) without loading JAX or the reference."""
    mods = list(_modules())
    assert {"repro_torch.serve.engine",
            "repro_torch.kernels.entangled_matmul_grouped",
            "repro_torch.configs.deepseek_v2_lite_16b"} <= set(mods)
    assert len(mods) > 20
    if order == "reversed":
        mods.reverse()
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_source_names_jax_or_the_reference():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if _BAD.search(f.read_text())]
    assert not offenders, offenders
