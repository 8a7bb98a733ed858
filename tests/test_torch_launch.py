"""The port's serving launcher: its parse-time checks of the admission
flags (the cases of the reference's ``tests/test_launch_validation.py``
whose flags the port has: FT, admission geometry, buckets, arrivals,
deadlines), the same messages and exit code 2, one CPU run with
chunked, token-packed admission under an injected fail-stop at scope all,
and one such run per recurrent family (falcon-mamba-7b, recurrentgemma-2b).
"""
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.launch import serve

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--arch", "llama3.2-1b", "--smoke", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("extra,msg", [
    (["--failed-group", "1"], "requires --ft-mode entangle"),
    (["--ft-mode", "entangle", "--failed-group", "4"], "--ft-M"),
    (["--ft-mode", "entangle", "--failed-group", "7", "--ft-M", "4"],
     "--ft-M"),
    (["--ft-mode", "entangle", "--ft-M", "3"], "divisible"),  # max_batch 4
    (["--ft-mode", "entangle", "--ft-M", "2", "--max-batch", "4"], ">= 3"),
    (["--ft-scope", "everything"], "invalid choice"),
    (["--prefill-chunk", "-3"], "prefill-chunk"),
    (["--token-budget", "-8"], "--token-budget"),
    (["--token-budget", "16"], "requires --prefill-chunk > 0"),
    (["--token-budget", "12", "--prefill-chunk", "8"], "multiple"),
    (["--token-budget", "64", "--prefill-chunk", "8", "--max-batch", "4"],
     "max-batch"),
    (["--prefill-buckets", "8,banana"], "comma-separated"),
    (["--prefill-buckets", "8,512", "--max-seq", "64"], "max-seq"),
    (["--arrival-rate", "-1.5"], "--arrival-rate"),
    (["--deadline-ms", "0"], "--deadline-ms"),
    (["--deadline-ms", "-250"], "--deadline-ms"),
])
def test_bad_args_fail_at_parse_time(capsys, extra, msg):
    with pytest.raises(SystemExit) as e:
        serve.main([*BASE, *extra])
    assert e.value.code == 2, "argparse .error exits with code 2"
    assert msg in capsys.readouterr().err


@pytest.mark.parametrize("extra,bad,msg", [
    (["--arrival-rate", "4.0", "--deadline-ms", "500", "--no-refill"],
     ["--prefill-chunk", "-1"], "prefill-chunk"),
    (["--token-budget", "32", "--prefill-chunk", "8"],
     ["--arrival-rate", "-1"], "arrival-rate"),
    (["--ft-mode", "entangle", "--ft-scope", "moe"],
     ["--prefill-chunk", "-1"], "prefill-chunk"),
])
def test_valid_flags_pass_their_checks(capsys, extra, bad, msg):
    """A valid combination parses cleanly: the parser takes it and dies on
    the NEXT invalid flag, proving its own checks passed."""
    with pytest.raises(SystemExit) as e:
        serve.main([*BASE, *extra, *bad])
    assert e.value.code == 2
    assert msg in capsys.readouterr().err


def test_cli_packed_chunked_admission_rolls_forward():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *BASE,
         "--prefill-chunk", "8", "--token-budget", "16", "--ft-mode",
         "entangle", "--ft-scope", "all", "--failed-group", "1",
         "--max-new", "4"],
        capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "'prefill': {(2, 8):" in res.stdout  # the one packed shape
    lines = [ln for ln in res.stdout.splitlines() if "recovery summary" in ln]
    assert len(lines) == 2
    assert "[scope=head]" in lines[0] and "[scope=all]" in lines[1]
    assert all("EXACT ROLL-FORWARD" in ln for ln in lines)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-2b"])
def test_cli_recurrent_archs_roll_forward(capsys, arch):
    """The recurrent families through ``--arch``: an injected fail-stop at
    scope all rolls forward exactly (scope head, then all)."""
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--ft-mode",
                "entangle", "--ft-scope", "all", "--failed-group", "1",
                "--max-new", "4"])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if "recovery summary" in ln]
    assert len(lines) == 2
    assert "[scope=head]" in lines[0] and "[scope=all]" in lines[1]
    assert all("EXACT ROLL-FORWARD" in ln for ln in lines)
