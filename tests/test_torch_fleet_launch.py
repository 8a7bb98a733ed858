"""The port's serving launcher with the fleet flags: the parse-time rules
of the reference's fleet cases in ``tests/test_launch_validation.py``
(exit code 2), held against the reference's launcher on the same flags,
and CPU runs of the fleet wave: a replica killed mid-wave, and
autoscaling from one replica, each completing every request.
"""
import os
import subprocess
import sys

import pytest
import torch

import repro.launch.serve as ref_serve
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
    (["--replicas", "0"], "--replicas"),
    (["--kill-replica-at", "5"], "--replicas >= 2"),  # default pool of 1
    (["--replicas", "4", "--kill-replica-at", "20000"], "drain bound"),
    (["--replicas", "4", "--kill-replica-at", "5", "--kill-replica", "7"],
     "initial pool"),
    (["--replicas", "4", "--kill-replica-at", "5", "--kill-replica", "-1"],
     "initial pool"),
    (["--replicas", "2", "--kill-replica", "1"], "--kill-replica-at"),
    (["--replicas", "4", "--max-replicas", "2"], "--max-replicas"),
    (["--scale-up-depth", "0"], "--scale-up-depth"),
])
def test_bad_fleet_args_fail_at_parse_time(capsys, extra, msg):
    with pytest.raises(SystemExit) as e:
        serve.main([*BASE, *extra])
    assert e.value.code == 2, "argparse .error exits with code 2"
    assert msg in capsys.readouterr().err


def test_fleet_flags_accepted_at_parse_time(capsys):
    """A valid fleet configuration (a pool of 4, a kill inside the drain
    bound, autoscaling above the pool) parses cleanly: the parser dies on
    the NEXT invalid flag, so every fleet rule passed."""
    with pytest.raises(SystemExit) as e:
        serve.main([*BASE, "--replicas", "4", "--kill-replica-at", "12",
                    "--kill-replica", "2", "--max-replicas", "6",
                    "--scale-up-depth", "3", "--prefill-chunk", "-1"])
    assert e.value.code == 2
    assert "prefill-chunk" in capsys.readouterr().err


def test_kill_with_autoscaling_pool_of_one_parses(capsys):
    """One replica may be killed when autoscaling can revive the pool."""
    with pytest.raises(SystemExit) as e:
        serve.main([*BASE, "--kill-replica-at", "3", "--max-replicas", "2",
                    "--arrival-rate", "-1"])
    assert e.value.code == 2
    assert "arrival-rate" in capsys.readouterr().err


@pytest.mark.parametrize("flag", [["--blocks", "auto"], ["--ckpt-dir", "x"]])
def test_unported_flags_refused(capsys, flag):
    """No flag is refused as not ported any more: --blocks and --ckpt-dir
    are ported, so with a fleet flag each parses, and the parser dies on
    the next invalid flag."""
    with pytest.raises(SystemExit) as e:
        serve.main([*BASE, *flag, "--replicas", "2", "--arrival-rate",
                    "-1"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "not ported" not in err and "arrival-rate" in err


class _Validated(Exception):
    """Raised in place of building the model: every parse rule passed."""


def _stop(*_a, **_k):
    raise _Validated


def _parse_outcome(module, argv, monkeypatch, capsys):
    """('valid',) when every rule passes, else ('error', exit code, the
    flag that leads the message)."""
    monkeypatch.setattr(module, "get_smoke_config", _stop)
    try:
        if module is ref_serve:
            monkeypatch.setattr(sys, "argv", ["serve", *argv])
            module.main()
        else:
            module.main(argv)
    except _Validated:
        return ("valid",)
    except SystemExit as e:
        msg = capsys.readouterr().err.strip().splitlines()[-1]
        return ("error", e.code, msg.split("error: ", 1)[1].split()[0])
    raise AssertionError("main neither validated nor refused")


@pytest.mark.parametrize("extra", [
    [], ["--replicas", "0"], ["--replicas", "-3"], ["--replicas", "2"],
    ["--kill-replica-at", "5"], ["--kill-replica-at", "0"],
    ["--kill-replica-at", "3", "--max-replicas", "2"],
    ["--kill-replica-at", "3", "--max-replicas", "1"],
    ["--replicas", "4", "--kill-replica-at", "20000"],
    ["--replicas", "4", "--kill-replica-at", "9999", "--kill-replica", "3"],
    ["--replicas", "4", "--kill-replica-at", "10000"],
    ["--replicas", "4", "--kill-replica-at", "5", "--kill-replica", "7"],
    ["--replicas", "4", "--kill-replica-at", "5", "--kill-replica", "4"],
    ["--replicas", "4", "--kill-replica-at", "5", "--kill-replica", "-1"],
    ["--replicas", "2", "--kill-replica", "1"],
    ["--replicas", "4", "--max-replicas", "2"],
    ["--replicas", "2", "--max-replicas", "2"],
    ["--scale-up-depth", "0"], ["--scale-up-depth", "1"],
    ["--replicas", "0", "--scale-up-depth", "0"],
    ["--replicas", "4", "--kill-replica-at", "12", "--kill-replica", "2",
     "--max-replicas", "6", "--scale-up-depth", "3"],
])
def test_fleet_parse_rules_match_reference(monkeypatch, capsys, extra):
    """The same flags meet the same verdict in both launchers: accepted,
    or refused with exit code 2 by a message that leads with the same
    flag."""
    want = _parse_outcome(ref_serve, ["--arch", "llama3.2-1b", "--smoke",
                                      *extra], monkeypatch, capsys)
    got = _parse_outcome(serve, [*BASE, *extra], monkeypatch, capsys)
    assert got == want


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *BASE, *args],
        capture_output=True, text=True, env=env, timeout=300)


def test_cli_fleet_wave_survives_a_replica_kill():
    res = _cli("--replicas", "4", "--kill-replica-at", "6",
               "--kill-replica", "2", "--ft-mode", "entangle",
               "--ft-scope", "all", "--failed-group", "1", "--max-new", "8")
    assert res.returncode == 0, res.stderr
    out = res.stdout
    assert "killing replica 2 at fleet step 6" in out
    assert "fleet: 8/8 requests completed" in out
    assert "2: 'dead'" in out
    summary = [ln for ln in out.splitlines() if "migration summary" in ln]
    assert len(summary) == 1 and "failed=1" in summary[0]
    assert "migrated=0" not in summary[0]


def test_cli_fleet_autoscales_from_one_replica():
    res = _cli("--max-replicas", "2", "--scale-up-depth", "1",
               "--requests", "24", "--max-new", "8")
    assert res.returncode == 0, res.stderr
    assert "fleet: 24/24 requests completed" in res.stdout
    assert "scale_ups=0" not in res.stdout
