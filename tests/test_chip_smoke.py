"""chip_smoke.py: refuses to run without a GPU, and every phase's control
flow and checks work when rehearsed on the CPU at tiny sizes."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke as cs
from relp_tpu.models.generated import highs_objective

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, script], capture_output=True, text=True, env=env,
        cwd=cwd, timeout=300,
    )


def test_refuses_cpu():
    p = _run(os.path.join(ROOT, "chip_smoke.py"), ROOT)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
    assert "no GPU" in p.stderr


def test_fails_without_the_solver(tmp_path):
    script = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), script)
    p = _run(str(script), str(tmp_path))
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout


class _InlineReferences:
    """The HiGHS references without the process pool."""

    def __init__(self, workers):
        self._values = {}

    def submit(self, key, general):
        self._values.setdefault(key, highs_objective(general))

    def get(self, key):
        return self._values[key]

    def close(self):
        pass


@pytest.fixture
def tiny_smoke(monkeypatch):
    monkeypatch.setattr(cs, "SIZES", dict(
        main=(60, 180), xl=(90, 270), fleet=(24, 72), dense=(24, 48),
    ))
    monkeypatch.setattr(cs, "FLEET_N", 4)
    monkeypatch.setattr(cs, "References", _InlineReferences)
    monkeypatch.setattr(
        cs, "phase_device",
        lambda: {"platform": "cpu", "kind": "cpu", "count": 1},
    )


@pytest.mark.parametrize("phase", cs.PHASES)
def test_phase_rehearsal(tiny_smoke, capsys, phase):
    assert cs.main(["--phases", phase]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1])["ok"] is True
    lines = [ln for ln in out[:-1] if ln.startswith("[")]
    # the XL-size default-engine run has no answer to check: it only runs
    checked = [ln for ln in lines if not ln.startswith("[xl] default-budget")]
    assert checked and all(ln.rstrip().endswith("OK") or " OK " in ln
                           for ln in checked)
    assert all(" RAN " in ln for ln in lines if ln not in checked)


def test_missed_tolerance_fails(tiny_smoke, capsys, monkeypatch):
    monkeypatch.setattr(cs, "VERTEX_TOL", -1.0)
    assert cs.main(["--phases", "ipm"]) == 1
    assert '"ok"' not in capsys.readouterr().out


def test_multi_gpu_rehearsal(tiny_smoke, capsys):
    """The four-card paths on four virtual CPU devices: column-sharded
    pricing and the batch-sharded IPM fleet, each beside device 0."""
    assert cs.main(["--multi-gpu"]) == 0
    out = capsys.readouterr().out
    assert "primal/cols=4" in out and "ipm-fleet/batch=4" in out
