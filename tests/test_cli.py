"""CLI end-to-end tests (counterpart of the reference's binary pipeline,
src/bin/main.rs)."""

import json
import os
import subprocess
import sys

import pytest

from tests.conftest import reference_problem

ENV = {**os.environ, "JAX_PLATFORMS": "cpu"}


def run_cli(*cli_args):
    return subprocess.run(
        [sys.executable, "-m", "relp_tpu", *cli_args],
        capture_output=True,
        text=True,
        env=ENV,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        timeout=300,
    )


def test_solve_json():
    p = run_cli("--json", "-q", reference_problem("burkardt", "afiro.mps"))
    assert p.returncode == 0, p.stderr
    payload = json.loads(p.stdout.strip().splitlines()[-1])
    assert payload["status"] == "finite_optimum"
    assert payload["objective"] == pytest.approx(-464.753142857, abs=1e-6)


def test_unbounded_exit_code():
    p = run_cli("-q", reference_problem("burkardt", "nazareth.mps"))
    assert p.returncode == 1
    assert "unbounded" in p.stdout


def test_missing_file():
    p = run_cli("/tmp/definitely_not_here.mps")
    assert p.returncode == 2
    assert "error:" in p.stderr


def test_bad_extension():
    p = run_cli(os.path.abspath(__file__).replace(".py", ".py"))
    assert p.returncode == 2


def test_write_mps_roundtrip(tmp_path):
    out = tmp_path / "out.mps"
    p = run_cli("--write-mps", str(out), reference_problem("burkardt", "testprob.mps"))
    assert p.returncode == 0, p.stderr
    p2 = run_cli("--json", "-q", str(out))
    assert p2.returncode == 0, p2.stderr
    payload = json.loads(p2.stdout.strip().splitlines()[-1])
    assert payload["objective"] == pytest.approx(54.0, abs=1e-6)


def test_verify_flag():
    p = run_cli("-q", "--verify", reference_problem("burkardt", "testprob.mps"))
    assert p.returncode == 0, p.stderr
    assert "exact check: OK" in p.stderr
