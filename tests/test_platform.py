"""Behaviour that must not depend on the backend: compile-cache placement,
the device layout choice, fleet error propagation and bookkeeping."""

import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import scipy.sparse as sp

import relp_tpu
from relp_tpu.models.generated import dense_allocation_lp, highs_objective
from relp_tpu.ops.amatrix import EllMatrix, HybridMatrix
from relp_tpu.simplex.driver import (
    _device_matrix,
    solve_general_form,
    solve_general_forms_batched,
)
from relp_tpu.utils.config import SolverConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_COMPILE = (
    "import relp_tpu, jax, jax.numpy as jnp;"
    "jax.jit(lambda x: jnp.sin(x) * 3.0 + 1.0)(jnp.arange(7.0)).block_until_ready();"
    "print(jax.config.jax_compilation_cache_dir)"
)


@pytest.mark.parametrize("env_set", [True, False], ids=["env", "default"])
def test_compile_cache_placement(tmp_path, env_set):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu",
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0")
    if env_set:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cache")
        want = str(tmp_path / "cache")
    else:
        want = relp_tpu.CACHE_DIR
    assert want == os.path.join(ROOT, ".jax_cache") or env_set
    p = subprocess.run([sys.executable, "-c", _COMPILE], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == want
    assert os.path.isdir(want) and os.listdir(want)


def _cf(csc):
    return SimpleNamespace(A=csc, m=csc.shape[0], n=csc.shape[1])


def _sparse(m, n, per_col, seed=0):
    rng = np.random.default_rng(seed)
    rows = np.concatenate([rng.choice(m, per_col, replace=False) for _ in range(n)])
    cols = np.repeat(np.arange(n), per_col)
    return sp.csc_matrix((rng.uniform(0.5, 1.0, len(rows)), (rows, cols)),
                         shape=(m, n))


def _with_full_columns(csc, k):
    d = csc.toarray()
    d[:, :k] = 1.0
    return sp.csc_matrix(d)


@pytest.mark.parametrize(
    "case, fmt, m_pad, make, want",
    [
        ("small", "auto", 216, lambda: _sparse(200, 400, 5), np.ndarray),
        ("sparse", "auto", 1024, lambda: _sparse(1000, 2000, 5), EllMatrix),
        ("filled", "auto", 1024, lambda: _sparse(1000, 300, 200), np.ndarray),
        ("full-columns", "auto", 1024,
         lambda: _with_full_columns(_sparse(1000, 2000, 5), 3), np.ndarray),
        ("full-columns", "ell", 1024,
         lambda: _with_full_columns(_sparse(1000, 2000, 5), 3), HybridMatrix),
    ],
)
def test_layout_by_size_and_fill(case, fmt, m_pad, make, want):
    """One rule on every backend: ELL from 1024 padded rows when the
    fullest column fits 1/8 of them; a few full columns spill an ELL
    request into the hybrid layout."""
    csc = make()
    n_pad = ((csc.shape[1] + 255) // 256) * 256
    A = _device_matrix(_cf(csc), m_pad, n_pad, SolverConfig(matrix_format=fmt))
    assert isinstance(A, want), (case, type(A))


def _dense_fleet(n=3):
    return [dense_allocation_lp(16, 32, scenario=s) for s in range(n)]


def test_fleet_ipm_propagates_device_error(monkeypatch):
    import relp_tpu.simplex.primal_dual as pd

    def broken(*args, **kwargs):
        raise RuntimeError("device program failed")

    monkeypatch.setattr(pd, "ipm_chunk", broken)
    with pytest.raises(RuntimeError, match="device program failed"):
        solve_general_forms_batched(
            _dense_fleet(), SolverConfig(algorithm="ipm", presolve=False)
        )


def test_fleet_marks_host_lanes():
    cfg = SolverConfig(algorithm="ipm", presolve=False, ipm_accept=0.0,
                       ipm_max_iter=2)
    results = solve_general_forms_batched(_dense_fleet(), cfg)
    assert all(r.simplex.host_fallback for r in results)
    results = solve_general_forms_batched(
        _dense_fleet(), SolverConfig(algorithm="ipm", presolve=False)
    )
    assert not any(r.simplex.host_fallback for r in results)


def test_ipm_fleet_sharded_over_batch_matches():
    """The batch-sharded IPM fleet on four virtual devices agrees with the
    one-device fleet and with HiGHS."""
    import jax

    from relp_tpu.parallel.mesh import make_solver_mesh

    mesh = make_solver_mesh(batch=4, cols=1, devices=jax.devices()[:4])
    cfg = SolverConfig(algorithm="ipm", presolve=False)
    one = solve_general_forms_batched(_dense_fleet(4), cfg)
    sharded = solve_general_forms_batched(_dense_fleet(4), cfg, mesh=mesh)
    for a, b, g in zip(one, sharded, _dense_fleet(4)):
        ref = highs_objective(g)
        assert not b.simplex.host_fallback
        assert abs(a.solution.objective_value - b.solution.objective_value) <= 1e-9 * abs(ref)
        assert abs(b.solution.objective_value - ref) <= 1e-5 * abs(ref)


def test_refactorization_paths_counted():
    res = solve_general_form(dense_allocation_lp(24, 48), SolverConfig())
    met = res.simplex.metrics
    assert met.refactor_polish + met.refactor_newton + met.refactor_gj >= 1
