"""Refactorization above the Gauss-Jordan size guard.

Above ``_GJ_MAX_M`` the scalar Gauss-Jordan fallback (m sequential sweeps
over the m×2m tableau) is not run: an unhealthy Newton result reports a
singular basis instead, and the engine repairs it.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import relp_tpu.ops.linalg as linalg


def _simplex_like_basis(rng, m):
    """Sparse equilibrated basis like the engine actually refactorizes."""
    B = rng.standard_normal((m, m)) * (rng.random((m, m)) < 0.02)
    return B + np.diag(1.0 + rng.random(m))


@pytest.mark.parametrize("m", [512, 1024, 2048])
def test_newton_refined_inverse_quality(m):
    rng = np.random.default_rng(7)
    B = _simplex_like_basis(rng, m)
    X, resid = linalg.newton_refined_inverse(jnp.asarray(B))
    err = np.max(np.abs(np.eye(m) - B @ np.asarray(X)))
    assert float(resid) < 1e-11 and err < 1e-9, (float(resid), err)


def test_robust_inverse_flags_singular_at_scale(monkeypatch):
    monkeypatch.setattr(linalg, "_GJ_MAX_M", 512)
    rng = np.random.default_rng(5)
    B = _simplex_like_basis(rng, 1024)
    B[:, 3] = B[:, 17]  # exactly dependent columns
    _X, min_piv = linalg.robust_inverse(jnp.asarray(B))
    # no scalar-GJ fallback at scale: singularity must surface as pivot 0
    assert float(min_piv) == 0.0


def test_robust_inverse_healthy_at_scale(monkeypatch):
    monkeypatch.setattr(linalg, "_GJ_MAX_M", 512)
    rng = np.random.default_rng(9)
    B = _simplex_like_basis(rng, 1024)
    X, min_piv = linalg.robust_inverse(jnp.asarray(B))
    assert np.isinf(float(min_piv))
    err = np.max(np.abs(np.eye(1024) - B @ np.asarray(X)))
    assert err < 1e-9


def test_robust_inverse_falls_back_to_gauss_jordan_below_scale():
    rng = np.random.default_rng(5)
    B = _simplex_like_basis(rng, 256)
    B[:, 3] = B[:, 17]
    _X, min_piv = linalg.robust_inverse(jnp.asarray(B))
    assert np.isfinite(float(min_piv)) and float(min_piv) < 1e-6


def test_inverse_residual_probe_path(monkeypatch):
    # above the (patched) threshold the residual uses probe matvecs
    monkeypatch.setattr(linalg, "_EXACT_RESIDUAL_MAX", 1024)
    B = np.random.default_rng(5).standard_normal((64, 64)) + 64 * np.eye(64)
    X = np.linalg.inv(B)
    r = float(linalg.inverse_residual(jnp.asarray(B), jnp.asarray(X)))
    assert r < 1e-12
    r_bad = float(
        linalg.inverse_residual(jnp.asarray(B), jnp.asarray(X * 1.001))
    )
    assert r_bad > 1e-4
