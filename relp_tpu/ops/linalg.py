"""Dense linear-algebra kernels for basis-inverse maintenance.

Counterpart of the reference's basis-inverse backends
(``BasisInverseRows``/``LUDecomposition`` under
``src/algorithm/two_phase/tableau/inverse_maintenance/carry/``).  The
engine maintains an explicit dense inverse updated by rank-1 product-form
pivots (reference product-form update, basis_inverse_rows.rs:20-88) and
*refactorizes* it from the basis columns periodically (generalizing the
reference's refactor-after-10-eta-updates policy, lower_upper/mod.rs:199-202).

The f64 refactorization is an f32 LU inverse seed refined by Newton-Schulz
matmuls, with a Gauss-Jordan elimination (partial pivoting, basic XLA ops)
as the ill-conditioned fallback.  On an H100 XLA's own f64 inverse is
faster at the XL size (``PERF.md``, bring-up measurements); replacing this
stack is a separate change.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def gauss_jordan_inverse(B: jax.Array, tiny: float = 1e-300):
    """Invert ``B`` (m×m, float64) by Gauss-Jordan with partial pivoting.

    Returns ``(B_inv, min_abs_pivot)``.  ``min_abs_pivot`` is the smallest
    pivot magnitude encountered — near zero means ``B`` is (numerically)
    singular and the caller should repair the basis (the reference's exact
    arithmetic can simply never produce one).  Near-singular pivots are
    clamped to ``tiny`` rather than raising so the computation stays
    shape-static under jit.
    """
    m = B.shape[0]
    dtype = B.dtype
    M = jnp.concatenate([B, jnp.eye(m, dtype=dtype)], axis=1)
    rows = jnp.arange(m)

    def body(k, carry):
        M, min_piv = carry
        col = M[:, k]
        candidates = jnp.where(rows >= k, jnp.abs(col), -1.0)
        p = jnp.argmax(candidates)
        # swap rows k and p
        rk = M[k]
        rp = M[p]
        M = M.at[k].set(rp)
        M = M.at[p].set(rk)
        piv = M[k, k]
        min_piv = jnp.minimum(min_piv, jnp.abs(piv))
        piv = jnp.where(jnp.abs(piv) < tiny, jnp.where(piv < 0, -tiny, tiny), piv)
        newk = M[k] / piv
        factors = M[:, k].at[k].set(0.0)
        M = M - factors[:, None] * newk[None, :]
        M = M.at[k].set(newk)
        return M, min_piv

    M, min_piv = lax.fori_loop(0, m, body, (M, jnp.array(jnp.inf, dtype)))
    return M[:, m:], min_piv


# Above this many entries ``inverse_residual`` checks with probe matvecs
# instead of an m³ product.
_EXACT_RESIDUAL_MAX = 1 << 26


def inverse_residual(B: jax.Array, X: jax.Array) -> jax.Array:
    """Residual of a candidate inverse: ``max|I − B·X|``.

    Exact below ``_EXACT_RESIDUAL_MAX`` entries; above it (XL scale) the
    full m×m product is replaced by sign-pattern probe vectors — ``max_k |v_k −
    B(X v_k)|∞`` — four matvecs instead of an m³ matmul.  A probe
    understates the true max-abs residual, but Newton/polish drift is
    dense roundoff, which probes catch; the threshold's meaning (healthy
    vs rebuild) is unchanged.
    """
    m = B.shape[0]
    if m * m <= _EXACT_RESIDUAL_MAX:
        return jnp.max(jnp.abs(jnp.eye(m, dtype=B.dtype) - B @ X))
    i = jnp.arange(m)
    probes = (
        jnp.where(i % 2 == 0, 1.0, -1.0).astype(B.dtype),
        jnp.where((i // 3) % 2 == 0, 1.0, -1.0).astype(B.dtype),
        jnp.where((i * 2654435761 % 97) < 48, 1.0, -1.0).astype(B.dtype),
        jnp.ones(m, B.dtype),
    )
    r = jnp.array(0.0, B.dtype)
    for v in probes:
        r = jnp.maximum(r, jnp.max(jnp.abs(v - B @ (X @ v))))
    return r


# Above this size the scalar Gauss-Jordan fallback is not run: its m
# sequential rank-1 sweeps over the m×2m tableau move ~16·m² bytes each
# (about a minute at m = 16384 at an H100's memory bandwidth); an
# unhealthy Newton result reports a singular basis instead.
_GJ_MAX_M = 12288


def newton_refined_inverse(B: jax.Array, refine_steps: int = 3):
    """f64 inverse: f32 LU inverse seed + Newton-Schulz refinement.

    A f32 inverse seed ``X₀`` refined by ``X ← X(2I − BX)`` (quadratic
    convergence) reaches f64 accuracy in 2-3 iterations of pure matmuls —
    far fewer sequential steps than Gauss-Jordan's m-step elimination.
    Returns ``(X, residual)`` with ``residual = max|I − BX|``; the caller
    falls back to :func:`gauss_jordan_inverse` when the seed was too
    inaccurate (ill-conditioned B) or singular (residual NaN).
    """
    m = B.shape[0]
    eye = jnp.eye(m, dtype=B.dtype)
    X = jnp.linalg.inv(B.astype(jnp.float32)).astype(B.dtype)
    for _ in range(refine_steps):
        X = X @ (2.0 * eye - B @ X)
    residual = inverse_residual(B, X)
    return X, residual


def robust_inverse(B: jax.Array, newton_tol: float = 1e-9):
    """Newton-refined inverse with Gauss-Jordan fallback.

    Returns ``(B_inv, min_pivot_estimate)`` where the pivot estimate is +inf
    on the (healthy) Newton path — singularity is then judged by the caller
    via the GJ fallback's true minimal pivot.
    """
    X, residual = newton_refined_inverse(B)
    healthy = jnp.isfinite(residual) & (residual < newton_tol)

    def use_newton(_):
        return X, jnp.array(jnp.inf, B.dtype)

    if B.shape[0] > _GJ_MAX_M:
        # no Gauss-Jordan at this scale (_GJ_MAX_M): an unhealthy Newton
        # result signals a (near-)singular basis — report pivot 0 so the
        # engine's singular-basis repair takes over.
        def flag_singular(_):
            return X, jnp.array(0.0, B.dtype)

        return lax.cond(healthy, use_newton, flag_singular, None)

    def use_gj(_):
        return gauss_jordan_inverse(B)

    return lax.cond(healthy, use_newton, use_gj, None)


def rank_one_basis_update(Binv: jax.Array, u: jax.Array, r: jax.Array) -> jax.Array:
    """Product-form update of the explicit inverse after a pivot.

    ``u = Binv @ a_q`` is the FTRAN result for the entering column, ``r`` the
    leaving row.  Applies ``E @ Binv`` with ``E = I - (u - e_r) e_rᵀ / u_r``
    (reference ``BasisInverseRows::change_basis`` normalize-and-row-reduce,
    basis_inverse_rows.rs:97-155) as one outer product.
    """
    p = u[r]
    w = Binv[r] / p
    Binv = Binv - u[:, None] * w[None, :]
    return Binv.at[r].set(w)
