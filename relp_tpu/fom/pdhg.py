"""Restarted adaptive PDHG (PDLP-style) for box-constrained LPs.

Solves  min cᵀx  s.t.  Ax = b,  lb ≤ x ≤ ub  (the scaled/padded
ComputationalForm the simplex engines consume) by the Chambolle–Pock
primal-dual iteration with the stabilizations that make it practical for
LP (Applegate et al., "Practical Large-Scale Linear Programming using
Primal-Dual Hybrid Gradient" — the method behind Google PDLP):

    x⁺ = clip(x − (η/ω)(c − Aᵀy), lb, ub)
    y⁺ = y + (ηω)(b − A(2x⁺ − x))

- **adaptive step size**: each step measures the local curvature
  χ = (y⁺−y)ᵀA(x⁺−x) against the weighted movement ‖Δx‖²ω + ‖Δy‖²/ω
  and accepts only when η ≤ η̂ = movement/(2χ); η then tracks η̂ from
  below with the paper's (1 − (k+1)^{-0.3}) / (1 + (k+1)^{-0.6})
  schedule.  Rejected steps cost nothing extra: the two SpMVs the
  candidate needed are the same two the retry reuses.
- **conditional restarts**: rounds of ``round_len`` steps accumulate a
  running average; the round evaluates KKT residuals of the current and
  averaged points and restarts from the better one only on sufficient
  decay (< 0.5× the residual at the last restart) or after a long
  stretch without one — restart-every-round oscillates.
- **primal weight** ω rebalances from the primal/dual movement ratio at
  each restart (θ = 0.5 geometric update).
- **reflected Halpern variant** (``variant="halpern"``): the restarted
  Halpern iteration over the *reflected* PDHG operator,
  z⁺ = (1−β)(2T(z)−z) + β·z₀ with β = 1/(k+2) and z₀ the restart
  anchor (Lu & Yang, "Restarted Halpern PDHG for linear programming" —
  the cuPDLP+ accelerant).  The anchor combination is linear, so the
  cached A·x updates without an extra SpMV; restarts jump to T(z)
  (the paper's rule) when it beats the Halpern iterate.
- every op is an SpMV (amatrix matvec/rmatvec — O(nnz) gathers on the
  ELL layout) or an O(n+m) vector op, in the arrays' dtype (f64, or f32
  for the driver's mixed-precision rounds).
- termination: relative KKT — primal residual ‖Ax−b‖∞/(1+‖b‖∞), dual
  sign-violation of z = c − Aᵀy against infinite bounds, and the
  normalized primal-dual objective gap, all below ``tol``.

The padded rows/columns of the computational form are inert here:
padded columns have lb = ub = 0 (their z never counts as a violation and
contributes 0·z to the dual objective), padded rows are zero with b = 0
(their y stays 0).

No reference counterpart (rust-lp is simplex-only; SURVEY §2.6): this is
the beyond-reference scale path chosen *because* of the hardware — the
simplex engines remain the exactness path.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from relp_tpu.ops.amatrix import as_amatrix
from relp_tpu.simplex import status as st

INF = jnp.inf


class PdhgState(NamedTuple):
    x: jax.Array        # f64[n] current primal
    y: jax.Array        # f64[m] current dual
    ax: jax.Array       # f64[m] cached A·x
    x_sum: jax.Array    # f64[n] running sums since the last restart
    y_sum: jax.Array
    steps: jax.Array    # i32    accepted steps since the last restart
    x_anchor: jax.Array  # f64[n] point of the last restart (ω updates,
    y_anchor: jax.Array  #        Halpern anchor z₀)
    ax_anchor: jax.Array  # f64[m] cached A·x_anchor (Halpern combination)
    eta: jax.Array      # f64    adaptive step size
    omega: jax.Array    # f64    primal weight
    it: jax.Array       # i32    total inner iterations (incl. rejected)
    kkt: jax.Array      # f64    last evaluated KKT (best candidate)
    kkt_mu: jax.Array   # f64    KKT at the last restart
    status: jax.Array   # i32    RUNNING / OPTIMAL / ITERATION_LIMIT


def _power_norm(A, iters: int = 30):
    """‖A‖₂ by power iteration on AᵀA (device SpMVs)."""
    A = as_amatrix(A)
    m, n = A.shape
    # deterministic quasi-random start: a CONSTANT vector can lie exactly
    # in null(A) (SCSD8's balanced rows) — the iteration then collapses to
    # the 1e-6 floor and η comes out ~10⁶× too large, diverging PDHG
    i = jnp.arange(n, dtype=A.dtype)
    v = jnp.cos(1.7 * i + 0.3) + 0.5
    v = v / jnp.linalg.norm(v)

    def body(_, v):
        w = A.rmatvec(A.matvec(v))
        return w / jnp.maximum(jnp.linalg.norm(w), 1e-300)

    v = lax.fori_loop(0, iters, body, v)
    return jnp.sqrt(jnp.maximum(jnp.linalg.norm(A.rmatvec(A.matvec(v))), 1e-12))


@jax.jit
def kkt_residual(A, b, c, lb, ub, x, y):
    """Relative KKT of a point in the arrays' own precision — the driver's
    mixed-precision loop evaluates f32-stage iterates against the f64
    operator through this (cast x/y up before calling)."""
    return _kkt(as_amatrix(A), b, c, lb, ub, x, y)


def cast_state(state: PdhgState, A, dtype) -> PdhgState:
    """Re-express a PDHG state in ``dtype`` against operator ``A``.

    Float leaves are cast; the cached A·x products are RECOMPUTED in the
    target precision (a cached f32 product carries f32 error that would
    otherwise contaminate every subsequent f64 step).
    """
    A = as_amatrix(A)
    x = state.x.astype(dtype)
    xa = state.x_anchor.astype(dtype)
    return state._replace(
        x=x,
        y=state.y.astype(dtype),
        ax=A.matvec(x),
        x_sum=state.x_sum.astype(dtype),
        y_sum=state.y_sum.astype(dtype),
        x_anchor=xa,
        y_anchor=state.y_anchor.astype(dtype),
        ax_anchor=A.matvec(xa),
        eta=state.eta.astype(dtype),
        omega=state.omega.astype(dtype),
        kkt=state.kkt.astype(dtype),
        kkt_mu=state.kkt_mu.astype(dtype),
    )


def _kkt(A, b, c, lb, ub, x, y):
    """Relative KKT residual of (x, y) — the PDLP termination triple."""
    r_prim = jnp.max(jnp.abs(A.matvec(x) - b)) / (1.0 + jnp.max(jnp.abs(b)))
    z = c - A.rmatvec(y)
    # dual feasibility: z > 0 demands a finite lower bound, z < 0 a finite
    # upper bound; violations are the z-mass against infinite bounds
    viol = jnp.where(
        (z > 0) & ~jnp.isfinite(lb), z,
        jnp.where((z < 0) & ~jnp.isfinite(ub), -z, 0.0),
    )
    r_dual = jnp.max(viol) / (1.0 + jnp.max(jnp.abs(c)))
    p_obj = c @ x
    # dual objective bᵀy + Σ lb_j·z_j⁺ + Σ ub_j·z_j⁻ over finite bounds
    d_obj = (
        b @ y
        + jnp.sum(jnp.where((z > 0) & jnp.isfinite(lb), lb * z, 0.0))
        + jnp.sum(jnp.where((z < 0) & jnp.isfinite(ub), ub * z, 0.0))
    )
    gap = jnp.abs(p_obj - d_obj) / (1.0 + jnp.abs(p_obj) + jnp.abs(d_obj))
    return jnp.maximum(jnp.maximum(r_prim, r_dual), gap)


@functools.partial(
    jax.jit, static_argnames=("round_len", "max_rounds", "tol", "variant")
)
def solve_pdhg_chunk(
    A, b, c, lb, ub, state: PdhgState,
    round_len: int = 256, max_rounds: int = 512, tol: float = 1e-8,
    variant: str = "avg",
) -> PdhgState:
    """Run up to ``max_rounds`` restart rounds (``round_len`` adaptive
    PDHG steps each) from ``state``; returns when KKT < tol (OPTIMAL) or
    the round budget is exhausted (status stays RUNNING — the driver
    checks the f64 KKT and continues with another chunk).  ``variant``:
    "avg" restarts to the running average (classic PDLP); "halpern" runs the reflected Halpern iteration
    (module docstring) and restarts to T(z)."""
    A = as_amatrix(A)

    def round_body_halpern(s: PdhgState) -> PdhgState:
        # CONSTANT step size (s.eta stays the driver's 0.9/‖A‖): the
        # reflection 2T−I is nonexpansive only under the global bound
        # τσ‖A‖² ≤ 1 — the avg variant's local-curvature adaptive η can
        # exceed it, and anchoring amplifies the resulting expansion
        # (measured: adaptive-η Halpern is 2-5× slower on Netlib)
        eta = s.eta
        tau = eta / s.omega
        sigma = eta * s.omega

        def step(_, carry):
            x, y, ax, acc = carry
            x1 = jnp.clip(x - tau * (c - A.rmatvec(y)), lb, ub)
            ax1 = A.matvec(x1)
            y1 = y + sigma * (b - (2.0 * ax1 - ax))
            # reflected Halpern step: z⁺ = (1−β)(2T(z)−z) + β z₀,
            # β = 1/(acc+2); all three pieces are linear in (x, ax), so
            # the cached A·x follows the same combination — no extra SpMV
            beta = 1.0 / (acc.astype(b.dtype) + 2.0)
            x = (1.0 - beta) * (2.0 * x1 - x) + beta * s.x_anchor
            y = (1.0 - beta) * (2.0 * y1 - y) + beta * s.y_anchor
            ax = (1.0 - beta) * (2.0 * ax1 - ax) + beta * s.ax_anchor
            return x, y, ax, acc + 1

        x1, y1, ax1, acc = lax.fori_loop(
            0, round_len, step, (s.x, s.y, s.ax, s.steps)
        )
        # Every round ends on one extra PDHG application T(z): it is the
        # paper's restart target, it is CLIPPED (the raw Halpern iterate z
        # need not satisfy the box, and _kkt measures no bound violation),
        # and installing it unconditionally keeps state.x and state.kkt
        # describing the SAME point — the driver snapshots state.x at
        # state.kkt for plateau acceptance, and a mismatch would let it
        # accept a point whose true KKT exceeds the acceptance bar.
        xT = jnp.clip(x1 - tau * (c - A.rmatvec(y1)), lb, ub)
        axT = A.matvec(xT)
        yT = y1 + sigma * (b - (2.0 * axT - ax1))
        kkt = _kkt(A, b, c, lb, ub, xT, yT)

        # Halpern restart rule (Lu & Yang): sufficient decay of the
        # ω-weighted FIXED-POINT residual ‖T(z)−z‖ vs the anchor's
        # (factor 0.2), not KKT decay; kkt_mu stores the anchor residual
        r_fp = jnp.sqrt(
            s.omega * jnp.sum((xT - x1) ** 2)
            + jnp.sum((yT - y1) ** 2) / s.omega
        )
        do_restart = (r_fp < 0.2 * s.kkt_mu) | (acc >= 16 * round_len)

        dxn = jnp.linalg.norm(xT - s.x_anchor)
        dyn = jnp.linalg.norm(yT - s.y_anchor)
        good = do_restart & (dxn > 1e-30) & (dyn > 1e-30)
        omega = jnp.where(
            good,
            jnp.exp(0.5 * jnp.log(dyn / jnp.where(dxn > 0, dxn, 1.0))
                    + 0.5 * jnp.log(s.omega)),
            s.omega,
        )
        omega = jnp.clip(omega, 1e-6, 1e6)

        done = kkt < tol
        return PdhgState(
            x=xT,
            y=yT,
            ax=axT,
            x_sum=s.x_sum,
            y_sum=s.y_sum,
            steps=jnp.where(do_restart, 0, acc).astype(jnp.int32),
            x_anchor=jnp.where(do_restart, xT, s.x_anchor),
            y_anchor=jnp.where(do_restart, yT, s.y_anchor),
            ax_anchor=jnp.where(do_restart, axT, s.ax_anchor),
            eta=eta,
            omega=omega,
            it=s.it + round_len,
            kkt=kkt,
            kkt_mu=jnp.where(do_restart, r_fp, s.kkt_mu),
            status=jnp.where(done, st.OPTIMAL, s.status).astype(jnp.int32),
        )

    def round_body(s: PdhgState) -> PdhgState:
        def step(_, carry):
            x, y, ax, xs, ys, acc, eta, k = carry
            tau = eta / s.omega
            sigma = eta * s.omega
            x1 = jnp.clip(x - tau * (c - A.rmatvec(y)), lb, ub)
            ax1 = A.matvec(x1)
            y1 = y + sigma * (b - (2.0 * ax1 - ax))
            dx = x1 - x
            dy = y1 - y
            # local curvature bound (PDLP adaptive rule): accept while
            # η ≤ η̂ = ‖Δz‖²_ω / (2|ΔyᵀAΔx|); track η̂ from below
            chi = jnp.abs(dy @ (ax1 - ax))
            move = s.omega * (dx @ dx) + (dy @ dy) / s.omega
            eta_hat = jnp.where(chi > 1e-300, move / (2.0 * chi), INF)
            # k+2 keeps the shrink factor strictly positive at k=0 (k+1
            # gives 1−1^{-0.3} = 0 → η collapses to an absorbing 0/NaN);
            # an infinite η̂ must not reach the product (0·∞ = NaN)
            kf = (k + 2).astype(b.dtype)
            shrunk = jnp.where(
                jnp.isfinite(eta_hat), (1.0 - kf ** -0.3) * eta_hat, INF
            )
            eta_next = jnp.clip(
                jnp.minimum(shrunk, (1.0 + kf ** -0.6) * eta), 1e-30, 1e30
            )
            ok = eta <= eta_hat
            x = jnp.where(ok, x1, x)
            y = jnp.where(ok, y1, y)
            ax = jnp.where(ok, ax1, ax)
            xs = jnp.where(ok, xs + x1, xs)
            ys = jnp.where(ok, ys + y1, ys)
            return x, y, ax, xs, ys, acc + ok, eta_next, k + 1

        x1, y1, ax1, xs, ys, acc, eta, _ = lax.fori_loop(
            0, round_len, step,
            (s.x, s.y, s.ax, s.x_sum, s.y_sum, s.steps, s.eta, s.it),
        )
        denom = jnp.maximum(acc, 1).astype(b.dtype)
        x_avg = xs / denom
        y_avg = ys / denom

        kkt_cur = _kkt(A, b, c, lb, ub, x1, y1)
        kkt_avg = _kkt(A, b, c, lb, ub, x_avg, y_avg)
        use_avg = kkt_avg < kkt_cur
        kkt = jnp.minimum(kkt_cur, kkt_avg)

        # conditional restart: sufficient decay vs the last restart, or a
        # long stretch without one (stale averages stop helping)
        do_restart = (kkt < 0.5 * s.kkt_mu) | (acc >= 16 * round_len)
        x_re = jnp.where(use_avg, x_avg, x1)
        y_re = jnp.where(use_avg, y_avg, y1)

        # primal-weight rebalance from movement since the anchor (θ=0.5)
        dxn = jnp.linalg.norm(x_re - s.x_anchor)
        dyn = jnp.linalg.norm(y_re - s.y_anchor)
        good = do_restart & (dxn > 1e-30) & (dyn > 1e-30)
        omega = jnp.where(
            good,
            jnp.exp(0.5 * jnp.log(dyn / jnp.where(dxn > 0, dxn, 1.0))
                    + 0.5 * jnp.log(s.omega)),
            s.omega,
        )
        omega = jnp.clip(omega, 1e-6, 1e6)

        done = kkt < tol
        # install the better candidate on restart AND on termination, and
        # report the KKT of the point actually stored — the driver
        # snapshots state.x at state.kkt (plateau acceptance), so the two
        # must describe the same point
        take = do_restart | done
        x_new = jnp.where(take, x_re, x1)
        y_new = jnp.where(take, y_re, y1)
        ax_out = jnp.where(take & use_avg, A.matvec(x_new), ax1)
        kkt_out = jnp.where(
            take, kkt, kkt_cur
        )
        return PdhgState(
            x=x_new,
            y=y_new,
            ax=ax_out,
            x_sum=jnp.where(do_restart, jnp.zeros_like(xs), xs),
            y_sum=jnp.where(do_restart, jnp.zeros_like(ys), ys),
            steps=jnp.where(do_restart, 0, acc).astype(jnp.int32),
            x_anchor=jnp.where(do_restart, x_new, s.x_anchor),
            y_anchor=jnp.where(do_restart, y_new, s.y_anchor),
            # on restart x_anchor = x_new, whose A·x is ax_out already
            ax_anchor=jnp.where(do_restart, ax_out, s.ax_anchor),
            eta=eta,
            omega=omega,
            it=s.it + round_len,
            kkt=kkt_out,
            kkt_mu=jnp.where(do_restart, kkt, s.kkt_mu),
            status=jnp.where(done, st.OPTIMAL, s.status).astype(jnp.int32),
        )

    def cond(sr):
        s, r = sr
        return (s.status == st.RUNNING) & (r < max_rounds)

    step_round = round_body_halpern if variant == "halpern" else round_body

    def body(sr):
        s, r = sr
        return step_round(s), r + 1

    final, _ = lax.while_loop(cond, body, (state, jnp.int32(0)))
    return final


def solve_pdhg_batched(
    A, b, c, lb, ub,
    round_len: int = 64, max_rounds: int = 256, tol: float = 1e-8,
    variant: str = "halpern", mesh=None,
):
    """Solve a STACK of same-shape box-constrained LPs with restarted PDHG
    (first-order analogue of :func:`relp_tpu.parallel.batched.solve_batched`):
    every input has a leading scenario axis, the whole chunk is vmapped,
    and with a mesh the scenario axis is sharded over 'batch'.  Returns the
    final stacked :class:`PdhgState` (statuses are per-scenario)."""
    import numpy as np

    arrays = [np.asarray(v, np.float64) for v in (A, b, c, lb, ub)]
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        batch = NamedSharding(mesh, P("batch"))
        arrays = [jax.device_put(v, batch) for v in arrays]
    A, b, c, lb, ub = arrays

    def one(A, b, c, lb, ub):
        eta0 = 0.9 / _power_norm(A)
        s = initial_state(A, lb, ub, eta0)
        return solve_pdhg_chunk(
            A, b, c, lb, ub, s,
            round_len=round_len, max_rounds=max_rounds, tol=tol,
            variant=variant,
        )

    return jax.jit(jax.vmap(one))(A, b, c, lb, ub)


def initial_state(A, lb, ub, eta0, dtype=jnp.float64) -> PdhgState:
    A = as_amatrix(A)
    m, n = A.shape
    x0 = jnp.clip(jnp.zeros(n, dtype), lb, ub)
    y0 = jnp.zeros(m, dtype)
    ax0 = A.matvec(x0)
    return PdhgState(
        x=x0, y=y0, ax=ax0,
        x_sum=jnp.zeros(n, dtype), y_sum=jnp.zeros(m, dtype),
        steps=jnp.int32(0),
        x_anchor=x0, y_anchor=y0, ax_anchor=ax0,
        eta=jnp.asarray(eta0, dtype),
        omega=jnp.array(1.0, dtype),
        it=jnp.int32(0),
        kkt=jnp.array(INF, dtype),
        kkt_mu=jnp.array(INF, dtype),
        status=jnp.int32(st.RUNNING),
    )
