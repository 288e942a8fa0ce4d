"""Bounded-variable dual simplex (device core).

Goes BEYOND the reference, whose roadmap leaves "Dual algorithm" unchecked
(README.md:15-28): given a *dual-feasible* basis (e.g. the optimal basis of
a related problem whose bounds were since tightened — branch-and-bound's
re-solve pattern), iterate on primal feasibility while maintaining dual
feasibility.  Same device shape as the primal core: one ``lax.while_loop``,
straight-line selects, dense maintained inverse with rank-1 updates and
periodic refactorization; the dual update reuses the identity
``π' = π + (d_q/u_r)·B⁻¹[r,:]``.

Per iteration:
  1. leaving row r: largest bound violation of xB scaled by EXACT dual
     steepest-edge weights β_i = ‖B⁻¹[i,:]‖² (Forrest–Goldfarb update;
     OPTIMAL when no violation),
  2. pivot row α = B⁻¹[r]·A and the **bound-flipping dual ratio test**
     (BFRT, "long step"): candidates sorted by |d_j/α_j|; passing a boxed
     candidate flips it to its opposite bound and reduces the rate at which
     row r's infeasibility shrinks by (ub_j−lb_j)·|α_j| — the entering q is
     the candidate at which that slope crosses zero, with a Harris-style
     tolerance picking the largest |α| among near-ties (primal INFEASIBLE
     when no candidate exists — the dual is unbounded),
  3. batch-apply the flips (one SpMV + FTRAN), then pivot: u = B⁻¹a_q,
     update xB/B⁻¹/π/statuses.

XL problems (``m_pad > config.refactor_external_m``) run the SAME body
through the *externally refactorized* entry points ``dual_xl_*``: the
refactorization leaves the jitted loop entirely and becomes separate small
device programs orchestrated by the host driver, so the O(m²)
refactorization temporaries are never live next to the loop state.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from relp_tpu.ops.amatrix import as_amatrix
from relp_tpu.ops.linalg import (
    gauss_jordan_inverse,
    inverse_residual,
    newton_refined_inverse,
    robust_inverse,
)
from relp_tpu.simplex import status as st
from relp_tpu.simplex.core import SolveOutput, _nonbasic_values
from relp_tpu.utils.config import SolverConfig

INF = jnp.inf


class DState(NamedTuple):
    basis: jax.Array
    vstat: jax.Array  # i32[n+m] — statuses incl. artificial slots
    xB: jax.Array
    Binv: jax.Array
    pi: jax.Array
    d: jax.Array      # f64[n] — reduced costs, maintained incrementally
    #                   (d' = d − θ_D·α; recomputed at refactorization)
    beta: jax.Array   # f64[m] — EXACT dual steepest-edge row weights
    #                   β_i = ‖B⁻¹[i,:]‖² (Forrest–Goldfarb update via
    #                   τ = B⁻¹·B⁻¹[r,:]ᵀ; reset at refactorization)
    status: jax.Array
    it: jax.Array
    since_refactor: jax.Array
    repairs: jax.Array
    flips: jax.Array  # i32 — total bound flips applied by the BFRT


def _basis_matrix(A, basis, art_sign):
    """Gather the (m, m) basis matrix; artificial columns are virtual
    ±e_i (signed — see ``solve_core_dual``'s ``art_sign0``)."""
    m, n = A.shape
    is_art = basis >= n
    struct_cols = A.cols_matrix(jnp.clip(basis, 0, n - 1))
    k = jnp.clip(basis - n, 0, m - 1)
    art_cols = (jnp.arange(m)[:, None] == k[None, :]) * art_sign[k][None, :]
    return jnp.where(is_art[None, :], art_cols, struct_cols), is_art


def _derived_state(A, b, c, lb_tot, ub_tot, basis, vstat, Binv):
    """Recompute the loop state derived from (basis, vstat, B⁻¹):
    xB, π, reduced costs and exact DSE weights."""
    m, n = A.shape
    is_art = basis >= n
    nb = _nonbasic_values(vstat, lb_tot, ub_tot)
    nb = jnp.where(vstat == st.BASIC, 0.0, nb)
    r = b - A.matvec(nb[:n])
    xB = Binv @ r
    cB = jnp.where(is_art, 0.0, jnp.take(c, jnp.clip(basis, 0, n - 1)))
    pi = cB @ Binv
    d = c - A.rmatvec(pi)
    beta = jnp.sum(Binv * Binv, axis=1)
    return xB, pi, d, beta


def _make_kernel(A, b, c, lb, ub, art_sign, cfg: SolverConfig, max_iter,
                 external: bool):
    """Shared dual-simplex closures over DState.

    ``external=False``: the classic single-program form — the body starts
    with a ``lax.cond`` refactorization when due.  ``external=True``: the
    body never refactorizes; instead the loop *condition* stops when a
    refactorization is pending (``since_refactor >= refactor_period``) and
    the host driver runs the ``dual_xl_*`` programs before re-entering.
    """
    m, n = A.shape
    f = A.dtype
    lb_tot = jnp.concatenate([lb, jnp.zeros(m, f)])
    ub_tot = jnp.concatenate([ub, jnp.zeros(m, f)])
    boxed_range = ub - lb  # flip capacity of each column (INF when unboxed)

    def refactor(s: DState) -> DState:
        B, is_art = _basis_matrix(A, s.basis, art_sign)

        def rebuild_full(_):
            if cfg.newton_refactor:
                return robust_inverse(B)
            return gauss_jordan_inverse(B)

        if cfg.refactor_mode == "polish":
            # same Newton-polish as the primal core: one step on the
            # maintained inverse, full rebuild on residual failure
            X = s.Binv
            eye = jnp.eye(m, dtype=f)
            X1 = X @ (2.0 * eye - B @ X)
            resid = inverse_residual(B, X1)
            healthy = jnp.isfinite(resid) & (resid < 1e-9)
            Binv, min_piv = lax.cond(
                healthy,
                lambda _: (X1, jnp.array(jnp.inf, f)),
                rebuild_full,
                None,
            )
        else:
            Binv, min_piv = rebuild_full(None)
        xB, pi, d, beta = _derived_state(
            A, b, c, lb_tot, ub_tot, s.basis, s.vstat, Binv
        )
        singular = min_piv < cfg.singular_tol
        return s._replace(
            Binv=Binv,
            xB=xB,
            pi=pi,
            d=d,
            beta=beta,
            since_refactor=jnp.int32(0),
            status=jnp.where(singular, st.NUMERICAL, s.status).astype(jnp.int32),
        )

    def body(s: DState) -> DState:
        if not external:
            s = lax.cond(
                s.since_refactor >= cfg.refactor_period, refactor, lambda s: s, s
            )
        broken = ~jnp.isfinite(jnp.sum(s.xB) + jnp.sum(s.pi))
        fresh = s.since_refactor == 0

        k = s.basis
        lbk = jnp.take(lb_tot, k)
        ubk = jnp.take(ub_tot, k)
        below = lbk - s.xB
        above = s.xB - ubk
        viol = jnp.maximum(jnp.maximum(below, above), 0.0)
        # dual steepest edge: largest infeasibility scaled by the TRUE row
        # norm of B⁻¹ (β maintained exactly via Forrest–Goldfarb below)
        r = jnp.argmax(viol * viol / jnp.maximum(s.beta, 1e-12)).astype(jnp.int32)
        # the termination decision stays norm-free
        primal_feasible = jnp.max(viol) <= cfg.eps_feas
        r = jnp.where(primal_feasible, jnp.argmax(viol), r).astype(jnp.int32)

        # pivot row and (incrementally maintained) reduced costs
        rho = s.Binv[r]
        alpha = A.rmatvec(rho)
        d = s.d
        vs = s.vstat[:n]

        leaving_below = below[r] > above[r]  # xB_r under its lower bound
        # sign-compatible entering candidates keep dual feasibility:
        #   below-lower: at-lower with α<0, at-upper with α>0, free either
        # (mirrored when above-upper; fold by flipping α's sign)
        alpha_eff = jnp.where(leaving_below, alpha, -alpha)
        at_l = (vs == st.NB_LOWER) | (vs == st.NB_FREE)
        at_u = (vs == st.NB_UPPER) | (vs == st.NB_FREE)
        cand = ((at_l & (alpha_eff < -cfg.eps_pivot)) | (at_u & (alpha_eff > cfg.eps_pivot)))
        cand = cand & (lb < ub) & (vs != st.BASIC)
        abs_alpha = jnp.abs(alpha_eff)
        ratio = jnp.where(cand, jnp.abs(d) / jnp.maximum(abs_alpha, 1e-300), INF)

        # ---- bound-flipping ratio test (long-step dual, vectorized) ----
        # In ratio order, passing candidate j reduces the rate at which row
        # r's infeasibility shrinks by its flip capacity (ub_j−lb_j)·|α_j|;
        # q is where the remaining slope crosses 0.  Unboxed candidates have
        # infinite capacity and always block.
        cap = jnp.where(cand, boxed_range * abs_alpha, 0.0)
        if cfg.dual_ratio == "bisect":
            # Sort-free form: the blocking ratio is the step-function
            # crossing t* = min{t : Σ_{cand, ratio≤t} cap ≥ viol_r}; locate
            # it by scalar bisection (64 masked O(n) reductions instead of
            # one O(n log n) argsort + gathers at DFL001-class n).
            # Selection below is identical to the sorted form up to
            # exact-ratio ties.
            total_cap = jnp.sum(cap)
            any_block = total_cap >= viol[r]
            hi0 = jnp.max(jnp.where(cand, ratio, 0.0))

            def bis(_, lohi):
                lo, hi = lohi
                mid = 0.5 * (lo + hi)
                s_mid = jnp.sum(jnp.where(ratio <= mid, cap, 0.0))
                pred = s_mid >= viol[r]
                return (jnp.where(pred, lo, mid), jnp.where(pred, mid, hi))

            lo, _hi = lax.fori_loop(
                0, 64, bis, (jnp.array(-1.0, f), hi0)
            )
            ratio_block = jnp.min(jnp.where(cand & (ratio > lo), ratio, INF))
            near = (
                cand
                & (ratio <= ratio_block)
                & (ratio >= ratio_block - cfg.eps_dual)
            )
            q = jnp.argmax(jnp.where(near, abs_alpha, -1.0)).astype(jnp.int32)
            has_entering = any_block & jnp.isfinite(ratio_block)
            # flips: candidates whose reduced cost crosses zero strictly
            # before the chosen q's (their cap sum stays < viol_r, so the
            # row's infeasibility keeps shrinking after the flips)
            flip_mask = cand & (ratio < ratio[q])
        else:
            order = jnp.argsort(jnp.where(cand, ratio, INF))
            cap_sorted = jnp.take(cap, order)
            cand_sorted = jnp.take(cand, order)
            slope_after = viol[r] - jnp.cumsum(cap_sorted)
            blocked = cand_sorted & (slope_after <= 0)
            any_block = jnp.any(blocked)
            kq_block = jnp.argmax(blocked)  # first True (0 if none)

            # Harris-style tie tolerance: among candidates at sorted
            # positions ≤ blocker whose ratio is within the dual tolerance
            # of the blocker's, take the largest |α| (stability; mirrors the
            # primal Harris pass 2).
            ratio_sorted = jnp.where(cand_sorted, jnp.take(ratio, order), INF)
            ratio_block = ratio_sorted[kq_block]
            pos_ids = jnp.arange(n)
            near = (
                cand_sorted
                & (pos_ids <= kq_block)
                & (ratio_sorted >= ratio_block - cfg.eps_dual)
            )
            kq = jnp.argmax(jnp.where(near, jnp.take(abs_alpha, order), -1.0))
            q = order[kq].astype(jnp.int32)
            has_entering = any_block & jnp.isfinite(ratio_sorted[kq])

            # flips: all candidates strictly before the chosen position
            flip_sorted = cand_sorted & (pos_ids < kq)
            flip_mask = jnp.zeros(n, bool).at[order].set(flip_sorted)
        n_flips = jnp.sum(flip_mask).astype(jnp.int32)

        # pivot quantities
        u = A.ftran(s.Binv, q)
        p = u[r]
        ok_pivot = jnp.abs(p) > cfg.eps_pivot
        p_safe = jnp.where(jnp.abs(p) > 1e-300, p, 1.0)

        do_pivot = (~primal_feasible) & has_entering & (~broken) & ok_pivot

        # ---- apply the batch of bound flips: one SpMV + one FTRAN ----
        def with_flips(xB):
            dx = jnp.where(
                flip_mask,
                jnp.where(vs == st.NB_LOWER, boxed_range, -boxed_range),
                0.0,
            )
            return xB - s.Binv @ A.matvec(dx)

        xB_f = lax.cond(
            do_pivot & (n_flips > 0), with_flips, lambda xB: xB, s.xB
        )
        flip_to = jnp.where(vs == st.NB_LOWER, st.NB_UPPER, st.NB_LOWER)
        vstat_flip = jnp.where(flip_mask, flip_to, vs).astype(jnp.int32)

        bound_r = jnp.where(leaving_below, lbk[r], ubk[r])
        theta_p = (xB_f[r] - bound_r) / p_safe
        start_val = jnp.where(
            vs[q] == st.NB_UPPER, ub[q], jnp.where(vs[q] == st.NB_LOWER, lb[q], 0.0)
        )

        xB_new = xB_f - theta_p * u
        xB_new = xB_new.at[r].set(start_val + theta_p)
        w_row = s.Binv[r] / p_safe
        Binv_new = (s.Binv - u[:, None] * w_row[None, :]).at[r].set(w_row)
        theta_d = d[q] / p_safe
        pi_new = s.pi + theta_d * s.Binv[r]
        # incremental reduced costs: d' = d − θ_D·α (exact identity; the
        # entering column's d becomes 0, the leaving column's −θ_D)
        d_new = (d - theta_d * alpha).at[q].set(0.0)
        ratio_u = u / p_safe
        beta_r = s.beta[r]
        if cfg.dual_pricing == "devex":
            # Devex reference weights (dual form): γ_i' = max(γ_i,
            # (u_i/p)²·γ_r), γ_r' = max(γ_r/p², 1) — needs only the FTRAN
            # column u, removing the ONLY remaining full-m² matvec per
            # iteration at XL scale.  Exactness is restored at every
            # refactorization (_derived_state recomputes β = ‖B⁻¹[i,:]‖²),
            # so the approximation drifts for at most refactor_period pivots.
            beta_new = jnp.maximum(s.beta, ratio_u * ratio_u * beta_r)
            beta_new = beta_new.at[r].set(
                jnp.maximum(beta_r / (p_safe * p_safe), 1.0)
            )
            beta_new = jnp.clip(beta_new, 1e-12, 1e12)
        else:
            # Forrest–Goldfarb exact dual-steepest-edge weight update:
            #   τ = B⁻¹·(B⁻¹[r,:])ᵀ;  β_r' = β_r/p²;
            #   β_i' = β_i − 2(u_i/p)·τ_i + (u_i/p)²·β_r   (i ≠ r)
            tau = s.Binv @ rho
            beta_new = s.beta - 2.0 * ratio_u * tau + ratio_u * ratio_u * beta_r
            beta_new = beta_new.at[r].set(beta_r / (p_safe * p_safe))
            beta_new = jnp.maximum(beta_new, 1e-12)

        kr = k[r]
        leave_stat = jnp.where(leaving_below, st.NB_LOWER, st.NB_UPPER)
        leave_stat = jnp.where(
            jnp.take(lb_tot, kr) == jnp.take(ub_tot, kr), st.NB_FIXED, leave_stat
        )
        vstat_new = (
            s.vstat.at[:n].set(vstat_flip)
            .at[kr].set(leave_stat.astype(jnp.int32))
            .at[q].set(st.BASIC)
        )

        status_new = jnp.where(
            primal_feasible & fresh & ~broken,
            st.OPTIMAL,
            jnp.where(
                (~primal_feasible) & (~has_entering) & fresh & ~broken,
                st.INFEASIBLE,
                s.status,
            ),
        )
        wants_terminal = primal_feasible | ((~primal_feasible) & (~has_entering))
        # a too-small pivot is a numerical event: rebuild and retry
        force_refac = (wants_terminal & ~fresh) | broken | (
            (~primal_feasible) & has_entering & ~ok_pivot
        )

        return DState(
            basis=jnp.where(do_pivot, s.basis.at[r].set(q), s.basis),
            vstat=jnp.where(do_pivot, vstat_new, s.vstat),
            xB=jnp.where(do_pivot, xB_new, s.xB),
            Binv=jnp.where(do_pivot, Binv_new, s.Binv),
            pi=jnp.where(do_pivot, pi_new, s.pi),
            d=jnp.where(do_pivot, d_new, s.d),
            beta=jnp.where(do_pivot, beta_new, s.beta),
            status=status_new.astype(jnp.int32),
            it=s.it + 1,
            since_refactor=jnp.where(
                force_refac,
                cfg.refactor_period,
                s.since_refactor + do_pivot.astype(jnp.int32),
            ).astype(jnp.int32),
            repairs=s.repairs,
            flips=s.flips + jnp.where(do_pivot, n_flips, 0),
        )

    def cond(s: DState):
        run = (s.status == st.RUNNING) & (s.it < max_iter)
        if external:
            run = run & (s.since_refactor < cfg.refactor_period)
        return run

    return refactor, body, cond


@functools.partial(jax.jit, static_argnames=("cfg",))
def solve_core_dual(
    A, b, c, lb, ub, basis0, vstat0, cfg: SolverConfig, max_iter: int,
    art_sign0=None,
) -> SolveOutput:
    """Dual simplex from a dual-feasible warm basis (padded arrays as in
    ``solve_core``).  If the start is not dual feasible the method may stop
    at a dual-infeasible point — callers should fall back to the primal
    core on a NUMERICAL/ITERATION_LIMIT outcome.

    ``art_sign0`` carries the artificial column signs of a prior primal
    solve (``SolveOutput.art_sign``): the primal engine's artificial columns
    are *signed* ±e_i, and a basis containing a sign-−1 artificial (e.g. on
    a redundant row) must be refactorized with that sign or B is wrong on
    those rows.
    """
    A = as_amatrix(A)
    m, n = A.shape
    f = A.dtype
    art_sign = (
        jnp.ones(m, f) if art_sign0 is None else art_sign0.astype(f)
    )
    lb_tot = jnp.concatenate([lb, jnp.zeros(m, f)])
    ub_tot = jnp.concatenate([ub, jnp.zeros(m, f)])

    vstat_full = jnp.concatenate(
        [vstat0.astype(jnp.int32), jnp.full(m, st.NB_LOWER, jnp.int32)]
    )
    state0 = DState(
        basis=basis0.astype(jnp.int32),
        vstat=vstat_full,
        xB=jnp.zeros(m, f),
        Binv=jnp.eye(m, dtype=f),
        pi=jnp.zeros(m, f),
        d=jnp.zeros(n, f),
        beta=jnp.ones(m, f),
        status=jnp.int32(st.RUNNING),
        it=jnp.int32(0),
        since_refactor=jnp.int32(cfg.refactor_period),  # refactor first
        repairs=jnp.int32(0),
        flips=jnp.int32(0),
    )

    refactor, body, cond = _make_kernel(
        A, b, c, lb, ub, art_sign, cfg, max_iter, external=False
    )
    final = lax.while_loop(cond, body, state0)
    final = final._replace(
        status=jnp.where(
            final.status == st.RUNNING, st.ITERATION_LIMIT, final.status
        ).astype(jnp.int32)
    )
    final = refactor(final)

    nb = _nonbasic_values(final.vstat, lb_tot, ub_tot)
    nb = jnp.where(final.vstat == st.BASIC, 0.0, nb)
    x_pad = jnp.zeros(n + 1, f).at[:n].set(nb[:n])
    target = jnp.where(final.basis < n, final.basis, n)
    x_pad = x_pad.at[target].set(jnp.where(final.basis < n, final.xB, 0.0))
    x = x_pad[:n]

    art_inf = jnp.sum(jnp.where(final.basis >= n, jnp.abs(final.xB), 0.0))
    return SolveOutput(
        x=x,
        status=final.status,
        it=final.it,
        phase=jnp.int32(2),
        basis=final.basis,
        vstat=final.vstat,
        art_inf=art_inf,
        pi=final.pi,
        obj=c @ x,
        art_sign=art_sign,
        trace=jnp.zeros((0, 8), jnp.float32),
        viol=jnp.zeros((), f),
    )


# ---------------------------------------------------------------------------
# Externally refactorized (XL) entry points.  The driver orchestrates:
#
#   rebuild (cold)  →  derive  →  iterate ... ┐
#        ▲                                    │ since_refactor pending
#        └── (residual bad) ── polish ◄───────┘
#
# Each is a separate XLA program with a bounded HBM peak; ``iterate`` is the
# hot loop and carries/donates the 𝑂(m²) inverse so chunked continuations
# never copy it.
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("cfg",))
def dual_xl_rebuild(A, basis, art_sign, cfg: SolverConfig):
    """From-scratch inverse of the current basis: f32 LU seed +
    Newton-Schulz refinement (ops/linalg.py).  Returns ``(Binv, resid)``;
    a non-finite or large residual means (near-)singular."""
    A = as_amatrix(A)
    B, _ = _basis_matrix(A, basis.astype(jnp.int32), art_sign)
    return newton_refined_inverse(B)


@jax.jit
def dual_xl_resid(A, basis, art_sign, Binv):
    """Probe residual of the MAINTAINED inverse against the current basis
    columns (ops/linalg.inverse_residual — 4 sign-pattern probes, 8
    matvecs).  ~m/4 000× fewer FLOPs than a Newton polish (two m³ f64
    matmuls): the driver checks this first and skips the polish while
    the rank-1 product-form drift is still below the SAME 1e-9 health bar
    the polish itself applies, so the freshness invariant is unchanged."""
    A = as_amatrix(A)
    B, _ = _basis_matrix(A, basis.astype(jnp.int32), art_sign)
    return inverse_residual(B, Binv)


@functools.partial(jax.jit, donate_argnums=(3,))
def dual_xl_polish(A, basis, art_sign, Binv):
    """One Newton-Schulz step on the maintained inverse against the fresh
    basis columns + probe residual.  Returns ``(X1, resid)``; the driver
    falls back to :func:`dual_xl_rebuild` when ``resid`` is unhealthy."""
    A = as_amatrix(A)
    f = A.dtype
    m = A.shape[0]
    B, _ = _basis_matrix(A, basis.astype(jnp.int32), art_sign)
    X1 = Binv @ (2.0 * jnp.eye(m, dtype=f) - B @ Binv)
    return X1, inverse_residual(B, X1)


@jax.jit
def dual_xl_derive(A, b, c, lb, ub, basis, vstat, Binv):
    """Recompute (xB, π, d, β) from a freshly refactorized inverse."""
    A = as_amatrix(A)
    m = A.shape[0]
    f = A.dtype
    lb_tot = jnp.concatenate([lb, jnp.zeros(m, f)])
    ub_tot = jnp.concatenate([ub, jnp.zeros(m, f)])
    return _derived_state(
        A, b, c, lb_tot, ub_tot, basis.astype(jnp.int32), vstat, Binv
    )


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnums=(8,))
def dual_xl_iterate(
    A, b, c, lb, ub, basis, vstat, xB, Binv, pi, d, beta, since_refactor,
    flips, cfg: SolverConfig, max_iter,
) -> DState:
    """Run dual iterations until terminal, out of budget, or a
    refactorization is pending (``since_refactor >= cfg.refactor_period`` —
    the host then runs polish/rebuild + derive and re-enters).  ``vstat``
    is the FULL (n+m) status vector; ``Binv`` is donated."""
    A = as_amatrix(A)
    art_sign = jnp.ones(A.shape[0], A.dtype)  # unused: body never refactors
    _, body, cond = _make_kernel(
        A, b, c, lb, ub, art_sign, cfg, max_iter, external=True
    )
    state0 = DState(
        basis=basis.astype(jnp.int32),
        vstat=vstat.astype(jnp.int32),
        xB=xB,
        Binv=Binv,
        pi=pi,
        d=d,
        beta=beta,
        status=jnp.int32(st.RUNNING),
        it=jnp.int32(0),
        since_refactor=since_refactor.astype(jnp.int32),
        repairs=jnp.int32(0),
        flips=flips.astype(jnp.int32),
    )
    return lax.while_loop(cond, body, state0)
