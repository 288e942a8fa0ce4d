"""The jitted two-phase bounded-variable revised simplex core.

This is the device replacement for the reference's entire simplex engine
(``src/algorithm/two_phase/``, SURVEY §2.6): the whole solve is ONE
``lax.while_loop`` whose body fuses pricing, FTRAN, the ratio test and the
basis-inverse update into a single device step with no host round-trips.

Mapping (reference → here):

- ``Tableau<IM,K>`` + ``Carry`` (−π, b, basis bookkeeping,
  tableau/mod.rs:24-38, carry/mod.rs:45-65) → the :class:`State` pytree
  carried through the loop: ``basis``, ``vstat``, ``xB``, dense ``Binv``.
- phase 1 / phase 2 drivers (phase_one.rs, phase_two.rs) → a ``phase`` flag
  in the state; effective costs/bounds switch by ``jnp.where``.  Artificial
  variables occupy virtual columns ``[n, n+m)`` — never materialized: their
  columns are ``±e_i`` so FTRAN/refactorization handle them analytically
  (the reference's ``Artificial`` tableau kinds, kind/artificial/).
- pivot rules (strategy/pivot_rule.rs) → one fused matvec
  ``d = c − πᵀA`` over the whole column pool followed by a masked argmax;
  Dantzig and Bland are different argmax keys.  The anti-cycling guarantee
  of exact arithmetic is replaced by automatic switching to Bland's rule
  after a run of degenerate pivots.
- ratio test with Bland tie-break (tableau/mod.rs:221-247) → vectorized
  masked minimum over ``(xB − bound)/u`` with a stability tie-break
  (largest |pivot|), plus *bound-flip* steps from the bounded-variable
  method (replacing the reference's virtual bound rows, matrix_data.rs:39-52).
- artificials leaving at zero level (phase_one.rs:223-260
  ``remove_artificial_basis_variables``) → artificial upper bounds collapse
  to 0 in phase 2, so the ratio test automatically pivots them out at ratio
  0 on either pivot sign; rank-deficient rows simply keep their artificial
  basic at level 0 forever (masking instead of ``RemoveRows`` rebuilds).
- refactorization (carry/mod.rs:602, lower_upper/mod.rs:199-202) →
  ``gauss_jordan_inverse`` of the gathered basis columns every
  ``refactor_period`` pivots, plus once at the phase switch and once at the
  end for a clean solution.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from relp_tpu.ops.amatrix import as_amatrix
from relp_tpu.ops.linalg import (
    gauss_jordan_inverse,
    inverse_residual,
    robust_inverse,
)
from relp_tpu.simplex import status as st
from relp_tpu.utils.config import SolverConfig

INF = jnp.inf


class State(NamedTuple):
    basis: jax.Array          # i32[m] — column index in [0, n+m) per row
    vstat: jax.Array          # i32[n+m]
    xB: jax.Array             # f64[m] — values of basic variables
    Binv: jax.Array           # f64[m, m]
    pi: jax.Array             # f64[m] — simplex multipliers c_Bᵀ B⁻¹, updated
    #                           incrementally: π' = π + (d_q/u_r)·B⁻¹[r,:]
    #                           (recomputed at refactorization; saves
    #                           the per-pivot BTRAN matvec)
    art_sign: jax.Array       # f64[m] — artificial column i is art_sign[i]*e_i
    phase: jax.Array          # i32 scalar: 1 or 2
    status: jax.Array         # i32 scalar
    it: jax.Array             # i32 — total pivots/flips performed
    since_refactor: jax.Array # i32
    degen_count: jax.Array    # i32 — consecutive degenerate steps
    bland: jax.Array          # bool — Bland's rule active
    repairs: jax.Array        # i32 — singular-basis repairs performed
    w: jax.Array              # f64[n] — devex reference weights (≈‖B⁻¹a_j‖²)
    etaZ: jax.Array           # f64[m, T] — pending eta block in COMPOSED form:
    #                           current B⁻¹ = (I + etaZ·P^T)·Binv with P's
    #                           columns e_{etaR[i]} (cfg.inverse == "eta";
    #                           T=1 dummy otherwise)
    etaR: jax.Array           # i32[T] — pivot rows of the pending etas
    eta_count: jax.Array      # i32 — live pending etas
    trace: jax.Array          # f32[cap, 8] per-iteration metric ring buffer
    #                           (cfg.trace_iters; zero-length when off):
    #                           [phase, cB·xB, art_mass, d_q, theta, events,
    #                            q, r] with events = pivot|2·flip|4·refresh|
    #                           8·bland
    viol: jax.Array           # f64 — worst invariant violation seen by the
    #                           periodic in-loop check (cfg.check_every_n)
    pblock: jax.Array         # i32 — current partial-pricing block (rotates
    #                           block-cyclically; cfg.price_blocks)
    refactors: jax.Array      # i32[3] — refactorizations by path: Newton
    #                           polish of the maintained inverse, rebuild
    #                           from the f32 seed + Newton, Gauss-Jordan


class SolveOutput(NamedTuple):
    x: jax.Array        # f64[n] — solution in scaled space (structural+slack)
    status: jax.Array   # i32
    it: jax.Array       # i32
    phase: jax.Array    # i32
    basis: jax.Array    # i32[m]
    vstat: jax.Array    # i32[n+m]
    art_inf: jax.Array  # f64 — residual artificial mass (diagnostic)
    pi: jax.Array       # f64[m] — duals (phase-2 simplex multipliers)
    obj: jax.Array      # f64 — c @ x in the solver's (scaled, min) space
    art_sign: jax.Array # f64[m] — artificial column signs (chunked resume)
    trace: jax.Array    # f32[cap, 8] — per-iteration metrics (see State)
    viol: jax.Array     # f64 — worst periodic-invariant violation (0 if off)
    refactors: jax.Array = None  # i32[3] — see State (primal core only)


def _nonbasic_values(vstat, lb_tot, ub_tot):
    """Value of each column when nonbasic (0 for basic columns)."""
    at_lower = (vstat == st.NB_LOWER) | (vstat == st.NB_FIXED)
    at_upper = vstat == st.NB_UPPER
    return jnp.where(at_lower, lb_tot, jnp.where(at_upper, ub_tot, 0.0))


def _make_primal_kernel(A, b, c, lb, ub, cfg: SolverConfig, max_iter,
                        external: bool = False):
    """Build the primal kernel (refactor/repair/body/cond) over a fixed
    problem.  ``A`` is already an amatrix (f32 shadow attached when the
    config prices in f32).

    ``external=False`` is the classic in-loop form: the body runs the
    refactorization as a ``lax.cond`` branch.  ``external=True`` is the
    XL form (the dual engine's ``dual_xl_*`` pattern): the body never
    refactorizes -- ``cond`` exits the loop whenever one is pending and
    the HOST runs it as separate bounded device programs
    (``primal_xl_*`` below), so the loop state never holds the
    refactorization's O(m^2) temporaries next to its own.
    """
    m, n = A.shape
    f = A.dtype

    lb_tot = jnp.concatenate([lb, jnp.zeros(m, f)])
    ub_tot_p2 = jnp.concatenate([ub, jnp.zeros(m, f)])  # artificials pinned to 0 in phase 2

    can_enter = (lb < ub)  # fixed + padded columns never enter
    col_ids = jnp.arange(n)
    use_eta = cfg.inverse == "eta"
    T = cfg.eta_block if use_eta else 1
    trace_cap = cfg.trace_capacity if cfg.trace_iters else 0
    eta0 = dict(
        etaZ=jnp.zeros((m, T), f),
        etaR=jnp.zeros(T, jnp.int32),
        eta_count=jnp.int32(0),
    )
    obs0 = dict(
        trace=jnp.zeros((trace_cap, 8), jnp.float32),
        viol=jnp.zeros((), f),
        pblock=jnp.int32(0),
        refactors=jnp.zeros(3, jnp.int32),
    )

    def art_mass(s: State):
        return jnp.sum(jnp.where(s.basis >= n, jnp.abs(s.xB), 0.0))

    # ---- basis repair: warm phase-1 restart from the artificial basis ----
    def repair(s: State) -> State:
        """The float-world analogue of a situation the exact-arithmetic
        reference cannot reach: the maintained basis went numerically
        singular.  Demote every basic structural column to a nonbasic
        status (keeping all other statuses — the warm part), put the
        artificials back, and resume in phase 1 under Bland's rule."""
        vs_all = s.vstat
        demote = jnp.where(
            lb_tot == ub_tot_p2,
            st.NB_FIXED,
            jnp.where(
                jnp.isfinite(lb_tot),
                st.NB_LOWER,
                jnp.where(jnp.isfinite(ub_tot_p2), st.NB_UPPER, st.NB_FREE),
            ),
        )
        vstat = jnp.where(vs_all == st.BASIC, demote, vs_all).astype(jnp.int32)
        vstat = vstat.at[n:].set(st.BASIC)
        x0 = _nonbasic_values(vstat[:n], lb, ub)
        r0 = b - A.matvec(x0)
        sign = jnp.where(r0 >= 0, 1.0, -1.0).astype(A.dtype)
        return s._replace(
            basis=n + jnp.arange(m, dtype=jnp.int32),
            vstat=vstat,
            xB=jnp.abs(r0),
            Binv=jnp.diag(sign),
            pi=sign,
            art_sign=sign,
            phase=jnp.int32(1),
            since_refactor=jnp.int32(0),
            degen_count=jnp.int32(0),
            bland=jnp.bool_(True),
            repairs=s.repairs + 1,
            status=jnp.where(
                s.repairs + 1 > 3, st.NUMERICAL, s.status
            ).astype(jnp.int32),
            w=jnp.ones(n, A.dtype),
            **eta0,
        )

    # ---- block product-form fold (cfg.inverse == "eta") ----
    # The pending block is kept composed: B⁻¹_cur = (I + Z·Pᵀ)·Binv, so the
    # fold is one (m,T)@(T,m) matmul — B⁻¹'s memory traffic paid
    # once per eta_block pivots instead of every pivot (the reference folds
    # at refactorization only because its updates stay as a sequential eta
    # file, lower_upper/mod.rs:157-230).
    def fold_etas(s: State) -> State:
        Binv = s.Binv + s.etaZ @ jnp.take(s.Binv, s.etaR, axis=0)
        return s._replace(
            Binv=Binv,
            etaZ=jnp.zeros_like(s.etaZ),
            etaR=jnp.zeros_like(s.etaR),
            eta_count=jnp.int32(0),
        )

    # ---- refactorization ----
    def refactor(s: State) -> State:
        is_art = s.basis >= n
        struct_cols = A.cols_matrix(jnp.clip(s.basis, 0, n - 1))  # (m, m)
        k = jnp.clip(s.basis - n, 0, m - 1)
        art_cols = (jnp.arange(m)[:, None] == k[None, :]) * s.art_sign[k][None, :]
        B = jnp.where(is_art[None, :], art_cols, struct_cols)

        def rebuild_full(_):
            if cfg.newton_refactor:
                return robust_inverse(B)
            return gauss_jordan_inverse(B)

        if cfg.refactor_mode == "polish":
            # One Newton-Schulz step on the maintained inverse (pending
            # etas folded in) against the clean basis columns: X₁ =
            # X(2I − BX).  Quadratic convergence kills the accumulated
            # rank-1/eta drift; a residual check routes genuinely bad
            # states (singular basis, placeholder warm inverse) to the
            # full rebuild.
            X = s.Binv
            if use_eta:
                X = X + s.etaZ @ jnp.take(X, s.etaR, axis=0)
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
            healthy = jnp.bool_(False)
            Binv, min_piv = rebuild_full(None)
        # the Newton rebuild reports an infinite pivot, Gauss-Jordan its
        # smallest one
        path = jnp.where(healthy, 0, jnp.where(jnp.isinf(min_piv), 1, 2))
        s = s._replace(refactors=s.refactors.at[path].add(1))

        def rebuild(s: State) -> State:
            nb = _nonbasic_values(s.vstat, lb_tot, ub_tot_p2)
            nb = jnp.where(s.vstat == st.BASIC, 0.0, nb)
            r = b - A.matvec(nb[:n])  # nonbasic artificials sit at 0
            xB = Binv @ r
            phase1_here = s.phase == 1
            c_eff_here = jnp.where(phase1_here, jnp.zeros_like(c), c)
            cB = jnp.where(
                s.basis >= n,
                jnp.where(phase1_here, 1.0, 0.0),
                jnp.take(c_eff_here, jnp.clip(s.basis, 0, n - 1)),
            )
            pi = cB @ Binv
            # snap residual artificial levels (≤ eps_feas) to exactly 0 so
            # the phase-2 pinned bounds don't force micro ratio steps
            xB = jnp.where(is_art & (jnp.abs(xB) <= cfg.eps_feas), 0.0, xB)
            # devex reference-framework reset once weights have grown large
            w = jnp.where(jnp.max(s.w) > 1e6, jnp.ones_like(s.w), s.w)
            return s._replace(
                Binv=Binv, xB=xB, pi=pi, w=w, since_refactor=jnp.int32(0),
                **eta0,
            )

        # NaN-safe routing: a NaN pivot estimate (Inf/NaN arithmetic in the
        # f32 LU seed on a pathological crossover basis) must route to
        # repair, not rebuild with a garbage inverse (`NaN < tol` is False)
        return lax.cond(
            ~(min_piv >= cfg.singular_tol), repair, rebuild, s
        )

    # ---- loop body ----
    def body(s: State) -> State:
        # Numerical watchdog: a non-finite basic solution means the inverse
        # has degraded (the exact-arithmetic reference can't hit this).  A
        # refactorization rebuilds from clean problem columns; if the state
        # is broken immediately after one, give up with NUMERICAL.
        # Non-finite state OR magnitude blow-up: huge-but-finite
        # intermediates (near-singular inverse entries squared in the
        # rank-1 update) are on their way to overflow — refactor well
        # before that.
        # Blow-up only counts on a stale inverse: a freshly refactorized
        # ill-conditioned basis already routes through the Gauss-Jordan
        # minimal-pivot check into repair.
        binv_mag = jnp.max(jnp.abs(s.Binv))
        if use_eta:
            binv_mag = jnp.maximum(binv_mag, jnp.max(jnp.abs(s.etaZ)))
        state_sum = jnp.sum(s.xB) + jnp.sum(s.pi)
        broken = (
            ~jnp.isfinite(state_sum)
            | ~jnp.isfinite(binv_mag)
            | ((binv_mag > 1e14) & (s.since_refactor > 0))
        )
        s = s._replace(
            status=jnp.where(
                broken & (s.since_refactor == 0), st.NUMERICAL, s.status
            ).astype(jnp.int32),
            since_refactor=jnp.where(
                broken, cfg.refactor_period, s.since_refactor
            ).astype(jnp.int32),
        )

        if not external:
            s = lax.cond(
                s.since_refactor >= cfg.refactor_period, refactor,
                lambda s: s, s,
            )
        # external: cond exits the loop instead; the host runs the
        # refactorization as separate bounded programs and re-enters
        if use_eta:
            # fold the pending eta block once it is full (must run before a
            # pivot could need slot T; a refactorization above resets it)
            s = lax.cond(s.eta_count >= T, fold_etas, lambda s: s, s)

        # phase transition: artificial mass numerically zero => real costs.
        # Evaluated AFTER the refactorization branch and only on a fresh
        # state: warm starts carry a placeholder xB until their first
        # refactorization, and a drifted xB must not decide the phase.  The
        # switch invalidates the (phase-1) duals, so the transition forces a
        # refactorization and this iteration performs no pivot.
        transition = (
            (s.phase == 1)
            & (s.since_refactor == 0)
            & (art_mass(s) <= cfg.eps_feas)
        )
        s = s._replace(
            phase=jnp.where(transition, 2, s.phase).astype(jnp.int32),
            since_refactor=jnp.where(
                transition, cfg.refactor_period, s.since_refactor
            ).astype(jnp.int32),
        )

        phase1 = s.phase == 1
        # effective costs: phase 1 prices the artificial-mass objective
        c_eff = jnp.where(phase1, jnp.zeros_like(c), c)

        # ---- pricing: one fused matvec over the whole column pool (or one
        # block of it under partial pricing), against the incrementally-
        # maintained duals ----
        pi = s.pi
        vs = s.vstat[:n]

        def pick(d, vs_, can_, w_, ids_):
            """Best entering candidate of a (sub)pool; returns (local, has)."""
            imp_l = ((vs_ == st.NB_LOWER) | (vs_ == st.NB_FREE)) & (d < -cfg.eps_dual)
            imp_u = ((vs_ == st.NB_UPPER) | (vs_ == st.NB_FREE)) & (d > cfg.eps_dual)
            viol = jnp.where(imp_l, -d, 0.0) + jnp.where(imp_u, d, 0.0)
            viol = jnp.where(can_ & (vs_ != st.BASIC), viol, 0.0)
            if cfg.pricing == "devex":
                # devex: maximize d_j² / w_j (approximate steepest edge)
                score = viol * viol / w_
            else:
                score = viol
            j_best = jnp.argmax(score)
            # ids_ ascending ⇒ argmin of the masked ids is the local index
            # of the smallest improving column id (Bland)
            j_bland = jnp.argmin(jnp.where(viol > 0, ids_, n))
            j = jnp.where(s.bland, j_bland, j_best).astype(jnp.int32)
            return j, viol[j] > 0

        def select_entering(d):
            return pick(d, vs, can_enter, s.w, col_ids)

        def confirm64(qc, has_c):
            """f64 confirmation of a f32-chosen candidate's reduced cost."""
            d_q64 = c_eff[qc] - A.col_dot(pi, qc)
            ok = has_c & (
                jnp.where(
                    (vs[qc] == st.NB_UPPER), d_q64 > cfg.eps_dual, d_q64 < -cfg.eps_dual
                )
                | ((vs[qc] == st.NB_FREE) & (jnp.abs(d_q64) > cfg.eps_dual))
            )
            return d_q64, ok

        def price_f64(_):
            d = c_eff - A.rmatvec(pi)
            q, has = select_entering(d)
            return q, has, d[q]

        def price_full_mixed(_):
            # scan the pool in f32 (half the bytes of f64; a GPU may run
            # the dense product in TF32, acceptable for a proposal),
            # confirm only the chosen column's reduced cost in f64, and fall
            # back to a full f64 pricing pass when the f32 scan finds nothing
            # or its candidate fails confirmation (rare: near optimality).
            # Exact termination semantics are preserved — OPTIMAL is only
            # ever declared off the f64 path.
            d32 = (
                c_eff.astype(jnp.float32) - A.rmatvec32(pi.astype(jnp.float32))
            ).astype(f)
            q32, has32 = select_entering(d32)
            d_q64, confirmed = confirm64(q32, has32)
            return lax.cond(
                confirmed,
                lambda _: (q32, jnp.bool_(True), d_q64),
                price_f64,
                None,
            )

        use_blocks = (
            cfg.price_blocks > 1 and cfg.mixed_pricing and n % cfg.price_blocks == 0
        )
        if use_blocks:
            # Block-cyclic partial pricing: price only the current block's
            # columns this iteration; fall back to the full pass when the
            # block offers no (f64-confirmed) candidate.
            bsize = n // cfg.price_blocks
            bstart = s.pblock * bsize
            c_eff_b = lax.dynamic_slice(c_eff, (bstart,), (bsize,))
            d32b = (
                c_eff_b.astype(jnp.float32)
                - A.rmatvec32_block(pi.astype(jnp.float32), bstart, bsize)
            ).astype(f)
            vs_b = lax.dynamic_slice(vs, (bstart,), (bsize,))
            can_b = lax.dynamic_slice(can_enter, (bstart,), (bsize,))
            w_b = lax.dynamic_slice(s.w, (bstart,), (bsize,))
            ids_b = bstart + jnp.arange(bsize)
            jb, has_b = pick(d32b, vs_b, can_b, w_b, ids_b)
            qb = (bstart + jb).astype(jnp.int32)
            d_qb, confirmed_b = confirm64(qb, has_b)
            q, has_entering, d_q = lax.cond(
                confirmed_b,
                lambda _: (qb, jnp.bool_(True), d_qb),
                price_full_mixed,
                None,
            )
        elif cfg.mixed_pricing:
            q, has_entering, d_q = price_full_mixed(None)
        else:
            q, has_entering, d_q = price_f64(None)

        # ---- straight-line iteration ----
        # Terminal/unbounded statuses and the flip-vs-pivot update are all
        # computed unconditionally and merged with selects: in the
        # sequential hot loop a few redundant vector ops are cheaper than
        # lax.cond dispatch (the only remaining branch is the rare
        # refactorization above).
        t = jnp.where(
            vs[q] == st.NB_UPPER,
            -1.0,
            jnp.where(vs[q] == st.NB_FREE, -jnp.sign(d_q), 1.0),
        )
        u = A.ftran(s.Binv, q)  # B⁻¹ a_q
        if use_eta:
            # current inverse = (I + Z·Pᵀ)·Binv → u += Z·u[etaR]
            u = u + s.etaZ @ jnp.take(u, s.etaR)
        ut = t * u

        k = s.basis
        is_art_k = k >= n
        lbk = jnp.take(lb_tot, k)
        ubk = jnp.take(ub_tot_p2, k)
        ubk = jnp.where(is_art_k & phase1, INF, ubk)  # artificials free upward in phase 1

        # Harris two-pass ratio test: pass 1 finds the largest step that
        # violates no basic bound by more than δ; pass 2 picks the
        # largest-|pivot| row whose strict ratio fits within it.  This is
        # the float-world replacement for the reference's exact ratio
        # test with Bland tie-break (tableau/mod.rs:221-247): with exact
        # arithmetic any minimal-ratio pivot is safe; with f64, choosing
        # a large pivot among near-ties is what keeps B⁻¹ well-behaved.
        delta = cfg.harris_delta
        pos = ut > cfg.eps_pivot
        neg = ut < -cfg.eps_pivot
        strict = jnp.where(
            pos,
            (s.xB - lbk) / ut,
            jnp.where(neg, (s.xB - ubk) / ut, INF),
        )
        strict = jnp.maximum(strict, 0.0)
        relaxed = jnp.where(
            pos,
            (s.xB - lbk + delta) / ut,
            jnp.where(neg, (s.xB - ubk - delta) / ut, INF),
        )
        relaxed = jnp.maximum(relaxed, 0.0)
        theta_max = jnp.min(relaxed)
        bound_range = ub[q] - lb[q]
        start_val = jnp.where(
            vs[q] == st.NB_UPPER, ub[q], jnp.where(vs[q] == st.NB_LOWER, lb[q], 0.0)
        )

        # pass 2: leaving-row choice
        elig = strict <= theta_max
        r_stab = jnp.argmax(jnp.where(elig, jnp.abs(ut), -1.0))
        # Bland mode: smallest basis index among minimal-ratio rows, but
        # never on a pivot that is relatively tiny — strict Bland ignores
        # magnitude, which is exactly what breeds singular bases in f64.
        elig_b = strict <= jnp.min(strict) + cfg.eps_ratio
        max_piv_b = jnp.max(jnp.where(elig_b, jnp.abs(ut), 0.0))
        elig_b = elig_b & (jnp.abs(ut) >= 0.01 * max_piv_b)
        r_bland = jnp.argmin(jnp.where(elig_b, k, n + m))

        r = jnp.where(s.bland, r_bland, r_stab).astype(jnp.int32)
        theta_piv = strict[r]
        theta = jnp.minimum(theta_piv, bound_range)
        can_step = jnp.isfinite(theta)
        flip = bound_range < theta_piv

        do_update = has_entering & can_step & ~transition
        is_pivot = do_update & ~flip
        is_flip = do_update & flip
        theta_safe = jnp.where(can_step, theta, 0.0)

        # candidate updates (computed unconditionally, selected below)
        xB_moved = s.xB - theta_safe * ut
        xB_piv = xB_moved.at[r].set(start_val + t * theta_safe)
        p = u[r]
        p_safe = jnp.where(jnp.abs(p) > 0, p, 1.0)
        if use_eta:
            # row r of the CURRENT inverse (Binv + pending etas)
            cur_row_r = s.Binv[r] + s.etaZ[r] @ jnp.take(s.Binv, s.etaR, axis=0)
        else:
            cur_row_r = s.Binv[r]
        w = cur_row_r / p_safe
        if use_eta:
            # push the new eta z = (e_r − u)/p in composed form:
            #   E_new·(I + Z·Pᵀ) = I + (Z + z⊗Z[r,:])·Pᵀ + z·e_rᵀ
            z = (-u / p_safe).at[r].add(1.0 / p_safe)
            Zc = s.etaZ + z[:, None] * s.etaZ[r][None, :]
            Zc = Zc.at[:, s.eta_count].set(z)
        else:
            Binv_piv = (s.Binv - u[:, None] * w[None, :]).at[r].set(w)

        kr = k[r]
        leave_stat = jnp.where(
            jnp.take(lb_tot, kr) == jnp.take(ub_tot_p2, kr),
            st.NB_FIXED,
            jnp.where(ut[r] > 0, st.NB_LOWER, st.NB_UPPER),
        )
        flip_stat = jnp.where(vs[q] == st.NB_LOWER, st.NB_UPPER, st.NB_LOWER)
        new_kr_stat = jnp.where(is_pivot, leave_stat, s.vstat[kr])
        new_q_stat = jnp.where(
            is_pivot, st.BASIC, jnp.where(is_flip, flip_stat, s.vstat[q])
        )
        vstat_new = (
            s.vstat.at[kr].set(new_kr_stat.astype(jnp.int32))
            .at[q].set(new_q_stat.astype(jnp.int32))
        )

        xB_new = jnp.where(is_pivot, xB_piv, jnp.where(is_flip, xB_moved, s.xB))
        if use_eta:
            Binv_new = s.Binv
            etaZ_new = jnp.where(is_pivot, Zc, s.etaZ)
            etaR_new = jnp.where(is_pivot, s.etaR.at[s.eta_count].set(r), s.etaR)
            eta_count_new = s.eta_count + is_pivot.astype(jnp.int32)
        else:
            Binv_new = jnp.where(is_pivot, Binv_piv, s.Binv)
            etaZ_new, etaR_new, eta_count_new = s.etaZ, s.etaR, s.eta_count
        basis_new = jnp.where(is_pivot, s.basis.at[r].set(q), s.basis)
        pi_new = jnp.where(is_pivot, s.pi + d_q * w, s.pi)

        if cfg.pricing == "devex":
            # devex reference-weight update (Harris 1973): with pivot row
            # α = (B⁻¹A)[r,:] (f32, TF32 acceptable — weights are
            # heuristic) and α_q = u_r,
            #   w_j ← max(w_j, (α_j/α_q)² w_q)   for nonbasic j
            #   w_leaving ← max(w_q/α_q², 1)
            # All intermediates are clamped well below ~1e38, the f32
            # range of the pricing shadow.
            alpha = A.rmatvec32(cur_row_r.astype(jnp.float32)).astype(f)
            inv_p = 1.0 / jnp.where(jnp.abs(p) > 1e-12, p, 1.0)
            ratio2 = jnp.minimum((alpha * inv_p) ** 2, 1e8)
            wq = jnp.minimum(s.w[q], 1e8)
            cand = jnp.minimum(ratio2 * wq, 1e8)
            w_upd = jnp.maximum(s.w, cand)
            w_upd = w_upd.at[q].set(1.0)
            kr_in_n = jnp.minimum(kr, n - 1)
            w_upd = jnp.where(
                jnp.arange(n) == kr_in_n,
                jnp.where(kr < n, jnp.clip(wq * inv_p * inv_p, 1.0, 1e8), w_upd),
                w_upd,
            )
            w_new = jnp.where(is_pivot, w_upd, s.w)
        else:
            w_new = s.w

        degen = do_update & (theta_safe <= cfg.eps_zero)
        degen_count = jnp.where(
            degen, s.degen_count + 1, jnp.where(do_update, 0, s.degen_count)
        ).astype(jnp.int32)
        # Bland's rule engages after a run of degenerate pivots and
        # disengages as soon as a real step is taken again.
        bland_new = jnp.where(
            do_update,
            jnp.where(degen, s.bland | (degen_count >= cfg.bland_trigger), False),
            s.bland,
        )
        if cfg.pricing == "bland":
            bland_new = jnp.bool_(True)

        # status resolution: no improving column → optimal/infeasible;
        # improving but no finite step → unbounded (phase 2) or degraded
        # inverse (phase 1, whose objective is bounded below).
        # Terminal decisions are only trusted when the inverse and duals are
        # FRESH (since_refactor == 0): with incrementally-maintained π/B⁻¹ a
        # drifted state may misprice; instead of terminating we force a
        # refactorization and let the next iteration re-decide exactly.
        fresh = s.since_refactor == 0
        wants_terminal = (~has_entering) | (has_entering & ~can_step)
        # phase-2 optimality additionally requires the artificials to sit at
        # (numerically) zero — a stuck positive artificial means the point
        # does not satisfy the original constraints
        art_ok = art_mass(s) <= 10 * cfg.eps_feas
        # ... and the basic variables to sit within their bounds.  A WARM
        # basis can be reduced-cost optimal yet primal infeasible (e.g. a
        # B&B child start after a bound tightening cut below the parent's
        # basic value): art_mass is 0, the phase jumps to 2, and without
        # this check the loop would declare OPTIMAL at an out-of-bounds
        # point.  Such terminals route to repair() — the artificial
        # phase-1 restart — which then proves optimality or infeasibility
        # properly (phase 1 excludes basic artificials: their positive
        # level IS the phase-1 objective).
        xb_viol = jnp.maximum(
            jnp.take(lb_tot, s.basis) - s.xB,
            s.xB - jnp.take(ub_tot_p2, s.basis),
        )
        xb_ok = jnp.max(
            jnp.where(phase1 & (s.basis >= n), 0.0, xb_viol)
        ) <= 1e3 * cfg.eps_feas
        terminal_status = jnp.where(
            phase1,
            st.INFEASIBLE,
            jnp.where(art_ok, st.OPTIMAL, st.NUMERICAL),
        )
        unb_status = jnp.where(phase1, st.NUMERICAL, st.UNBOUNDED)
        status_new = jnp.where(
            ~has_entering,
            terminal_status,
            jnp.where(~can_step, unb_status, s.status),
        )
        status_new = jnp.where(fresh & ~transition, status_new, s.status)
        # a broken (non-finite) state must not masquerade as priced-out
        # optimality/infeasibility — stay RUNNING so the watchdog repairs it
        status_new = jnp.where(broken, s.status, status_new)
        status_new = jnp.where(s.status != st.RUNNING, s.status, status_new)
        # bound-violating phase-2 terminal: suppress the status and repair
        needs_repair = (
            wants_terminal & fresh & ~transition & ~broken & ~phase1
            & ~xb_ok & (s.status == st.RUNNING)
        )
        status_new = jnp.where(needs_repair, s.status, status_new)

        # ---- periodic in-loop invariant check (cfg.check_every_n) ----
        # Samples the cheap BFS invariants — row residual of the current
        # point and basic-bound violation — the float analogue of the
        # reference's every-debug-iteration check (tableau/mod.rs:253-289).
        if cfg.check_every_n:
            def compute_viol(_):
                nbv = _nonbasic_values(s.vstat, lb_tot, ub_tot_p2)
                nbv = jnp.where(s.vstat == st.BASIC, 0.0, nbv)
                xx = jnp.zeros(n + 1, f).at[:n].set(nbv[:n])
                tgt = jnp.where(s.basis < n, s.basis, n)
                xx = xx.at[tgt].set(jnp.where(s.basis < n, s.xB, 0.0))
                kk = jnp.clip(s.basis - n, 0, m - 1)
                artc = jnp.zeros(m, f).at[kk].add(
                    jnp.where(s.basis >= n, jnp.take(s.art_sign, kk) * s.xB, 0.0)
                )
                row_res = jnp.max(jnp.abs(A.matvec(xx[:n]) + artc - b))
                lbv = jnp.take(lb_tot, s.basis)
                ubv = jnp.take(ub_tot_p2, s.basis)
                ubv = jnp.where((s.basis >= n) & phase1, INF, ubv)
                bviol = jnp.max(
                    jnp.maximum(jnp.maximum(lbv - s.xB, s.xB - ubv), 0.0)
                )
                return jnp.maximum(row_res, bviol)

            fire = (s.it % cfg.check_every_n) == 0
            v = lax.cond(fire, compute_viol, lambda _: jnp.zeros((), f), None)
            viol_new = jnp.maximum(s.viol, v)
        else:
            viol_new = s.viol

        # ---- per-iteration metric stream (cfg.trace_iters) ----
        if cfg.trace_iters:
            cBxB = jnp.where(
                s.basis >= n, 0.0, jnp.take(c, jnp.clip(s.basis, 0, n - 1))
            ) @ s.xB
            events = (
                is_pivot.astype(jnp.float32)
                + 2.0 * is_flip.astype(jnp.float32)
                + 4.0 * (s.since_refactor == 0).astype(jnp.float32)
                + 8.0 * s.bland.astype(jnp.float32)
            )
            row = jnp.stack(
                [
                    s.phase.astype(jnp.float32),
                    cBxB.astype(jnp.float32),
                    art_mass(s).astype(jnp.float32),
                    d_q.astype(jnp.float32),
                    theta_safe.astype(jnp.float32),
                    events,
                    q.astype(jnp.float32),
                    r.astype(jnp.float32),
                ]
            )
            trace_new = s.trace.at[jnp.minimum(s.it, trace_cap - 1)].set(row)
        else:
            trace_new = s.trace

        s_out = s._replace(
            status=status_new.astype(jnp.int32),
            xB=xB_new,
            Binv=Binv_new,
            etaZ=etaZ_new,
            etaR=etaR_new,
            eta_count=eta_count_new,
            trace=trace_new,
            viol=viol_new,
            pblock=(
                (s.pblock + 1) % cfg.price_blocks if use_blocks else s.pblock
            ),
            basis=basis_new,
            pi=pi_new,
            w=w_new,
            vstat=vstat_new,
            degen_count=degen_count,
            bland=bland_new,
            since_refactor=jnp.where(
                wants_terminal & ~fresh & ~broken & ~transition,
                cfg.refactor_period,
                s.since_refactor + is_pivot.astype(jnp.int32),
            ).astype(jnp.int32),
            it=s.it + 1,
        )
        # infeasible-warm-basis terminal (see xb_ok): restart via repair()
        # — fires at most once per bad warm start, like the refactor cond
        return lax.cond(needs_repair, repair, lambda t: t, s_out)

    def cond(s: State):
        running = (s.status == st.RUNNING) & (s.it < max_iter)
        if external:
            running &= s.since_refactor < cfg.refactor_period
        return running

    from types import SimpleNamespace

    return SimpleNamespace(
        body=body, cond=cond, refactor=refactor, repair=repair,
        art_mass=art_mass, eta0=eta0, obs0=obs0, T=T,
        trace_cap=trace_cap, lb_tot=lb_tot, ub_tot_p2=ub_tot_p2,
    )


@functools.partial(jax.jit, static_argnames=("cfg", "nested"))
def solve_core(
    A, b, c, lb, ub, cfg: SolverConfig, max_iter: int, basis0=None, vstat0=None,
    slack_of_row=None, art_sign0=None, phase0=None, nested: bool = False,
) -> SolveOutput:
    """Solve  min c@x  s.t.  A@x == b, lb <= x <= ub  (all float64, padded).

    Padded columns must have lb == ub == 0 and c == 0; padded rows must be
    zero in ``A`` with ``b == 0`` (their artificials stay basic at level 0).

    Warm start (the reference's ``FullInitialBasis``/``IM::from_basis`` path,
    two_phase/mod.rs:82-113, carry/mod.rs:428-463): pass ``basis0`` (i32[m],
    structural column indices) and ``vstat0`` (i32[n] statuses).  The basis
    inverse is refactorized from the given columns; a singular warm basis
    falls back to a phase-1 repair automatically.
    """
    A = as_amatrix(A)  # DenseMatrix or EllMatrix (trace-time dispatch — the
    #                    analogue of the reference's MatrixProvider static
    #                    dispatch, matrix_provider/mod.rs:37-136)
    m, n = A.shape
    f = A.dtype

    # Bounds over the virtual [structural+slack | artificial] column pool.
    need_a32 = cfg.mixed_pricing or cfg.pricing == "devex"
    if need_a32:
        A = A.with_f32()

    # ``nested=True`` restructures the solve for vmap: a ``lax.cond`` with a
    # batched predicate lowers to a select that executes BOTH branches, so
    # the in-loop refactorization cond makes every vmapped iteration pay the
    # full O(m³) rebuild (measured 52 ms/iter on a (17,216,384) fleet vs
    # ~1 ms for the straight-line body).  The nested form hoists it: an
    # outer loop refactorizes unconditionally (one batched inversion per
    # refactor period), the inner loop runs the external-form body, which
    # exits whenever a refactorization is pending.
    K = _make_primal_kernel(A, b, c, lb, ub, cfg, max_iter, external=nested)
    lb_tot, ub_tot_p2 = K.lb_tot, K.ub_tot_p2
    trace_cap = K.trace_cap
    eta0, obs0 = K.eta0, K.obs0
    art_mass, refactor = K.art_mass, K.refactor
    cond, body = K.cond, K.body

    if basis0 is None:
        # ---- cold start: all-artificial basis (reference `Fully` kind) ----
        finite_lb = jnp.isfinite(lb)
        finite_ub = jnp.isfinite(ub)
        vstat0_n = jnp.where(
            lb == ub,
            st.NB_FIXED,
            jnp.where(finite_lb, st.NB_LOWER, jnp.where(finite_ub, st.NB_UPPER, st.NB_FREE)),
        )
        vstat_full = jnp.concatenate(
            [vstat0_n, jnp.full(m, st.BASIC, jnp.int32)]
        ).astype(jnp.int32)
        x0 = _nonbasic_values(vstat_full[:n], lb, ub)
        r0 = b - A.matvec(x0)
        art_sign = jnp.where(r0 >= 0, 1.0, -1.0).astype(f)

        if slack_of_row is not None:
            # ---- slack crash: use each row's slack column as the initial
            # basic variable where that yields a feasible value (reference
            # `PartialInitialBasis` specialization, matrix_data.rs:432 /
            # phase_one.rs:66-102) — phase 1 then only owns the rows whose
            # slack start would violate its bounds ----
            rows_i = jnp.arange(m)
            has_slack = slack_of_row >= 0
            scj = jnp.clip(slack_of_row, 0, n - 1)
            coeff = A.entries(rows_i, scj)
            ok_coeff = jnp.abs(coeff) > 1e-12
            # exclude the slack's own nonbasic contribution from the residual
            r_excl = r0 + jnp.where(has_slack, coeff * x0[scj], 0.0)
            s_val = r_excl / jnp.where(ok_coeff, coeff, 1.0)
            feas = (
                has_slack
                & ok_coeff
                & (s_val >= jnp.take(lb, scj))
                & (s_val <= jnp.take(ub, scj))
            )
            basis_init = jnp.where(feas, scj, n + rows_i).astype(jnp.int32)
            # mark crashed-in slacks basic (artificial slots are already)
            vstat_full = vstat_full.at[basis_init].set(st.BASIC)
            xB0 = jnp.where(feas, s_val, jnp.abs(r0))
            art_sign = jnp.where(feas, 1.0, art_sign).astype(f)
            Binv0 = jnp.diag(jnp.where(feas, 1.0 / jnp.where(ok_coeff, coeff, 1.0), art_sign))
            # phase-1 duals: cB has 1 on artificial rows, 0 on slack rows
            pi0 = jnp.where(feas, 0.0, art_sign)
        else:
            basis_init = n + jnp.arange(m, dtype=jnp.int32)
            xB0 = jnp.abs(r0)
            Binv0 = jnp.diag(art_sign)  # diag(±1) is its own inverse
            pi0 = art_sign  # (1,…,1)·diag(±1): phase-1 duals

        state0 = State(
            basis=basis_init,
            vstat=vstat_full,
            xB=xB0,
            Binv=Binv0,
            pi=pi0,
            art_sign=art_sign,
            phase=jnp.int32(1),
            status=jnp.int32(st.RUNNING),
            it=jnp.int32(0),
            since_refactor=jnp.int32(0),
            degen_count=jnp.int32(0),
            bland=jnp.bool_(cfg.pricing == "bland"),
            repairs=jnp.int32(0),
            w=jnp.ones(n, f),
            **eta0,
            **obs0,
        )
    else:
        # ---- warm start from a caller-provided basis (may include
        # artificial entries >= n, e.g. for equality rows a basis file
        # leaves uncovered) ----
        vstat_full = jnp.concatenate(
            [vstat0.astype(jnp.int32), jnp.full(m, st.NB_LOWER, jnp.int32)]
        )
        # artificial signs from the nonbasic-point residual so warm basic
        # artificials start at non-negative levels
        if art_sign0 is not None:
            art_sign_w = art_sign0.astype(f)
        else:
            x0w = _nonbasic_values(vstat_full[:n], lb, ub)
            x0w = jnp.where(vstat_full[:n] == st.BASIC, 0.0, x0w)
            r0w = b - A.matvec(x0w)
            art_sign_w = jnp.where(r0w >= 0, 1.0, -1.0).astype(f)
        state0 = State(
            basis=basis0.astype(jnp.int32),
            vstat=vstat_full,
            xB=jnp.zeros(m, f),
            Binv=jnp.eye(m, dtype=f),  # placeholder; refactor fires first
            pi=jnp.zeros(m, f),
            art_sign=art_sign_w,
            # resumed phase carries over (chunked continuation); fresh warm
            # starts begin in phase 1 and transition after their first
            # refactorization computes the true artificial mass
            phase=jnp.int32(1) if phase0 is None else phase0.astype(jnp.int32),
            status=jnp.int32(st.RUNNING),
            it=jnp.int32(0),
            since_refactor=jnp.int32(cfg.refactor_period),  # force refactor
            degen_count=jnp.int32(0),
            bland=jnp.bool_(cfg.pricing == "bland"),
            repairs=jnp.int32(0),
            w=jnp.ones(n, f),
            **eta0,
            **obs0,
        )

    if nested:
        def outer_cond(s: State):
            return (s.status == st.RUNNING) & (s.it < max_iter)

        def outer_body(s: State):
            # unconditional refactor (fresh inverse, derived xB/π), then
            # iterate until terminal, pending refactor, or out of budget.
            # ``it`` advances ≥1 per cycle (since_refactor=0 re-enters the
            # inner cond), so the outer loop terminates within max_iter
            # cycles; broken-after-fresh-refactor states go NUMERICAL in
            # the body's watchdog exactly as in the in-loop form.
            return lax.while_loop(cond, body, refactor(s))

        final = lax.while_loop(outer_cond, outer_body, state0)
    else:
        final = lax.while_loop(cond, body, state0)
    final = final._replace(
        status=jnp.where(
            final.status == st.RUNNING, st.ITERATION_LIMIT, final.status
        ).astype(jnp.int32)
    )
    # clean final refactor: crisp Binv and freshly-computed xB for extraction
    final = refactor(final)

    # one step of iterative refinement on the basic solution (SURVEY §2.1:
    # f64 + refinement replaces exact arithmetic):
    # xB += B⁻¹ (r − B xB) with B reconstructed from clean problem columns
    is_art_f = final.basis >= n
    k_f = jnp.clip(final.basis - n, 0, m - 1)
    B_f = jnp.where(
        is_art_f[None, :],
        (jnp.arange(m)[:, None] == k_f[None, :]) * final.art_sign[k_f][None, :],
        A.cols_matrix(jnp.clip(final.basis, 0, n - 1)),
    )
    nb_f = _nonbasic_values(final.vstat, lb_tot, ub_tot_p2)
    nb_f = jnp.where(final.vstat == st.BASIC, 0.0, nb_f)
    r_f = b - A.matvec(nb_f[:n])
    resid = r_f - B_f @ final.xB
    final = final._replace(xB=final.xB + final.Binv @ resid)

    # ---- extract the solution vector ----
    nb = _nonbasic_values(final.vstat, lb_tot, ub_tot_p2)
    nb = jnp.where(final.vstat == st.BASIC, 0.0, nb)
    x_pad = jnp.zeros(n + 1, f).at[:n].set(nb[:n])
    target = jnp.where(final.basis < n, final.basis, n)
    x_pad = x_pad.at[target].set(jnp.where(final.basis < n, final.xB, 0.0))
    x = x_pad[:n]

    cB2 = jnp.where(
        final.basis >= n, 0.0, jnp.take(c, jnp.clip(final.basis, 0, n - 1))
    )
    pi = cB2 @ final.Binv

    return SolveOutput(
        x=x,
        status=final.status,
        it=final.it,
        phase=final.phase,
        basis=final.basis,
        vstat=final.vstat,
        art_inf=art_mass(final),
        pi=pi,
        obj=c @ x,
        art_sign=final.art_sign,
        trace=final.trace,
        viol=final.viol,
        refactors=final.refactors,
    )


# ---------------------------------------------------------------------------
# Externally refactorized (XL) primal entry points — the dual engine's
# ``dual_xl_*`` pattern (simplex/dual.py) applied to the primal core.  The
# driver orchestrates:
#
#   rebuild/polish (dual_xl_* — basis-inverse programs are shared)
#        → primal_xl_derive → primal_xl_iterate ... (refactor pending) ─┐
#        ▲                                                              │
#        └──────────────────────────────────────────────────────────────┘
#
# Each program's HBM peak stays bounded; ``primal_xl_iterate`` donates the
# O(m²) inverse so chunked continuations never copy it.  The basis-repair
# branch stays IN the loop (it builds a diagonal inverse — no heavyweight
# inversion), so only the m³ refactorization work leaves the trace.
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnums=(5,))
def primal_xl_iterate(A, b, c, lb, ub, state: State, cfg: SolverConfig,
                      max_iter) -> State:
    """Run primal iterations until terminal, out of budget, or a
    refactorization is pending (``since_refactor >= cfg.refactor_period``).
    ``state`` must carry a FRESH inverse (host just refactorized)."""
    A = as_amatrix(A)
    if cfg.mixed_pricing or cfg.pricing == "devex":
        A = A.with_f32()
    K = _make_primal_kernel(A, b, c, lb, ub, cfg, max_iter, external=True)
    return lax.while_loop(K.cond, K.body, state)


@functools.partial(jax.jit, static_argnames=("cfg",))
def primal_xl_derive(A, b, c, lb, ub, basis, vstat, art_sign, phase, w,
                     Binv, cfg: SolverConfig):
    """Recompute (xB, π, w, art_mass) from a freshly refactorized inverse —
    the in-loop ``refactor``'s ``rebuild`` arithmetic as its own small
    program (phase-aware costs, artificial-level snapping, devex reset)."""
    A = as_amatrix(A)
    m, n = A.shape
    f = A.dtype
    lb_tot = jnp.concatenate([lb, jnp.zeros(m, f)])
    ub_tot = jnp.concatenate([ub, jnp.zeros(m, f)])
    basis = basis.astype(jnp.int32)
    nb = _nonbasic_values(vstat, lb_tot, ub_tot)
    nb = jnp.where(vstat == st.BASIC, 0.0, nb)
    r = b - A.matvec(nb[:n])
    xB = Binv @ r
    phase1 = phase == 1
    c_eff = jnp.where(phase1, jnp.zeros_like(c), c)
    cB = jnp.where(
        basis >= n,
        jnp.where(phase1, 1.0, 0.0),
        jnp.take(c_eff, jnp.clip(basis, 0, n - 1)),
    )
    pi = cB @ Binv
    is_art = basis >= n
    xB = jnp.where(is_art & (jnp.abs(xB) <= cfg.eps_feas), 0.0, xB)
    w = jnp.where(jnp.max(w) > 1e6, jnp.ones_like(w), w)
    art = jnp.sum(jnp.where(is_art, jnp.abs(xB), 0.0))
    return xB, pi, w, art
