"""Host driver: pad, dispatch to the jitted core, map results back.

Counterpart of the reference's ``SolveRelaxation::solve_relaxation``
entry point (``src/algorithm/mod.rs:20-39`` / ``two_phase/mod.rs:25-113``):
takes a computational form, runs the two-phase engine, and reconstructs a
named solution.  Shape padding buckets the jit cache (the analogue of the
reference's compile-time type-parameter specialization).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import jax
import numpy as np
import scipy.sparse as sp

from relp_tpu.model.computational_form import ComputationalForm
from relp_tpu.model.elements import LinearProgramType
from relp_tpu.model.general_form import GeneralForm
from relp_tpu.model.solution import Solution
from relp_tpu.simplex import status as st
from relp_tpu.simplex.core import solve_core
from relp_tpu.utils.config import DEFAULT_CONFIG, SolverConfig

INF = float("inf")
# above this many padded rows the crossover never densifies its candidate
# columns (lu_host.independent_crash is O(m·r) per candidate)
_DENSE_CRASH_MAX_M = 4096
# PDHG restart rounds per device call, single solve and fleet (PERF.md:
# the bring-up A/B on the H100)
_PDLP_ROUNDS = 256
_FLEET_PDLP_ROUNDS = 32


@dataclass
class SimplexResult:
    kind: LinearProgramType
    objective: Optional[float] = None
    x_structural: Optional[np.ndarray] = None  # original units, structural columns
    iterations: int = 0
    art_residual: float = 0.0
    metrics: Optional["SolveMetrics"] = None
    duals: Optional[np.ndarray] = None  # row duals in ORIGINAL row units
    trace: Optional[np.ndarray] = None  # (iters, 8) per-iteration stream
    #                                     (config.trace_iters; see core.State)
    check_violation: float = 0.0  # worst periodic-invariant violation
    # final basis state (padded cf space; None when the solve never reached
    # the device or the first-order engine returned no vertex) — consumed by
    # checkpointing, reoptimization, and analysis.ranging
    basis: Optional[np.ndarray] = None     # i32[m_pad] basis columns
    vstat: Optional[np.ndarray] = None     # i32[n_pad+m_pad] statuses
    art_sign: Optional[np.ndarray] = None  # f64[m_pad] artificial signs
    # fleet lanes only: the device engine could not certify this lane and
    # scipy's HiGHS solved it on the host instead
    host_fallback: bool = False

    @property
    def is_optimal(self) -> bool:
        return self.kind is LinearProgramType.FINITE_OPTIMUM


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult if x > 0 else mult


def _bucket(x: int, floor: int) -> int:
    """Geometric shape bucketing above ``floor``: sizes 1× and 1.5× each
    power of two (64, 96, 128, 192, 256, ...).

    Each distinct padded shape costs a full XLA compile, so problems share
    programs; the 1.5× steps
    cap padding waste at 33% (pure powers of two waste up to 2× — painful
    when the per-iteration cost is O(m²)).
    """
    if x > 8192:
        # Very large problems: geometric steps would waste up to 50% of an
        # O(m²)-per-iteration budget (STOCFOR3's m=16617 → 24576).  Problems
        # this big are rare enough that program-cache pressure is moot; pad
        # to the next 1024 multiple instead (≤6% waste).
        return _round_up(x, 1024)
    v = floor
    while v < x:
        k = v // floor
        if k & (k - 1) == 0:  # v = floor·2^j → next is 1.5×
            v = v * 3 // 2
        else:  # v = floor·3·2^(j-1) → next is 4/3×
            v = v * 4 // 3
    return v


def _device_matrix(cf: ComputationalForm, m_pad: int, n_pad: int, config: SolverConfig):
    """Choose and build the device representation of A (ops/amatrix.py).

    Dense keeps the round-1 fused-matvec path; ELL stores per-column nonzeros
    and replaces every O(m·n) access with O(nnz)-ish gathers — the scale
    unlock for DFL001/STOCFOR3-class instances.  "auto" picks ELL when the
    maximum per-column fill K is small relative to m (otherwise the gather
    arithmetic loses to one big dense matvec) and the problem is large enough
    that per-iteration dense FLOPs dominate dispatch overhead.
    """
    from relp_tpu.ops.amatrix import ell_from_csc, hybrid_from_csc

    csc = sp.csc_matrix(cf.A)
    fmt = config.matrix_format
    counts = np.diff(csc.indptr)
    k_true = int(counts.max()) if counts.size else 1
    # columns whose fill would blow up the ELL pad (FIT2P: three full
    # columns, kmax = m) spill into a small dense block instead
    spill_thresh = max(64, m_pad // 32)
    n_spill = int((counts > spill_thresh).sum()) if counts.size else 0
    if fmt == "auto":
        fmt = "ell" if (m_pad >= 1024 and k_true * 8 <= m_pad) else "dense"
    if fmt == "ell" and 0 < n_spill <= 64:
        fmt = "hybrid"
    if fmt == "hybrid":
        k_sparse = (
            int(counts[counts <= spill_thresh].max())
            if (counts <= spill_thresh).any() else 1
        )
        k_pad = _bucket(max(k_sparse, 1), 8)
        d_pad = _bucket(max(n_spill, 1), 8)
        return hybrid_from_csc(csc, m_pad, n_pad, k_pad, d_pad)
    if fmt == "ell":
        k_pad = _bucket(max(k_true, 1), 8)
        rcounts = np.diff(csc.tocsr().indptr)
        kr_pad = _bucket(max(int(rcounts.max()) if rcounts.size else 1, 1), 8)
        return ell_from_csc(csc, m_pad, n_pad, k_pad, kr_pad=kr_pad)
    A = np.zeros((m_pad, n_pad), dtype=np.float64)
    A[: cf.m, : cf.n] = csc.toarray()
    return A


def solve_computational_form(
    cf: ComputationalForm,
    config: SolverConfig = DEFAULT_CONFIG,
    warm_start_builder=None,
) -> SimplexResult:
    """``warm_start_builder(m_pad, n_pad) -> (basis0, vstat0)`` optionally
    provides an initial basis (reference ``FullInitialBasis`` path)."""
    m, n = cf.m, cf.n

    if np.any(cf.lb > cf.ub):
        return SimplexResult(kind=LinearProgramType.INFEASIBLE)

    if m == 0 or n == 0:
        return _solve_trivial(cf)

    if config.bucket_shapes:
        m_pad = _bucket(m, config.row_align * 8)
        n_pad = _bucket(n, config.col_align * 2)
    else:
        m_pad = _round_up(m, config.row_align)
        n_pad = _round_up(n, config.col_align)

    A = _device_matrix(cf, m_pad, n_pad, config)
    b = np.zeros(m_pad, dtype=np.float64)
    b[:m] = cf.b
    c = np.zeros(n_pad, dtype=np.float64)
    c[:n] = cf.c
    lb = np.zeros(n_pad, dtype=np.float64)
    ub = np.zeros(n_pad, dtype=np.float64)  # padded cols fixed at 0
    lb[:n] = cf.lb
    ub[:n] = cf.ub

    max_iter = config.resolve_max_iter(m, n)
    from relp_tpu.utils.metrics import SolveMetrics, Timer

    # mixed-precision pricing only pays once the pricing matvec is large;
    # for small buckets the extra select/cast/cond work outweighs it
    if config.mixed_pricing and m_pad * n_pad < 1 << 17:
        import dataclasses as _dc

        config = _dc.replace(config, mixed_pricing=False)

    def _host_art_sign(vstat0):
        """Artificial signs from the nonbasic-point residual, computed on
        host so every solve_core call shares ONE trace signature (the
        in-trace art_sign0-is-None branch would otherwise make cold starts
        and chunked continuations compile two distinct programs)."""
        at_lower = (vstat0 == st.NB_LOWER) | (vstat0 == st.NB_FIXED)
        at_upper = vstat0 == st.NB_UPPER
        x0 = np.where(at_lower, lb, np.where(at_upper, ub, 0.0))
        x0 = np.where(vstat0 == st.BASIC, 0.0, x0)
        r0 = b.copy()
        r0[:m] -= np.asarray(sp.csc_matrix(cf.A) @ x0[: cf.n])
        return np.where(r0 >= 0, 1.0, -1.0)

    warm_kwargs = {}
    if warm_start_builder is not None:
        basis0, vstat0 = warm_start_builder(m_pad, n_pad)
        vstat0 = np.asarray(vstat0, np.int32)
        warm_kwargs = dict(
            basis0=np.asarray(basis0, np.int32),
            vstat0=vstat0,
            art_sign0=_host_art_sign(vstat0),
            phase0=np.int32(1),
        )
    elif config.crash_basis and len(cf.slack_rows):
        # slack crash (reference PartialInitialBasis): slack column of each
        # row, -1 where none (equality/padded rows)
        slack_of_row = np.full(m_pad, -1, np.int32)
        slack_of_row[cf.slack_rows] = cf.n_structural + np.arange(
            len(cf.slack_rows), dtype=np.int32
        )
        warm_kwargs = dict(slack_of_row=slack_of_row)
    else:
        # Express the cold start through the warm-start signature so each
        # shape bucket compiles ONE trace (chunked continuation reuses it).
        # The warm
        # path recomputes artificial signs and refactorizes first, which
        # for the all-artificial basis reproduces the cold start exactly.
        vstat_cold = np.where(
            lb == ub,
            st.NB_FIXED,
            np.where(
                np.isfinite(lb),
                st.NB_LOWER,
                np.where(np.isfinite(ub), st.NB_UPPER, st.NB_FREE),
            ),
        ).astype(np.int32)
        warm_kwargs = dict(
            basis0=(n_pad + np.arange(m_pad, dtype=np.int32)),
            vstat0=vstat_cold,
            art_sign0=_host_art_sign(vstat_cold),
            phase0=np.int32(1),
        )

    # ---- multi-device column sharding (config.mesh_cols; VERDICT round-1
    # item 8: sharding as a solver feature, not a test fixture).  The same
    # solve_core program runs with the column pool placed over the mesh's
    # 'cols' axis; GSPMD inserts the pricing argmax/gather collectives. ----
    if config.mesh_cols not in (0, 1):
        from relp_tpu.parallel.sharded import maybe_shard

        A, b, c, lb, ub, _ = maybe_shard(
            config.mesh_cols, n_pad, A, b, c, lb, ub
        )
    else:
        # pin the column pool to the device ONCE: numpy-leaved jit args are
        # re-transferred on EVERY call, and the chunked-continuation loop
        # below re-invokes solve_core with the same A per chunk.  b/c/lb/ub
        # stay host numpy: they are tiny and host logic (_host_art_sign)
        # mutates them in place.
        A = jax.device_put(A)

    # Long solves run as bounded device calls continued via warm start;
    # each chunk ends with a refactorization, so the resume is exact
    # (basis, statuses, artificial signs), and the host sees progress
    # between calls.  Per-iteration cost grows ~m², so the chunk shrinks
    # with the row count.  Whether the chunking pays on a GPU is not
    # measured yet.
    chunk = max(1, int(config.device_chunk_iters))
    if m_pad > 1024:
        floor = 200 if m_pad > 12288 else 500
        chunk = max(floor, int(chunk * (1024.0 / m_pad) ** 2))
    total_done = 0
    traces = []
    worst_viol = 0.0
    refactors = np.zeros(3, np.int64)  # in-loop primal: polish/newton/GJ

    def _run_chunked(lb_run, ub_run, warm, t, budget, cfg=None):
        """Chunked warm-continued solve against one bound set; shares the
        single compiled program with every other call of this shape.
        Above ``config.refactor_external_m`` the same call transparently
        routes to the externally refactorized form (``_run_primal_xl``):
        on an H100 at m_pad 16384 a whole 2000-pivot window ran 177
        pivots/s against 39 for the in-loop form (PERF.md, bring-up).
        ``cfg`` optionally overrides the solve config (the crossover's
        restricted polish relaxes eps_feas)."""
        nonlocal total_done, worst_viol, refactors
        cfg = config if cfg is None else cfg
        if cfg.xl_engine == "primal" or m_pad > cfg.refactor_external_m:
            return _run_primal_xl(t, lb_run, ub_run, warm, budget, cfg=cfg)
        done_here = 0
        while True:
            this_chunk = min(chunk, budget - done_here)
            out = solve_core(
                A, b, c, lb_run, ub_run, cfg=cfg, max_iter=this_chunk, **warm
            )
            out = jax.block_until_ready(out)
            done_here += int(out.it)
            total_done += int(out.it)
            worst_viol = max(worst_viol, float(out.viol))
            refactors = refactors + np.asarray(out.refactors)
            if config.trace_iters:
                traces.append(np.asarray(out.trace)[: int(out.it)])
            from relp_tpu.utils.metrics import logger as _log

            if _log.isEnabledFor(10 + 10):  # INFO
                _log.info(
                    "chunk it=%d total=%d status=%d phase=%d art=%.3e "
                    "obj=%.9e wall=%.1fs",
                    int(out.it), total_done, int(out.status),
                    int(out.phase), float(out.art_inf), float(out.obj),
                    t.peek(),
                )
            if int(out.status) != st.ITERATION_LIMIT or done_here >= budget:
                return out
            warm = dict(
                basis0=np.asarray(out.basis, np.int32),
                vstat0=np.asarray(out.vstat, np.int32)[:n_pad],
                art_sign0=np.asarray(out.art_sign),
                phase0=np.asarray(out.phase, np.int32),
            )

    _a_pad_cache = []

    def _a_pad_csc():
        """Padded (m_pad × n_pad) scipy CSC of cf.A, built once."""
        if not _a_pad_cache:
            coo = sp.csc_matrix(cf.A).tocoo()
            _a_pad_cache.append(sp.csc_matrix(
                (coo.data, (coo.row, coo.col)), shape=(m_pad, n_pad)
            ))
        return _a_pad_cache[0]

    def _run_dual_lu_host(t, lb_d, ub_d, warm, repair=False, iter_cap=None,
                          cfg=None):
        """Host sparse-LU dual simplex (simplex/lu_host.py — the
        reference's Markowitz-LU counterpart; see that module's docstring
        for why this tier is host-native).  ``repair=True`` first places
        every nonbasic on the bound matching sign(d_j) at the given basis
        (temporary ±dual_box where that side is unbounded, verified
        inactive afterward) — makes arbitrary warm bases (PDLP crossover
        guesses, basis files) dual feasible.  Returns a SolveOutput-shaped
        namespace or None."""
        from relp_tpu.simplex.lu_host import reduced_costs, solve_dual_lu
        from relp_tpu.utils.metrics import logger as _log

        nonlocal total_done
        cfg = config if cfg is None else cfg
        A_pad = _a_pad_csc()
        basis0 = np.asarray(warm["basis0"], np.int64)
        vstat0 = np.asarray(warm["vstat0"], np.int32).copy()
        art_sign0 = np.asarray(warm["art_sign0"], np.float64)
        if len(vstat0) < n_pad + m_pad:
            vstat0 = np.concatenate([
                vstat0,
                np.full(n_pad + m_pad - len(vstat0), st.NB_LOWER, np.int32),
            ])
        vstat0[basis0] = st.BASIC
        boxM = float(cfg.dual_box)
        box_lo = np.zeros(n_pad, bool)
        box_hi = np.zeros(n_pad, bool)
        if repair:
            d0, _ = reduced_costs(A_pad, c, basis0, art_sign0, n_pad)
            if d0 is None:
                # singular guess (e.g. a crossover candidate set above the
                # rank): rebuild via the strict triangular crash over the
                # SAME candidates in priority order, artificials elsewhere
                from relp_tpu.simplex.lu_host import triangular_crash

                cand0 = basis0[basis0 < n_pad]
                basis0 = triangular_crash(A_pad, cand0, n_pad)
                vstat0 = vstat0.copy()
                vstat0[n_pad:] = st.NB_LOWER
                vstat0[basis0] = st.BASIC
                dropped = np.setdiff1d(cand0, basis0[basis0 < n_pad])
                vstat0[dropped] = np.where(
                    np.isfinite(lb_d[dropped]), st.NB_LOWER,
                    np.where(
                        np.isfinite(ub_d[dropped]), st.NB_UPPER, st.NB_FREE
                    ),
                ).astype(np.int32)
                d0, _ = reduced_costs(A_pad, c, basis0, art_sign0, n_pad)
                if d0 is None:
                    return None
            vs = vstat0[:n_pad]
            nb = (vs != st.BASIC) & (lb_d < ub_d)
            to_lo = nb & (d0 >= 0)
            to_hi = nb & (d0 < 0)
            box_lo = to_lo & ~np.isfinite(lb_d)
            box_hi = to_hi & ~np.isfinite(ub_d)
            lb_d = np.where(box_lo, -boxM, lb_d)
            ub_d = np.where(box_hi, boxM, ub_d)
            vs = np.where(to_lo, st.NB_LOWER, vs)
            vs = np.where(to_hi, st.NB_UPPER, vs)
            vstat0 = np.concatenate([vs.astype(np.int32), vstat0[n_pad:]])
        out = solve_dual_lu(
            A_pad, b, c, lb_d, ub_d, basis0, vstat0, art_sign0,
            cfg, max_iter if iter_cap is None else min(max_iter, iter_cap),
            n_pad=n_pad,
        )
        if out is None:
            return None
        total_done += int(out.it)
        if _log.isEnabledFor(20):
            _log.info(
                "dual-lu done status=%d it=%d pivots=%d flips=%d wall=%.1fs",
                int(out.status), int(out.it), out.pivots, out.bound_flips,
                t.peek(),
            )
        if int(out.status) != st.OPTIMAL:
            return None
        if repair:
            x = np.asarray(out.x)
            active = (box_lo & (x <= -0.5 * boxM)) | (box_hi & (x >= 0.5 * boxM))
            if bool(np.any(active)):
                _log.info("dual-lu: temporary box binds — not a certificate")
                return None
        return out

    def _run_dual_xl(t, lb_d, ub_d, warm):
        """Externally refactorized dual solve for XL problems (m_pad >
        config.refactor_external_m): the hot loop (dual_xl_iterate) exits
        whenever a refactorization is pending and the host runs it as
        separate bounded device programs (polish → rebuild fallback →
        derive).  Keeps every program's HBM peak small — the in-loop
        lax.cond refactor branch OOMs the compile at STOCFOR3 scale.
        Returns a SolveOutput-shaped namespace (host numpy), or None."""
        import jax.numpy as jnp

        from relp_tpu.simplex.dual import (
            dual_xl_derive,
            dual_xl_iterate,
            dual_xl_polish,
            dual_xl_rebuild,
            dual_xl_resid,
        )
        from relp_tpu.utils.metrics import logger as _log

        nonlocal total_done
        basis = jnp.asarray(warm["basis0"], jnp.int32)
        art_sign = jnp.asarray(np.asarray(warm["art_sign0"], np.float64))
        vstat = jnp.asarray(
            np.concatenate(
                [np.asarray(warm["vstat0"], np.int32),
                 np.full(m_pad, st.NB_LOWER, np.int32)]
            )
        )

        Binv, resid = dual_xl_rebuild(A, basis, art_sign, cfg=config)
        if not np.isfinite(float(resid)) or float(resid) > 1e-6:
            return None  # (near-)singular start
        xB, pi, d, beta = dual_xl_derive(A, b, c, lb_d, ub_d, basis, vstat, Binv)
        since = jnp.int32(0)
        flips = jnp.int32(0)
        done_here = 0
        stalled_cycles = 0
        status = st.ITERATION_LIMIT
        import time as _time

        while done_here < max_iter:
            this_chunk = min(chunk, max_iter - done_here)
            t_it = _time.perf_counter()
            s = dual_xl_iterate(
                A, b, c, lb_d, ub_d, basis, vstat, xB, Binv, pi, d, beta,
                since, flips, cfg=config, max_iter=this_chunk,
            )
            s = jax.block_until_ready(s)
            t_it = _time.perf_counter() - t_it
            it_here = int(s.it)
            done_here += it_here
            total_done += it_here
            basis, vstat, xB, Binv = s.basis, s.vstat, s.xB, s.Binv
            pi, d, beta, since, flips = s.pi, s.d, s.beta, s.since_refactor, s.flips
            status = int(s.status)
            if _log.isEnabledFor(20):
                # running objective + primal infeasibility, reconstructed
                # host-side from the chunk's final state (cheap: O(n+m))
                vs_np = np.asarray(s.vstat)
                ba_np = np.asarray(s.basis)
                xb_np = np.asarray(s.xB)
                lbt = np.concatenate([lb_d, np.zeros(m_pad)])
                ubt = np.concatenate([ub_d, np.zeros(m_pad)])
                nbv = np.where(
                    (vs_np == st.NB_LOWER) | (vs_np == st.NB_FIXED), lbt,
                    np.where(vs_np == st.NB_UPPER, ubt, 0.0),
                )
                nbv = np.where(vs_np == st.BASIC, 0.0, nbv)
                xv = nbv[:n_pad].copy()
                sm = ba_np < n_pad
                xv[ba_np[sm]] = xb_np[sm]
                lbk = lbt[ba_np]
                ubk = ubt[ba_np]
                pinf = float(
                    np.maximum(np.maximum(lbk - xb_np, xb_np - ubk), 0.0).sum()
                )
                _log.info(
                    "dual-xl chunk it=%d total=%d status=%d obj=%.9e "
                    "pinf=%.3e wall=%.1fs",
                    it_here, done_here, status, float(c @ xv), pinf, t.peek(),
                )
            if status != st.RUNNING:
                break
            if int(since) < config.refactor_period:
                continue  # chunk budget hit mid-period: keep iterating
            # external refactorization: probe-check first (8 m² matvecs) —
            # polish (two m³ f64 matmuls) only once the product-
            # form drift actually crosses the SAME 1e-9 health bar, then
            # full rebuild on a bad post-polish residual
            t_chk = _time.perf_counter()
            resid0 = dual_xl_resid(A, basis, art_sign, Binv)
            t_chk = _time.perf_counter() - t_chk
            t_pol = t_reb = 0.0
            if np.isfinite(float(resid0)) and float(resid0) < 1e-9:
                if _log.isEnabledFor(20):
                    _log.info(
                        "dual-xl refactor: inverse healthy (resid=%.2e) — "
                        "polish skipped", float(resid0),
                    )
            else:
                t_pol = _time.perf_counter()
                X1, resid = dual_xl_polish(A, basis, art_sign, Binv)
                t_pol = _time.perf_counter() - t_pol
                if np.isfinite(float(resid)) and float(resid) < 1e-9:
                    Binv = X1
                else:
                    del X1
                    t_reb = _time.perf_counter()
                    Binv, resid2 = dual_xl_rebuild(A, basis, art_sign, cfg=config)
                    t_reb = _time.perf_counter() - t_reb
                    if not np.isfinite(float(resid2)) or float(resid2) > 1e-6:
                        _log.warning(
                            "dual-xl: singular basis at refactorization "
                            "(resid=%s) — abandoning the dual path", float(resid2)
                        )
                        return None
            t_der = _time.perf_counter()
            xB, pi, d, beta = dual_xl_derive(
                A, b, c, lb_d, ub_d, basis, vstat, Binv
            )
            jax.block_until_ready(xB)
            t_der = _time.perf_counter() - t_der
            if _log.isEnabledFor(10):  # DEBUG: per-call cost decomposition
                _log.debug(
                    "dual-xl timings: iterate=%.2fs (%.0f ms/iter) "
                    "resid=%.2fs polish=%.2fs rebuild=%.2fs derive=%.2fs",
                    t_it, 1e3 * t_it / max(it_here, 1), t_chk, t_pol,
                    t_reb, t_der,
                )
            since = jnp.int32(0)
            # numerical-stall guard: a cycle that makes no pivots and still
            # wants a refactorization cannot make progress forever
            stalled_cycles = stalled_cycles + 1 if it_here <= 1 else 0
            if stalled_cycles >= 3:
                _log.warning("dual-xl: stalled refactorization cycles — stopping")
                return None
        if status == st.RUNNING:
            status = st.ITERATION_LIMIT

        # host-side finalization (the small arithmetic the in-loop form
        # does after its final refactorization)
        vstat_np = np.asarray(vstat)
        basis_np = np.asarray(basis)
        xB_np = np.asarray(xB)
        lb_tot = np.concatenate([lb_d, np.zeros(m_pad)])
        ub_tot = np.concatenate([ub_d, np.zeros(m_pad)])
        at_lower = (vstat_np == st.NB_LOWER) | (vstat_np == st.NB_FIXED)
        at_upper = vstat_np == st.NB_UPPER
        nb = np.where(at_lower, lb_tot, np.where(at_upper, ub_tot, 0.0))
        nb = np.where(vstat_np == st.BASIC, 0.0, nb)
        x = nb[:n_pad].copy()
        struct = basis_np < n_pad
        x[basis_np[struct]] = xB_np[struct]
        art_inf = float(np.abs(xB_np[~struct]).sum())

        from types import SimpleNamespace

        return SimpleNamespace(
            x=x,
            status=np.int32(status),
            it=np.int32(done_here),
            phase=np.int32(2),
            basis=basis_np,
            vstat=vstat_np,
            art_inf=np.float64(art_inf),
            pi=np.asarray(pi),
            obj=np.float64(c @ x),
            art_sign=np.asarray(art_sign),
            trace=np.zeros((0, 8), np.float32),
            viol=np.float64(0.0),
        )

    def _run_primal_xl(t, lb_run, ub_run, warm, budget, cfg=None):
        """Externally refactorized primal (VERDICT r3 item 4: the
        ``_PRIMAL_INLOOP_MAX_M`` cap removed): ``primal_xl_iterate`` exits
        whenever a refactorization is pending and the host runs it as
        separate bounded device programs — probe-check → polish → rebuild
        (the basis-inverse programs are SHARED with the dual XL engine) →
        ``primal_xl_derive`` — then re-enters.  Dense inverse only (the
        composed-eta fold needs the in-loop form); basis repair stays
        in-loop (it builds a diagonal inverse — no heavyweight inversion).
        Returns a SolveOutput-shaped namespace, same contract as
        ``_run_chunked``."""
        import dataclasses as _dc
        from types import SimpleNamespace

        import jax.numpy as jnp

        from relp_tpu.simplex.core import (
            State, primal_xl_derive, primal_xl_iterate,
        )
        from relp_tpu.simplex.dual import (
            dual_xl_polish, dual_xl_rebuild, dual_xl_resid,
        )
        from relp_tpu.utils.metrics import logger as _log

        nonlocal total_done
        cfg_xl = _dc.replace(
            config if cfg is None else cfg,
            inverse="dense", trace_iters=False,
        )
        if "basis0" not in warm:  # slack-crash dict: express as cold warm
            vstat_cold = np.where(
                lb_run == ub_run, st.NB_FIXED,
                np.where(
                    np.isfinite(lb_run), st.NB_LOWER,
                    np.where(np.isfinite(ub_run), st.NB_UPPER, st.NB_FREE),
                ),
            ).astype(np.int32)
            warm = dict(
                basis0=(n_pad + np.arange(m_pad, dtype=np.int32)),
                vstat0=vstat_cold,
                art_sign0=_host_art_sign(vstat_cold),
            )
        basis = jnp.asarray(warm["basis0"], jnp.int32)
        vstat = jnp.asarray(np.concatenate([
            np.asarray(warm["vstat0"], np.int32),
            np.full(m_pad, st.NB_LOWER, np.int32),
        ]))
        art_sign = jnp.asarray(np.asarray(warm["art_sign0"], np.float64))
        phase = jnp.int32(int(np.asarray(warm.get("phase0", 1))))
        w = jnp.ones(n_pad)
        lb_d = jnp.asarray(lb_run)
        ub_d = jnp.asarray(ub_run)

        def _host_repair():
            """core.repair on host: all-artificial warm phase-1 restart."""
            nonlocal basis, vstat, art_sign, phase
            vs = np.asarray(vstat)
            lbt = np.concatenate([lb_run, np.zeros(m_pad)])
            ubt = np.concatenate([ub_run, np.zeros(m_pad)])
            demote = np.where(
                lbt == ubt, st.NB_FIXED,
                np.where(
                    np.isfinite(lbt), st.NB_LOWER,
                    np.where(np.isfinite(ubt), st.NB_UPPER, st.NB_FREE),
                ),
            )
            vs = np.where(vs == st.BASIC, demote, vs).astype(np.int32)
            vs[n_pad:] = st.BASIC
            basis = jnp.asarray(
                n_pad + np.arange(m_pad, dtype=np.int32)
            )
            vstat = jnp.asarray(vs)
            # artificial signs against the RUN bounds (may be perturbed)
            at_lo = (vs[:n_pad] == st.NB_LOWER) | (vs[:n_pad] == st.NB_FIXED)
            x0 = np.where(
                at_lo, lb_run, np.where(vs[:n_pad] == st.NB_UPPER, ub_run, 0.0)
            )
            r0 = b.copy()
            r0[:m] -= np.asarray(sp.csc_matrix(cf.A) @ x0[: cf.n])
            sign = np.where(r0 >= 0, 1.0, -1.0)
            art_sign = jnp.asarray(sign)
            phase = jnp.int32(1)
            return jnp.asarray(np.diag(sign))

        def _refactor_derive(Binv, first=False):
            """probe → polish → rebuild → (host repair); then derive."""
            nonlocal phase, w
            resid0 = (
                np.inf if first or Binv is None
                else float(dual_xl_resid(A, basis, art_sign, Binv))
            )
            if not (np.isfinite(resid0) and resid0 < 1e-9):
                if Binv is not None and not first:
                    X1, resid1 = dual_xl_polish(A, basis, art_sign, Binv)
                else:
                    X1, resid1 = None, np.inf
                if (
                    np.isfinite(float(resid1))
                    and float(resid1) < 1e-9
                    and float(jnp.max(jnp.abs(X1))) < 1e13
                ):
                    Binv = X1
                else:
                    del X1
                    Binv, resid2 = dual_xl_rebuild(
                        A, basis, art_sign, cfg=cfg_xl
                    )
                    # a basis can pass the residual check yet carry a
                    # ~1/σ_min inverse beyond the magnitude the core's
                    # numerical watchdog allows (crossover guesses) —
                    # treat it like a singular basis
                    bmag = float(jnp.max(jnp.abs(Binv)))
                    if (
                        not np.isfinite(float(resid2))
                        or float(resid2) > 1e-6
                        or not np.isfinite(bmag)
                        or bmag > 1e13
                    ):
                        _log.warning(
                            "primal-xl: singular/ill-conditioned basis at "
                            "refactorization (resid=%s, |Binv|=%.1e) — "
                            "artificial restart", float(resid2), bmag,
                        )
                        Binv = _host_repair()
            xB, pi, w2, art = primal_xl_derive(
                A, b, c, lb_d, ub_d, basis, vstat, art_sign, phase, w,
                Binv, cfg=cfg_xl,
            )
            w = w2
            if int(phase) == 1 and float(art) <= cfg_xl.eps_feas:
                phase = jnp.int32(2)
                xB, pi, w2, art = primal_xl_derive(
                    A, b, c, lb_d, ub_d, basis, vstat, art_sign, phase, w,
                    Binv, cfg=cfg_xl,
                )
                w = w2
            return Binv, xB, pi

        Binv, xB, pi = _refactor_derive(None, first=True)
        state = State(
            basis=basis, vstat=vstat, xB=xB, Binv=Binv, pi=pi,
            art_sign=art_sign, phase=phase,
            status=jnp.int32(st.RUNNING), it=jnp.int32(0),
            since_refactor=jnp.int32(0), degen_count=jnp.int32(0),
            bland=jnp.bool_(cfg_xl.pricing == "bland"),
            repairs=jnp.int32(0), w=w,
            etaZ=jnp.zeros((m_pad, 1)), etaR=jnp.zeros(1, jnp.int32),
            eta_count=jnp.int32(0),
            trace=jnp.zeros((0, 8), jnp.float32),
            viol=jnp.zeros(()), pblock=jnp.int32(0),
            refactors=jnp.zeros(3, jnp.int32),
        )
        done_here = 0
        stalled_cycles = 0
        host_repairs = 0
        status = st.ITERATION_LIMIT
        while done_here < budget:
            this_chunk = min(chunk, budget - done_here)
            s = primal_xl_iterate(
                A, b, c, lb_d, ub_d, state, cfg=cfg_xl, max_iter=this_chunk
            )
            s = jax.block_until_ready(s)
            it_here = int(s.it)
            done_here += it_here
            total_done += it_here
            status = int(s.status)
            if _log.isEnabledFor(20):
                _log.info(
                    "primal-xl chunk it=%d total=%d status=%d phase=%d "
                    "wall=%.1fs", it_here, done_here, status, int(s.phase),
                    t.peek(),
                )
            if status == st.NUMERICAL and host_repairs < 2:
                # mid-chunk state breakage (ill-conditioned crossover
                # basis drifting past the watchdog's magnitude cap): the
                # in-loop core's answer is repair() — mirror it on host
                host_repairs += 1
                basis, vstat = s.basis, s.vstat
                art_sign, phase, w = s.art_sign, s.phase, s.w
                _log.warning(
                    "primal-xl: broken state at it=%d — artificial restart "
                    "(%d/2)", done_here, host_repairs,
                )
                Binv0 = _host_repair()  # resets basis/vstat/art_sign/phase
                w = jnp.ones(n_pad)     # devex reference reset (in-loop
                #                         repair does the same)
                Binv, xB, pi = _refactor_derive(Binv0)
                state = s._replace(
                    basis=basis, vstat=vstat, art_sign=art_sign,
                    phase=phase, Binv=Binv, xB=xB, pi=pi, w=w,
                    status=jnp.int32(st.RUNNING),
                    since_refactor=jnp.int32(0), it=jnp.int32(0),
                    bland=jnp.bool_(True),
                )
                continue
            if status != st.RUNNING or done_here >= budget:
                state = s
                break
            if int(s.since_refactor) < cfg_xl.refactor_period:
                state = s._replace(it=jnp.int32(0))
                continue  # chunk budget hit mid-period: keep iterating
            basis, vstat, art_sign, phase = s.basis, s.vstat, s.art_sign, s.phase
            w = s.w
            Binv, xB, pi = _refactor_derive(s.Binv)
            state = s._replace(
                basis=basis, vstat=vstat, art_sign=art_sign, phase=phase,
                Binv=Binv, xB=xB, pi=pi, w=w,
                since_refactor=jnp.int32(0), it=jnp.int32(0),
            )
            stalled_cycles = stalled_cycles + 1 if it_here <= 1 else 0
            if stalled_cycles >= 4:
                _log.warning(
                    "primal-xl: stalled refactorization cycles — stopping"
                )
                status = st.NUMERICAL
                state = state._replace(status=jnp.int32(st.NUMERICAL))
                break
        if status == st.RUNNING:
            status = st.ITERATION_LIMIT

        # clean final refactor + host extraction (the in-loop form's final
        # refactor/refinement, dual_xl-style)
        basis, vstat, art_sign, phase = (
            state.basis, state.vstat, state.art_sign, state.phase,
        )
        w = state.w
        Binv, xB, pi = _refactor_derive(state.Binv)
        vstat_np = np.asarray(vstat)
        basis_np = np.asarray(basis)
        xB_np = np.asarray(xB)
        lb_tot = np.concatenate([lb_run, np.zeros(m_pad)])
        ub_tot = np.concatenate([ub_run, np.zeros(m_pad)])
        at_lower = (vstat_np == st.NB_LOWER) | (vstat_np == st.NB_FIXED)
        nb = np.where(
            at_lower, lb_tot,
            np.where(vstat_np == st.NB_UPPER, ub_tot, 0.0),
        )
        nb = np.where(vstat_np == st.BASIC, 0.0, nb)
        x = nb[:n_pad].copy()
        struct = basis_np < n_pad
        x[basis_np[struct]] = xB_np[struct]
        art_inf = float(np.abs(xB_np[~struct]).sum())
        return SimpleNamespace(
            x=x,
            status=np.int32(status),
            it=np.int32(done_here),
            phase=np.asarray(phase, np.int32),
            basis=basis_np,
            vstat=vstat_np,
            art_inf=np.float64(art_inf),
            pi=np.asarray(pi),
            obj=np.float64(c @ x),
            art_sign=np.asarray(art_sign),
            trace=np.zeros((0, 8), np.float32),
            viol=np.float64(0.0),
        )

    def _run_pdlp(t):
        """Restarted PDHG (relp_tpu.fom.pdhg — the first-order scale
        path): two SpMVs + vector ops per iteration, no inverse, no
        factorization.  Returns a SolveOutput-shaped namespace on
        convergence, else None (caller falls back to simplex)."""
        import jax.numpy as jnp

        from relp_tpu.fom.pdhg import (
            _power_norm, cast_state, initial_state, kkt_residual,
            solve_pdhg_chunk,
        )
        from relp_tpu.ops.amatrix import as_amatrix
        from relp_tpu.utils.metrics import logger as _log

        nonlocal total_done
        # Ruiz ∞-norm equilibration on top of the geometric-mean scaling
        # (the PDLP recipe): first-order convergence is driven by A's
        # conditioning far more than simplex is — ISRAEL-class instances
        # stall without it.  Solve in x = D_c x', y = D_r y' space; the
        # cf-space duals are D_r y'.
        csc0 = sp.csc_matrix(cf.A)
        d_r = np.ones(m_pad)
        d_c = np.ones(n_pad)
        S = abs(csc0).tocsr()
        for _ in range(10):
            rmax = np.asarray(S.max(axis=1).todense()).ravel()
            rs = 1.0 / np.sqrt(np.where(rmax > 0, rmax, 1.0))
            S = sp.diags(rs) @ S
            cmax = np.asarray(S.max(axis=0).todense()).ravel()
            cs = 1.0 / np.sqrt(np.where(cmax > 0, cmax, 1.0))
            S = S @ sp.diags(cs)
            d_r[: cf.m] *= rs
            d_c[: cf.n] *= cs
        # one Pock–Chambolle (α=1) pass on top of Ruiz — the cuPDLP
        # scaling recipe: D_r = diag(1/√‖a_i·‖₁), D_c = diag(1/√‖a_·j‖₁)
        if config.pdlp_scale == "ruiz+pc":
            r1 = np.asarray(abs(S).sum(axis=1)).ravel()
            rs = 1.0 / np.sqrt(np.where(r1 > 0, r1, 1.0))
            S = sp.diags(rs) @ S
            c1 = np.asarray(abs(S).sum(axis=0)).ravel()
            cs = 1.0 / np.sqrt(np.where(c1 > 0, c1, 1.0))
            S = S @ sp.diags(cs)
            d_r[: cf.m] *= rs
            d_c[: cf.n] *= cs
        csc_s = sp.diags(d_r[: cf.m]) @ csc0 @ sp.diags(d_c[: cf.n])
        from types import SimpleNamespace as _NS

        b_s = b * d_r
        c_s = c * d_c
        with np.errstate(invalid="ignore"):
            lb_s = np.where(np.isfinite(lb), lb / d_c, lb)
            ub_s = np.where(np.isfinite(ub), ub / d_c, ub)
        # device layout: ELL (the cuPDLP pattern: gathers over a CSR-like
        # layout).  "bricks" (ops/bricks.py) stays as an explicit choice;
        # bricks want the nonzeros clustered, so they solve in RCM-permuted
        # space and un-permute the returned point.
        fmt = config.pdlp_matrix
        if fmt == "auto":
            fmt = "ell"
        # multi-device: the ELL leaves column-shard over the 'cols' mesh
        # axis (parallel/sharded.py placement — same recipe as the simplex
        # path); brick tiles mix columns inside a tile, so a mesh request
        # forces the ELL layout — but only when sharding will actually
        # happen (an indivisible n_pad or too few devices keeps the
        # requested layout).  Per iteration
        # GSPMD inserts one all-gather of x for A·x (row-major twin,
        # replicated) and the KKT/step reductions ride psum.
        use_mesh = config.mesh_cols not in (0, 1)
        if use_mesh:
            k_dev = (
                config.mesh_cols if config.mesh_cols > 0 else len(jax.devices())
            )
            use_mesh = n_pad % k_dev == 0 and k_dev <= len(jax.devices())
            if not use_mesh:
                _log.warning(
                    "pdlp mesh_cols=%d skipped (n_pad=%d, %d devices) — "
                    "keeping layout %s",
                    config.mesh_cols, n_pad, len(jax.devices()), fmt,
                )
        if use_mesh:
            fmt = "ell"
        # the brick solve runs in its own (128-multiple) padded, RCM-
        # permuted space; mp/np_ and the pad-extended perms map back
        mp, np_ = m_pad, n_pad
        rpad = np.arange(m_pad)
        cpad = np.arange(n_pad)
        if fmt == "bricks":
            from relp_tpu.ops.bricks import (
                bandwidth_perm, grouped_bricks_from_csc,
            )

            mp = max(_round_up(m_pad, 128), 128)
            np_ = max(_round_up(n_pad, 128), 128)
            rp, cp = bandwidth_perm(csc_s.tocsc())
            rpad = np.concatenate([rp, np.arange(cf.m, mp)])
            cpad = np.concatenate([cp, np.arange(cf.n, np_)])
            coo_p = csc_s.tocsc()[rp][:, cp].tocoo()
            csc_pad = sp.csc_matrix(
                (coo_p.data, (coo_p.row, coo_p.col)), shape=(mp, np_)
            )
            # tight-packed grouped layout: 2.6-2.9× less HBM traffic per
            # SpMV than the flat [T, B] slot array on DFL001/STOCFOR3
            A_s = grouped_bricks_from_csc(csc_pad, mp, np_)
            ext = lambda a, k, fill: np.concatenate(  # noqa: E731
                [a, np.full(k - len(a), fill)]
            )
            b_s = ext(b_s, mp, 0.0)[rpad]
            c_s = ext(c_s, np_, 0.0)[cpad]
            lb_s = ext(lb_s, np_, 0.0)[cpad]
            ub_s = ext(ub_s, np_, 0.0)[cpad]
        else:
            A_s = _device_matrix(
                _NS(A=csc_s, m=cf.m, n=cf.n), m_pad, n_pad, config
            )
        if use_mesh:
            from relp_tpu.parallel.sharded import maybe_shard

            A_s, b_s, c_s, lb_s, ub_s, _ = maybe_shard(
                config.mesh_cols, n_pad, A_s, b_s, c_s, lb_s, ub_s
            )
        else:
            # pin the operator and problem vectors to the device ONCE:
            # numpy-leaved jit arguments are re-transferred on EVERY call
            A_s, b_s, c_s, lb_s, ub_s = jax.device_put(
                (A_s, b_s, c_s, lb_s, ub_s)
            )
        norm_A = float(jax.jit(_power_norm)(as_amatrix(A_s)))
        if not np.isfinite(norm_A) or norm_A <= 0:
            return None
        state = initial_state(as_amatrix(A_s), lb_s, ub_s, 0.9 / norm_A)

        # ---- mixed precision (config.pdlp_precision="mixed"): f32 rounds
        # for the bulk of the iterations, f64 relative-KKT verification at
        # every chunk boundary, and an f64 endgame once the f32 fixed-point
        # floor (~1e-6 relative) is reached.  Acceptance ALWAYS uses f64
        # KKT.  "auto" is f64 rounds throughout (PERF.md: mixed needed
        # more iterations than f64 saved time on the H100). ----
        precision = str(config.pdlp_precision)
        if precision == "auto":
            precision = "f64"
        f32_stage = precision == "mixed"
        if f32_stage:
            _f32 = jnp.float32
            A32 = jax.device_put(jax.tree.map(
                lambda l: l.astype(_f32) if l.dtype == jnp.float64 else l,
                as_amatrix(A_s),
            ))
            b32, c32, lb32, ub32 = (
                jnp.asarray(v, _f32) for v in (b_s, c_s, lb_s, ub_s)
            )
            state = cast_state(state, A32, _f32)
        # hand off to f64 once the f32 stage reaches the territory where
        # its SpMV noise (~1e-7 relative) stops being negligible
        f32_until = max(
            10.0 * float(config.pdlp_accept), 100.0 * float(config.pdlp_tol)
        )

        # ---- iterative-refinement frame (config.pdlp_refine): when the
        # f32 stage floors, zoom into the residual problem instead of
        # paying for f64 rounds.  The frame is (xbar, ybar,
        # dp): the f32 state then solves  min dᵀe  s.t. A e = dp·r,
        # dp·(lb−xbar) ≤ e ≤ dp·(ub−xbar)  with r = b − A·xbar and
        # d = c − Aᵀybar computed in f64; the composite full-problem point
        # is X = xbar + x/dp, Y = ybar + y.  Same device operator for
        # every subproblem — only the O(n+m) vectors change. ----
        xbar = None  # None ⇒ base frame (state solves the full problem)
        ybar = None
        dp_zoom = 1.0
        refines_left = int(config.pdlp_refine) if f32_stage else 0
        kkt_at_refine = np.inf

        def _composite():
            """Full-problem (X, Y) of the current state, f64 numpy."""
            X = np.asarray(state.x, np.float64)
            Y = np.asarray(state.y, np.float64)
            if xbar is not None:
                X = xbar + X / dp_zoom
                Y = ybar + Y
            return X, Y

        def _refine(reason: str) -> bool:
            """Zoom the f32 stage into the current residual problem."""
            nonlocal xbar, ybar, dp_zoom, state, b32, c32, lb32, ub32
            nonlocal best_it, ref_kkt, refines_left, kkt_at_refine
            if (
                refines_left <= 0
                or not np.isfinite(best_kkt)
                # each zoom must have bought ≥4× before the next is funded
                or not best_kkt < 0.25 * kkt_at_refine
            ):
                return False
            X, Y = best_xy if best_xy is not None else _composite()
            lbn, ubn = np.asarray(lb_s), np.asarray(ub_s)
            X = np.minimum(np.maximum(X, lbn), ubn)
            op = as_amatrix(A_s)
            r = np.asarray(b_s, np.float64) - np.asarray(
                op.matvec(jnp.asarray(X)), np.float64
            )
            d = np.asarray(c_s, np.float64) - np.asarray(
                op.rmatvec(jnp.asarray(Y)), np.float64
            )
            dp_new = float(np.clip(
                1.0 / max(float(np.max(np.abs(r))), 1e-14), 1.0, 1e14
            ))
            # e = 0 must stay feasible (X is in-bounds by construction);
            # the ±1e30 cap keeps far-away bounds finite in f32 — a trust
            # region that only binds on a step the zoom scale rules out
            with np.errstate(invalid="ignore"):
                lo = np.where(
                    np.isfinite(lbn),
                    np.clip((lbn - X) * dp_new, -1e30, 0.0), -np.inf,
                )
                hi = np.where(
                    np.isfinite(ubn),
                    np.clip((ubn - X) * dp_new, 0.0, 1e30), np.inf,
                )
            b32, c32, lb32, ub32 = (
                jax.device_put(jnp.asarray(v, jnp.float32))
                for v in (dp_new * r, d, lo, hi)
            )
            xbar, ybar, dp_zoom = X, Y, dp_new
            state = initial_state(
                A32, lb32, ub32, 0.9 / norm_A, dtype=jnp.float32
            )._replace(it=state.it)
            refines_left -= 1
            kkt_at_refine = best_kkt
            best_it = int(state.it)
            ref_kkt = np.inf
            _log.info(
                "pdlp: refinement zoom at it=%d (dp=%.1e, %s, %d left)",
                int(state.it), dp_new, reason, refines_left,
            )
            return True

        def _promote_to_f64(reason: str, clean: bool = False):
            nonlocal f32_stage, state, best_it, ref_kkt, variant
            nonlocal xbar, ybar, dp_zoom
            carry_it = state.it
            omega64 = jnp.asarray(float(state.omega), jnp.float64)
            if clean and best_xy is not None:
                # a diverged stage still leaves the best snapshot — a far
                # better f64 start than from-scratch
                Xp, Yp = best_xy
                clean = False
            elif not clean:
                Xp, Yp = _composite()
            f32_stage = False
            xbar = ybar = None
            dp_zoom = 1.0
            ref_kkt = np.inf
            if not clean and variant == "halpern" and "avg" in variants_left:
                # endgame heuristic (measured on DFL001, 3 runs): from a
                # near-converged f32 point the restarted-average scheme
                # plunges to 1e-8 within ~2 chunks while Halpern anchoring
                # stalls ~40k iterations at ~1e-5 — start the f64 endgame
                # on avg and keep halpern as the cascade fallback
                variants_left.remove("avg")
                variants_left.insert(0, "halpern")
                variant = "avg"
            if clean:
                state = initial_state(
                    as_amatrix(A_s), lb_s, ub_s, 0.9 / norm_A
                )._replace(it=carry_it)
            else:
                # re-anchor at the promoted point: a stale f32-era Halpern
                # anchor keeps pulling the f64 iterates back toward f32-
                # noise territory (observed: post-promotion stall at ~1e-5)
                lbn, ubn = np.asarray(lb_s), np.asarray(ub_s)
                xd = jnp.asarray(np.minimum(np.maximum(Xp, lbn), ubn))
                yd = jnp.asarray(np.asarray(Yp, np.float64))
                axd = as_amatrix(A_s).matvec(xd)
                state = initial_state(
                    as_amatrix(A_s), lb_s, ub_s, 0.9 / norm_A
                )._replace(
                    it=carry_it, x=xd, y=yd, ax=axd,
                    x_anchor=xd, y_anchor=yd, ax_anchor=axd,
                    omega=omega64,
                )
            best_it = int(state.it)
            _log.info(
                "pdlp: switching to f64 rounds at it=%d (%s)",
                int(state.it), reason,
            )

        budget = config.max_iter if config.max_iter > 0 else 1_000_000
        round_len = int(config.pdlp_round)
        # restart rounds per device call (each ~(2·round_len + 8) SpMVs):
        # the host checks the f64 KKT and the plateau between calls, so
        # the cap also bounds a call to ~4M row+column sweeps
        rounds_per_call = max(
            1,
            min(_PDLP_ROUNDS, 4_000_000 // max(m_pad + n_pad, 1)),
        )
        best_kkt, best_it = np.inf, 0
        last_kkt64 = np.inf
        best_xy = None  # snapshot of the best-KKT point (adaptive PDHG can
        # REGRESS after nearly converging — ω rebalance instability — and
        # the last iterate is then worse than the best one seen)
        ref_kkt = np.inf  # plateau-clock progress reference: reset on
        # variant switches so the new scheme gets a full window even when
        # it has not yet beaten the previous scheme's best
        accepted = False
        # neither restart scheme dominates (halpern converges where avg
        # diverges on SCSD8; avg converges where halpern stalls on
        # STOCFOR3) — on plateau-above-accept or divergence, cascade to
        # the untried scheme before giving up on the first-order path
        variant = str(config.pdlp_variant)
        other = {"halpern": "avg", "avg": "halpern"}[variant]
        variants_left = [other]

        def _switch_variant(warm: bool):
            nonlocal state, variant, best_it, ref_kkt
            ref_kkt = np.inf
            variant = variants_left.pop(0)
            if warm:
                # continue from the CURRENT iterate — it is the algorithm's
                # natural trajectory (measured: restarting from the lowest-
                # KKT snapshot sends the new scheme off-course; the snapshot
                # is kept only for final acceptance); re-anchor and clear
                # the scheme's restart bookkeeping (x_sum/steps for avg,
                # kkt_mu = the anchor residual for halpern)
                x0, y0 = state.x, state.y
                ax0 = as_amatrix(A_s).matvec(x0)
                state = state._replace(
                    x=x0,
                    y=y0,
                    ax=ax0,
                    x_sum=jnp.zeros_like(state.x_sum),
                    y_sum=jnp.zeros_like(state.y_sum),
                    steps=jnp.int32(0),
                    x_anchor=x0,
                    y_anchor=y0,
                    ax_anchor=ax0,
                    eta=jnp.asarray(0.9 / norm_A, state.eta.dtype),
                    kkt_mu=jnp.asarray(np.inf, state.kkt_mu.dtype),
                )
            else:  # diverged: the point is garbage, restart clean
                state = initial_state(
                    as_amatrix(A_s), lb_s, ub_s, 0.9 / norm_A
                )._replace(it=state.it)
            best_it = int(state.it)

        while int(state.it) < budget:
            ops = (
                (A32, b32, c32, lb32, ub32) if f32_stage
                else (A_s, b_s, c_s, lb_s, ub_s)
            )
            state = solve_pdhg_chunk(
                *ops, state,
                round_len=round_len, max_rounds=rounds_per_call,
                tol=float(config.pdlp_tol),
                variant=variant,
            )
            state = jax.block_until_ready(state)
            # the f32 stage's self-reported KKT carries ~1e-7 SpMV noise
            # (and, in a refinement frame, describes the SUBPROBLEM):
            # every decision below uses the f64 full-problem KKT of the
            # composite point
            if f32_stage:
                Xc, Yc = _composite()
                kkt64 = float(kkt_residual(
                    A_s, b_s, c_s, lb_s, ub_s,
                    jnp.asarray(Xc), jnp.asarray(Yc),
                ))
            else:
                kkt64 = float(state.kkt)
            last_kkt64 = kkt64
            if _log.isEnabledFor(20):
                _log.info(
                    "pdlp chunk it=%d kkt=%.3e%s omega=%.3e obj=%.9e wall=%.1fs",
                    int(state.it), kkt64, " (f32 rounds)" if f32_stage else "",
                    float(state.omega),
                    float(np.asarray(c_s) @ (
                        Xc if f32_stage
                        else np.asarray(state.x, np.float64)
                    )),
                    t.peek(),
                )
            if kkt64 < float(config.pdlp_tol):
                # the COMPOSITE point converged — the state's own status
                # can lag (a refinement subproblem never reaches tol in
                # its own frame; its inner KKT measures the subproblem)
                best_kkt = kkt64
                best_xy = (
                    (Xc, Yc) if f32_stage
                    else (np.asarray(state.x, np.float64).copy(),
                          np.asarray(state.y, np.float64).copy())
                )
                accepted = True
                break
            if int(state.status) != st.RUNNING:
                if not f32_stage:
                    break
                # the f32/inner rounds declared optimal but the composite
                # f64 KKT disagrees: zoom again if funded, else go f64
                if not _refine("inner optimum above tol in f64"):
                    _promote_to_f64("f32 optimality unconfirmed in f64")
                continue
            # plateau detection: the f64 relative-KKT floor can sit above
            # pdlp_tol (config.pdlp_accept docstring) — stop burning
            # iterations once progress stalls, accept if good enough
            if not np.isfinite(kkt64) or kkt64 > 1e10 or (
                best_kkt < 1.0 and kkt64 > max(1e6 * best_kkt, 1e3)
            ):
                # divergence guard: adaptive-η PDHG can blow up (SCSD8 in
                # avg mode reaches KKT ~1e133) — stop burning iterations
                if f32_stage:
                    # rule out precision as the cause before burning a
                    # restart-scheme switch
                    _promote_to_f64("f32 divergence", clean=True)
                    continue
                if variants_left:
                    _log.info(
                        "pdlp diverged at it=%d (kkt=%.3e) — restarting "
                        "with variant=%s", int(state.it), kkt64,
                        variants_left[0],
                    )
                    _switch_variant(warm=False)
                    continue
                _log.info(
                    "pdlp diverged at it=%d (kkt=%.3e, best=%.3e) — "
                    "falling back", int(state.it), kkt64, best_kkt,
                )
                break
            if kkt64 < best_kkt:
                best_kkt = kkt64
                best_xy = (
                    (Xc, Yc) if f32_stage
                    else (np.asarray(state.x, np.float64).copy(),
                          np.asarray(state.y, np.float64).copy())
                )
            if kkt64 < 0.9 * ref_kkt:
                # beyond-noise progress (relative to the CURRENT scheme's
                # reference): reset the plateau clock
                ref_kkt = kkt64
                best_it = int(state.it)
            if f32_stage and xbar is None and best_kkt <= f32_until:
                # the BASE f32 stage reached endgame territory: zoom via
                # refinement if funded, else hand off to f64 rounds (in a
                # refinement frame this is the plateau logic's job)
                if not _refine(f"zoom at kkt={best_kkt:.1e}"):
                    _promote_to_f64(
                        f"f64 endgame territory (kkt={best_kkt:.1e})"
                    )
                continue
            # plateau window scales with how long progress took so far:
            # XL-tier instances need hundreds of thousands of iterations,
            # and a fixed window cuts schemes off mid-convergence (the
            # same idea as PDLP's artificial restarts at ~0.36·k_total).
            # Once the best point already MEETS the acceptance bar, the
            # fixed window applies — further iterations only polish, and
            # a long adaptive window just delays the accept
            window = max(int(config.pdlp_plateau), best_it // 2)
            if best_kkt <= float(config.pdlp_accept):
                window = int(config.pdlp_plateau)
            if f32_stage:
                # a stalled f32 stage is promoted (cheap, the f64 rounds
                # are only ~2.4× slower) — detect its noise floor on a much
                # shorter window than the fall-back plateau (ISRAEL's f32
                # floor is ~2e-3; waiting the full window burned 100k
                # useless f32 iterations)
                window = max(int(config.pdlp_plateau) // 4, best_it // 4)
            if (
                config.pdlp_plateau > 0
                and int(state.it) - best_it >= window
            ):
                if best_kkt <= float(config.pdlp_accept):
                    accepted = True
                    _log.info(
                        "pdlp plateau at it=%d: accepting best kkt=%.3e "
                        "(tol=%.1e unreached, accept=%.1e)",
                        int(state.it), best_kkt,
                        float(config.pdlp_tol), float(config.pdlp_accept),
                    )
                elif f32_stage:
                    # stalled above the accept bar while still in f32:
                    # the precision floor is the first suspect — zoom if
                    # the last zoom paid for itself, else go f64
                    if not _refine(f"f32 plateau at kkt={best_kkt:.1e}"):
                        _promote_to_f64(
                            f"f32 plateau at kkt={best_kkt:.1e}"
                        )
                    continue
                elif variants_left:
                    _log.info(
                        "pdlp plateau at it=%d: kkt=%.3e > accept=%.1e — "
                        "continuing with variant=%s",
                        int(state.it), kkt64,
                        float(config.pdlp_accept), variants_left[0],
                    )
                    # a stalled-but-sane best point warm-continues; a
                    # blown-up history restarts clean
                    _switch_variant(warm=best_kkt < 1e3)
                    continue
                else:
                    _log.info(
                        "pdlp plateau at it=%d: kkt=%.3e > accept=%.1e — "
                        "falling back", int(state.it), kkt64,
                        float(config.pdlp_accept),
                    )
                break
        total_done += int(state.it)
        if int(state.status) != st.OPTIMAL and not accepted:
            return None
        # the returned point: the best-KKT snapshot when plateau-accepted,
        # else the final composite (full-problem coordinates either way)
        if accepted and best_xy is not None:
            X_fin, Y_fin = best_xy
            kkt_fin = best_kkt
        else:
            X_fin, Y_fin = _composite()
            kkt_fin = last_kkt64
        from types import SimpleNamespace

        x_s = np.empty(np_)
        x_s[cpad] = X_fin
        y_s = np.empty(mp)
        y_s[rpad] = Y_fin
        x_np = d_c * x_s[:n_pad]
        y_s = y_s[:m_pad]
        r_prim = float(np.max(np.abs(
            np.asarray(as_amatrix(A).matvec(jnp.asarray(x_np))) - b
        )))
        return SimpleNamespace(
            x=x_np,
            status=np.int32(st.OPTIMAL),
            it=np.int32(int(state.it)),
            phase=np.int32(2),
            basis=(n_pad + np.arange(m_pad, dtype=np.int32)),
            vstat=np.full(n_pad + m_pad, st.NB_LOWER, np.int32),
            art_inf=np.float64(r_prim),
            pi=d_r * y_s,
            obj=np.float64(c @ x_np),
            art_sign=np.ones(m_pad),
            trace=np.zeros((0, 8), np.float32),
            viol=np.float64(kkt_fin),
            vertex=False,  # first-order point: basis/vstat are placeholders
        )

    def _run_ipm(t):
        """Primal-dual interior point (config.algorithm="ipm",
        simplex/primal_dual.py): Mehrotra predictor-corrector over the
        dense scaled operator — one normal-equation GEMM + Cholesky per
        iteration.  Returns the same
        SolveOutput-shaped namespace as ``_run_pdlp`` (vertex=False; the
        shared crossover recovers the exact vertex), else None."""
        from types import SimpleNamespace

        import jax.numpy as jnp

        from relp_tpu.ops.amatrix import as_amatrix
        from relp_tpu.simplex.primal_dual import solve_ipm
        from relp_tpu.utils.metrics import logger as _log

        nonlocal total_done
        # same Ruiz ∞-norm equilibration as the PDLP path: the Cholesky's
        # f32 conditioning rides on A being O(1)-equilibrated
        csc0 = sp.csc_matrix(cf.A)
        d_r = np.ones(m_pad)
        d_c = np.ones(n_pad)
        S = abs(csc0).tocsr()
        for _ in range(10):
            rmax = np.asarray(S.max(axis=1).todense()).ravel()
            rs = 1.0 / np.sqrt(np.where(rmax > 0, rmax, 1.0))
            S = sp.diags(rs) @ S
            cmax = np.asarray(S.max(axis=0).todense()).ravel()
            cs = 1.0 / np.sqrt(np.where(cmax > 0, cmax, 1.0))
            S = S @ sp.diags(cs)
            d_r[: cf.m] *= rs
            d_c[: cf.n] *= cs
        csc_s = sp.diags(d_r[: cf.m]) @ csc0 @ sp.diags(d_c[: cf.n])
        b_s = b * d_r
        c_s = c * d_c
        with np.errstate(invalid="ignore"):
            lb_s = np.where(np.isfinite(lb), lb / d_c, lb)
            ub_s = np.where(np.isfinite(ub), ub / d_c, ub)
        A_dense = np.zeros((m_pad, n_pad))
        A_dense[: cf.m, : cf.n] = csc_s.toarray()
        res = solve_ipm(
            A_dense, b_s, c_s, lb_s, ub_s,
            tol=config.ipm_tol, accept=config.ipm_accept,
            max_iter=config.ipm_max_iter, ladder=config.ipm_ladder,
            log=_log,
        )
        if res is None:
            return None
        x_s, y_s, info = res
        total_done += info.iterations
        if _log.isEnabledFor(20):
            _log.info(
                "ipm done it=%d kkt=%.3e converged=%s wall=%.1fs",
                info.iterations, info.kkt, info.converged, t.peek(),
            )
        x_np = d_c * x_s
        r_prim = float(np.max(np.abs(
            np.asarray(as_amatrix(A).matvec(jnp.asarray(x_np))) - b
        )))
        return SimpleNamespace(
            x=x_np,
            status=np.int32(st.OPTIMAL),
            it=np.int32(info.iterations),
            phase=np.int32(2),
            basis=(n_pad + np.arange(m_pad, dtype=np.int32)),
            vstat=np.full(n_pad + m_pad, st.NB_LOWER, np.int32),
            art_inf=np.float64(r_prim),
            pi=d_r * y_s,
            obj=np.float64(c @ x_np),
            art_sign=np.ones(m_pad),
            trace=np.zeros((0, 8), np.float32),
            viol=np.float64(info.kkt),
            vertex=False,  # interior point: basis/vstat are placeholders
        )

    def _run_dual_chunked(t):
        """Dual simplex from scratch (config.algorithm="dual"): the
        all-artificial basis is dual feasible once every nonbasic sits on
        the bound matching sign(c_j) (π = 0 ⇒ d = c); columns without a
        suitable finite bound get a temporary box, verified inactive at
        optimality.  Returns the SolveOutput on a trusted OPTIMAL, else
        None (caller falls back to the primal path)."""
        from relp_tpu.simplex.dual import solve_core_dual

        nonlocal total_done, worst_viol
        boxM = float(config.dual_box)
        fixed = lb == ub
        need_low = (c >= 0) & ~np.isfinite(lb) & ~fixed
        need_up = (c < 0) & ~np.isfinite(ub) & ~fixed
        lb_d = np.where(need_low, -boxM, lb)
        ub_d = np.where(need_up, boxM, ub)
        vstat0 = np.where(
            fixed, st.NB_FIXED, np.where(c >= 0, st.NB_LOWER, st.NB_UPPER)
        ).astype(np.int32)
        x0 = np.where(vstat0 == st.NB_LOWER, lb_d, np.where(vstat0 == st.NB_UPPER, ub_d, lb_d))
        r0 = b.copy()
        r0[:m] -= np.asarray(sp.csc_matrix(cf.A) @ x0[: cf.n])
        warm = dict(
            basis0=(n_pad + np.arange(m_pad, dtype=np.int32)),
            vstat0=vstat0,
            art_sign0=np.where(r0 >= 0, 1.0, -1.0),
        )
        # xl_engine="lu" explicitly forces the host sparse-LU dual at ANY
        # size (hyper-sparse sequential pivoting can belong on the host);
        # "auto" keeps the size gate so small duals stay on-device
        if config.xl_engine == "lu" or m_pad > config.refactor_external_m:
            if config.xl_engine in ("auto", "lu"):
                out = _run_dual_lu_host(t, lb_d, ub_d, warm)
                if out is None and config.xl_engine == "auto":
                    out = _run_dual_xl(t, lb_d, ub_d, warm)
            else:
                out = _run_dual_xl(t, lb_d, ub_d, warm)
            if out is None:
                return None
        else:
            done_here = 0
            while True:
                this_chunk = min(chunk, max_iter - done_here)
                out = solve_core_dual(
                    A, b, c, lb_d, ub_d, warm["basis0"], warm["vstat0"],
                    cfg=config, max_iter=this_chunk, art_sign0=warm["art_sign0"],
                )
                out = jax.block_until_ready(out)
                done_here += int(out.it)
                total_done += int(out.it)
                from relp_tpu.utils.metrics import logger as _log

                if _log.isEnabledFor(20):
                    _log.info(
                        "dual chunk it=%d total=%d status=%d art=%.3e obj=%.9e "
                        "wall=%.1fs",
                        int(out.it), done_here, int(out.status),
                        float(out.art_inf), float(out.obj), t.peek(),
                    )
                if int(out.status) != st.ITERATION_LIMIT or done_here >= max_iter:
                    break
                warm = dict(
                    basis0=np.asarray(out.basis, np.int32),
                    vstat0=np.asarray(out.vstat, np.int32)[:n_pad],
                    art_sign0=np.asarray(out.art_sign),
                )
        if int(out.status) != st.OPTIMAL:
            return None
        x = np.asarray(out.x)
        box_active = (need_low & (x <= -0.5 * boxM)) | (need_up & (x >= 0.5 * boxM))
        if bool(np.any(box_active)):
            return None  # temporary box binds: not a certificate for the original
        return out

    def _perturbed_bounds():
        """Anti-degeneracy bound expansion (config.perturb), deterministic."""
        rng = np.random.default_rng(0xD31)
        scale_ = config.perturb
        fixed = lb == ub
        lb_p = np.where(
            np.isfinite(lb) & ~fixed,
            lb - scale_ * (1 + np.abs(lb)) * rng.uniform(0.5, 1.0, n_pad),
            lb,
        )
        ub_p = np.where(
            np.isfinite(ub) & ~fixed,
            ub + scale_ * (1 + np.abs(ub)) * rng.uniform(0.5, 1.0, n_pad),
            ub,
        )
        return lb_p, ub_p

    with Timer() as t:
        out = None
        # XL problems (config.refactor_external_m) auto-route to the dual
        # (host LU first) and then to the externally refactorized primal
        if (
            config.algorithm in ("pdlp", "ipm")
            and warm_start_builder is None
            and config.perturb == 0
        ):
            # None ⇒ fall back to simplex below
            out = _run_pdlp(t) if config.algorithm == "pdlp" else _run_ipm(t)
            if (
                out is not None
                and config.pdlp_crossover
            ):
                # crossover: DUAL-INFORMED basis guess.  The first-order /
                # interior point carries accurate row duals; the reduced-
                # cost signs identify the optimal nonbasic sets directly
                # (d_j > 0 ⇒ at lower, d_j < 0 ⇒ at upper) — far more
                # reliable than primal interiority alone, whose "m most
                # interior" guess builds near-singular bases on degenerate
                # instances (PILOT87: the primal polish NaN'd and the LU
                # repair churned 8k useless pivots).
                # Basic candidates are the |d|≈0 columns ranked by primal
                # interiority; near-bound variables snap to their bounds.
                xp = np.asarray(out.x)
                d_rc = c.copy()
                d_rc[: cf.n] -= sp.csc_matrix(cf.A).T @ np.asarray(out.pi)[:m]
                tol_l = 1e-7 * (1.0 + np.abs(lb))
                tol_u = 1e-7 * (1.0 + np.abs(ub))
                tol_d = 1e-7 * (1.0 + np.abs(c))
                fixed = lb == ub
                at_l = np.isfinite(lb) & (xp - lb <= tol_l)
                at_u = np.isfinite(ub) & (ub - xp <= tol_u) & ~at_l
                want_l = np.isfinite(lb) & (d_rc > tol_d)
                want_u = np.isfinite(ub) & (d_rc < -tol_d) & ~want_l
                nb_l = ~fixed & (at_l | want_l) & ~(at_u | want_u)
                nb_u = ~fixed & (at_u | want_u) & ~nb_l
                interior = ~(fixed | nb_l | nb_u)
                depth = np.minimum(
                    np.where(np.isfinite(lb), xp - lb, np.inf),
                    np.where(np.isfinite(ub), ub - xp, np.inf),
                )
                cand = np.flatnonzero(interior)
                cand = cand[np.argsort(-depth[cand])]
                # PROVABLY NONSINGULAR basic set: the strict triangular
                # (Bixby) crash over the interior candidates in priority
                # order.  Taking the "m most interior" columns directly
                # builds a rank-deficient basis on degenerate instances
                # (the IPM converges to the analytic center of the optimal
                # FACE — far more columns look interior than rank allows):
                # the singular-repair then demoted everything to faraway
                # bounds and the "polish" became a cold phase-1 (PILOT87:
                # art mass 2e5, 8k wasted pivots).
                from relp_tpu.simplex.lu_host import (
                    independent_crash, triangular_crash,
                )

                basis0 = triangular_crash(
                    _a_pad_csc(), cand, n_pad
                ).astype(np.int32)
                if (
                    m_pad <= _DENSE_CRASH_MAX_M
                    and 2 * int((basis0 < n_pad).sum()) < min(len(cand), m)
                ):
                    # a dense A defeats the strict triangular rule (one
                    # column touches every row): without this the push
                    # walks every interior column from an artificial
                    # basis (dense 768x1536 allocation LP: 1527 pivots)
                    basis0 = independent_crash(
                        _a_pad_csc(), cand, n_pad
                    ).astype(np.int32)
                chosen = basis0[basis0 < n_pad]
                vstat0 = np.where(
                    fixed, st.NB_FIXED,
                    np.where(
                        nb_l, st.NB_LOWER,
                        np.where(
                            nb_u, st.NB_UPPER,
                            np.where(
                                np.isfinite(lb), st.NB_LOWER,
                                np.where(
                                    np.isfinite(ub), st.NB_UPPER, st.NB_FREE
                                ),
                            ),
                        ),
                    ),
                ).astype(np.int32)
                vstat0[chosen] = st.BASIC
                # CLASSIC PUSH-FIRST CROSSOVER.  With the leftover
                # superbasics PARKED at their first-order values, the
                # crash basis is already basic-feasible to tolerance
                # (xB = B⁻¹(b − N·x_N) ≈ x*_B, inside its bounds) — no
                # restricted solve is needed (the earlier restricted-
                # polish detour ground thousands of degenerate phase-1
                # pivots against the snapped residual's artificial
                # floor).  primal_push walks each leftover to a bound or
                # into the basis (one FTRAN + ratio test each, host LU);
                # the warm TRUE-bounds re-solve then certifies the vertex
                # and absorbs the ~1e-5 residual the uncovered rows'
                # artificial slots carry.
                in_cand = np.zeros(n_pad, bool)
                in_cand[chosen] = True
                leftover = interior & ~in_cand
                xfix = np.clip(
                    xp,
                    np.where(np.isfinite(lb), lb, -np.inf),
                    np.where(np.isfinite(ub), ub, np.inf),
                )
                vstat0[leftover] = st.NB_FREE  # push assigns the real one
                # the push set must include EVERY nonbasic that is not
                # exactly at its assigned bound — snapping the dual-
                # informed columns (off their bound by up to ~2e-3 at a
                # 4e-9-KKT point) displaced the start by B⁻¹-amplified
                # ~0.5 and the push then COMPOUNDED it: each ratio test
                # clamped at an already-violated bound ejects a basic to
                # a value it does not have, injecting the violation into
                # the point (PILOT87: bound_viol 0.5 → 3.4e4 over 1627
                # pivots).  Parking everything at x* keeps the start
                # feasible to the first-order residual (~1e-10); the
                # extra walks are ≤2e-3 long and mostly snap pivot-free.
                bound_of = np.where(
                    (vstat0 == st.NB_LOWER), lb,
                    np.where(vstat0 == st.NB_UPPER, ub, 0.0),
                )
                off_bound = (
                    (vstat0 != st.BASIC)
                    & ~fixed
                    & (np.abs(xp - bound_of) > 1e-9 * (1.0 + np.abs(xp)))
                )
                push_set = leftover | off_bound
                vstat_full0 = np.concatenate(
                    [vstat0, np.full(m_pad, st.NB_LOWER, np.int32)]
                )
                vstat_full0[basis0] = st.BASIC
                x0c = np.where(
                    (vstat0 == st.NB_LOWER) | (vstat0 == st.NB_FIXED), lb,
                    np.where(vstat0 == st.NB_UPPER, ub, 0.0),
                )
                x0c[push_set] = xfix[push_set]
                x0c = np.where(vstat0 == st.BASIC, 0.0, x0c)
                r0c = b.copy()
                r0c[:m] -= np.asarray(sp.csc_matrix(cf.A) @ x0c[: cf.n])
                art_sign0 = np.where(r0c >= 0, 1.0, -1.0)
                from relp_tpu.simplex.lu_host import primal_push
                from relp_tpu.utils.metrics import logger as _clog

                if _clog.isEnabledFor(20):
                    _clog.info(
                        "crossover guess: interior=%d chosen=%d leftover=%d "
                        "nb_l=%d nb_u=%d",
                        int(interior.sum()), len(chosen),
                        int(leftover.sum()), int(nb_l.sum()),
                        int(nb_u.sum()),
                    )
                push = primal_push(
                    _a_pad_csc(), b, basis0.astype(np.int64), vstat_full0,
                    lb, ub, push_set, xfix, art_sign0, n_pad, d=d_rc,
                    log=_clog,
                )
                out_x = None
                warm3 = None
                if push is not None:
                    basis2, vstat2, _piv = push
                    # HEALTH GATE: on massively degenerate instances
                    # (PILOT87: ~6k ratio-tied walks) the push can eject
                    # slightly-violated basics to bounds they do not hold
                    # and compound the error into an unusable basis —
                    # detect it with one sparse LU + bound check (~ms)
                    # and keep the certified first-order point instead of
                    # burning minutes of doomed cleanup pivots.
                    from scipy.sparse.linalg import splu as _splu2

                    from relp_tpu.simplex.lu_host import (
                        _basis_matrix as _bm2,
                    )

                    try:
                        _vsh = vstat2[:n_pad]
                        _xnh = np.where(
                            (_vsh == st.NB_LOWER) | (_vsh == st.NB_FIXED),
                            lb, np.where(_vsh == st.NB_UPPER, ub, 0.0),
                        )
                        _xnh = np.where(_vsh == st.BASIC, 0.0, _xnh)
                        _rh = b.copy()
                        _rh[:m] -= np.asarray(
                            sp.csc_matrix(cf.A) @ _xnh[: cf.n]
                        )
                        _luh = _splu2(
                            _bm2(
                                _a_pad_csc(), basis2.astype(np.int64),
                                _host_art_sign(_vsh), n_pad,
                            ).tocsc(),
                            permc_spec="COLAMD",
                        )
                        _xbh = _luh.solve(_rh)
                        _lbt2 = np.concatenate([lb, np.zeros(m_pad)])
                        _ubt2 = np.concatenate([ub, np.zeros(m_pad)])
                        _violh = float(np.maximum(
                            np.maximum(
                                _lbt2[basis2] - _xbh, _xbh - _ubt2[basis2]
                            ), 0.0,
                        ).max())
                    except RuntimeError:
                        _violh = np.inf
                    if not np.isfinite(_violh) or _violh > 1e-2:
                        _clog.info(
                            "crossover: pushed basis unhealthy "
                            "(bound_viol=%.2e) — keeping the certified "
                            "first-order point", _violh,
                        )
                        push = None
                if push is not None:
                    warm3 = dict(
                        basis0=basis2.astype(np.int32),
                        vstat0=vstat2[:n_pad],
                        art_sign0=_host_art_sign(vstat2[:n_pad]),
                        phase0=np.int32(1),
                    )
                    # dual-LU CLEANUP between push and certify: highly
                    # degenerate walks (PILOT87: ~6k, mostly ratio ties at
                    # already-violated bounds) eject basics to bounds they
                    # do not exactly hold, compounding small bound
                    # violations — restoring primal feasibility is exactly
                    # the dual simplex's job, from the pushed statuses
                    # (repair=False: the FO-informed statuses already
                    # carry the right reduced-cost signs)
                    out_cl = _run_dual_lu_host(
                        t, lb.copy(), ub.copy(), warm3, repair=False,
                        iter_cap=4 * m_pad,
                    )
                    if out_cl is not None and int(out_cl.status) == st.OPTIMAL:
                        # primal feasibility restored (a dual-infeasible
                        # warm start means this is NOT yet optimal — the
                        # re-solve below certifies); continue from its basis
                        warm3 = dict(
                            basis0=np.asarray(out_cl.basis, np.int32),
                            vstat0=np.asarray(out_cl.vstat, np.int32)[:n_pad],
                            art_sign0=np.asarray(out_cl.art_sign),
                            phase0=np.int32(2),
                        )
                    # the certification re-solve is warm (typically a few
                    # pivots); budget it — a grind means the push landed
                    # badly and the FO point is the better answer
                    out_x = _run_chunked(
                        lb, ub, warm3, t, min(8 * m_pad, max_iter)
                    )
                ok_x = (
                    out_x is not None
                    and int(out_x.status) == st.OPTIMAL
                    and np.isfinite(float(out_x.obj))
                )
                if not ok_x and warm3 is not None:
                    # the device re-solve could not certify: the host LU
                    # dual reoptimizes from the pushed basis (whose duals
                    # are near-optimal, so the repair's sign-snapping is
                    # trustworthy — unlike from the raw crash basis); a
                    # failed cleanup keeps the certified first-order point
                    out_lu = _run_dual_lu_host(
                        t, lb.copy(), ub.copy(), warm3, repair=True,
                        iter_cap=8 * m_pad,
                    )
                    if out_lu is not None and int(out_lu.status) == st.OPTIMAL:
                        out = out_lu
                elif ok_x:
                    out = out_x
        want_dual = config.algorithm == "dual" or (
            out is None and m_pad > config.refactor_external_m
        )
        if want_dual and warm_start_builder is None and config.perturb == 0:
            out = _run_dual_chunked(t)  # None ⇒ fall back to the primal
        if (
            out is None
            and m_pad > config.refactor_external_m
            and config.xl_engine in ("auto", "lu")
        ):
            # XL routing preference: per-pivot O(nnz) host sparse-LU work
            # beats the device's dense O(m²) at hyper-sparse XL scale (on
            # an H100 at m_pad 16384, whole 2000-pivot windows: 455
            # host-LU dual pivots/s against 141 for the external device
            # dual, 177 for the external and 39 for the in-loop device
            # primal; PERF.md).  xl_engine="primal" skips this and stays on the
            # externally refactorized device primal (_run_chunked routes
            # there).  A failed LU falls through to it too.
            warm_lu = warm_kwargs
            if "basis0" not in warm_lu:  # slack-crash dict: cold LU start
                vstat_cold = np.where(
                    lb == ub, st.NB_FIXED,
                    np.where(
                        np.isfinite(lb), st.NB_LOWER,
                        np.where(np.isfinite(ub), st.NB_UPPER, st.NB_FREE),
                    ),
                ).astype(np.int32)
                warm_lu = dict(
                    basis0=(n_pad + np.arange(m_pad, dtype=np.int32)),
                    vstat0=vstat_cold,
                    art_sign0=_host_art_sign(vstat_cold),
                )
            if config.perturb > 0:
                lb_p, ub_p = _perturbed_bounds()
                out_p = _run_dual_lu_host(t, lb_p, ub_p, warm_lu, repair=True)
                if out_p is not None:
                    warm_lu = dict(
                        basis0=np.asarray(out_p.basis, np.int32),
                        vstat0=np.asarray(out_p.vstat, np.int32),
                        art_sign0=np.asarray(out_p.art_sign),
                    )
            out = _run_dual_lu_host(
                t, lb.copy(), ub.copy(), warm_lu, repair=True
            )
            # None ⇒ fall through to _run_chunked, which routes to the
            # externally refactorized device primal at this scale
        if out is None:
            if config.perturb > 0:
                # anti-degeneracy: solve with expanded bounds first (ties
                # broken), then clean up against the true bounds from the
                # perturbed optimal basis — same compiled program both times
                lb_p, ub_p = _perturbed_bounds()
                out = _run_chunked(lb_p, ub_p, warm_kwargs, t, max_iter)
                warm_kwargs = dict(
                    basis0=np.asarray(out.basis, np.int32),
                    vstat0=np.asarray(out.vstat, np.int32)[:n_pad],
                    art_sign0=np.asarray(out.art_sign),
                    phase0=np.asarray(out.phase, np.int32),
                )
            out = _run_chunked(lb, ub, warm_kwargs, t, max_iter)

    status = int(out.status)
    kind = st.STATUS_TO_TYPE[status]
    metrics = SolveMetrics(
        status=kind.value,
        iterations=total_done,
        wall_s=t.elapsed,
        m=m,
        n=n,
        m_padded=m_pad,
        n_padded=n_pad,
        art_residual=float(out.art_inf),
        phase=int(out.phase),
        nnz=int(sp.csc_matrix(cf.A).nnz),
        matrix_format=(
            type(A).__name__.replace("Matrix", "").lower()
            if hasattr(A, "matvec") else "dense"
        ),
    )
    trace_arr = np.concatenate(traces) if traces else None
    if trace_arr is not None and len(trace_arr):
        events = trace_arr[:, 5].astype(np.int64)
        is_piv = (events & 1) == 1
        metrics.pivots = int(is_piv.sum())
        metrics.bound_flips = int(((events >> 1) & 1).sum())
        metrics.refresh_iters = int(((events >> 2) & 1).sum())
        metrics.bland_iters = int(((events >> 3) & 1).sum())
        metrics.degenerate_steps = int((is_piv & (trace_arr[:, 4] <= 1e-11)).sum())
    metrics.check_violation = worst_viol
    metrics.refactor_polish, metrics.refactor_newton, metrics.refactor_gj = (
        int(v) for v in refactors
    )
    metrics.emit()
    # duals back in original row units: scaled rows are r_i·(a_i x) = r_i b_i,
    # so y_orig = y_scaled · r_i; a maximization flips the internal sign
    sense = -1.0 if cf.maximize else 1.0
    result = SimplexResult(
        kind=kind,
        iterations=total_done,
        art_residual=float(out.art_inf),
        metrics=metrics,
        duals=sense * np.asarray(out.pi)[:m] * cf.row_scale,
        trace=trace_arr,
        check_violation=worst_viol,
    )
    if getattr(out, "vertex", True):
        # expose the final basis state for checkpointing/reoptimization
        # and post-optimal ranging (analysis/ranging.py)
        result.basis = np.asarray(out.basis)
        result.vstat = np.asarray(out.vstat)
        result.art_sign = np.asarray(out.art_sign)
    if kind is LinearProgramType.FINITE_OPTIMUM:
        x_scaled = np.asarray(out.x)[:n]
        result.objective = cf.objective_of(x_scaled)
        result.x_structural = cf.structural_values(x_scaled)
    return result


def _solve_trivial(cf: ComputationalForm) -> SimplexResult:
    """Handle LPs with no constraints (bounds-only) or no columns."""
    if cf.n == 0:
        # no variables at all: feasible iff b ≈ 0 on every (equality) row
        if cf.m == 0 or np.all(np.abs(cf.b) <= 1e-9):
            # fixed_cost is stored in the ORIGINAL objective sense everywhere
            # (objective_of, compute_full_solution) — no sign flip here
            return SimplexResult(
                kind=LinearProgramType.FINITE_OPTIMUM,
                objective=cf.fixed_cost,
                x_structural=np.zeros(0),
            )
        return SimplexResult(kind=LinearProgramType.INFEASIBLE)

    # m == 0: minimize c@x over the box alone
    x = np.zeros(cf.n)
    for j in range(cf.n):
        cj, lo, hi = cf.c[j], cf.lb[j], cf.ub[j]
        if cj > 0:
            if not np.isfinite(lo):
                return SimplexResult(kind=LinearProgramType.UNBOUNDED)
            x[j] = lo
        elif cj < 0:
            if not np.isfinite(hi):
                return SimplexResult(kind=LinearProgramType.UNBOUNDED)
            x[j] = hi
        else:
            x[j] = lo if np.isfinite(lo) else (hi if np.isfinite(hi) else 0.0)
    return SimplexResult(
        kind=LinearProgramType.FINITE_OPTIMUM,
        objective=cf.objective_of(x),
        x_structural=cf.structural_values(x),
        iterations=0,
    )


def basis_file_warm_start(basis_file, general: GeneralForm, cf: ComputationalForm):
    """Build a warm-start builder from an MPS basis file (io/basis_file.py).

    Statuses are resolved by name against the (possibly presolved) problem;
    rows left uncovered get artificial basis entries, and a singular warm
    basis degrades to a phase-1 repair inside the engine.
    """
    from relp_tpu.io.basis_file import BasisStatus
    from relp_tpu.simplex import status as stt_codes

    var_names = {v.name for v in general.variables}
    col_stat, row_stat = {}, dict(basis_file.row_status)
    for name, s in basis_file.column_status.items():
        if name not in var_names and name in set(general.row_names):
            row_stat[name] = s
        else:
            col_stat[name] = s

    def build(m_pad, n_pad):
        vstat0 = np.full(n_pad, stt_codes.NB_FIXED, np.int32)
        nn = cf.n
        vstat0[:nn] = np.where(
            cf.lb == cf.ub,
            stt_codes.NB_FIXED,
            np.where(
                np.isfinite(cf.lb),
                stt_codes.NB_LOWER,
                np.where(np.isfinite(cf.ub), stt_codes.NB_UPPER, stt_codes.NB_FREE),
            ),
        )
        basic = []

        def apply(j, s):
            if s is BasisStatus.BASIC and len(basic) < m_pad:
                basic.append(j)
                vstat0[j] = stt_codes.BASIC
            elif s is BasisStatus.AT_UPPER and np.isfinite(cf.ub[j]):
                vstat0[j] = stt_codes.NB_UPPER
            elif s is BasisStatus.AT_LOWER and np.isfinite(cf.lb[j]):
                vstat0[j] = stt_codes.NB_LOWER

        for j, v in enumerate(general.variables):
            s = col_stat.get(v.name)
            if s is not None:
                apply(j, s)
        for idx, row_i in enumerate(cf.slack_rows):
            s = row_stat.get(general.row_names[int(row_i)], BasisStatus.BASIC)
            apply(cf.n_structural + int(idx), s)

        remaining = m_pad - len(basic)
        # uncovered slots: artificials — padded rows first, then real rows
        art_rows = list(range(cf.m, m_pad)) + list(range(cf.m))
        basis0 = np.array(
            basic + [n_pad + r for r in art_rows[:remaining]], dtype=np.int32
        )
        return basis0, vstat0

    return build


def solve_general_form(
    general: GeneralForm,
    config: SolverConfig = DEFAULT_CONFIG,
    initial_basis=None,
) -> "GeneralFormResult":
    """End-to-end: GeneralForm → computational form → device solve → Solution.

    Mirrors the reference CLI pipeline (src/bin/main.rs:24-64):
    derive matrix data → solve relaxation → reconstruct → full solution.
    """
    from relp_tpu.model.computational_form import build_computational_form

    trivially = general.trivial_infeasibility()
    if trivially is not None:
        return GeneralFormResult(kind=trivially)

    if config.presolve:
        from relp_tpu.presolve.engine import presolve

        outcome = presolve(general)
        if outcome.status is not None:
            return GeneralFormResult(kind=outcome.status)

    done = general.compute_solution_where_possible()
    if done is not None:
        return GeneralFormResult(kind=LinearProgramType.FINITE_OPTIMUM, solution=done)

    cf = build_computational_form(general, scale=config.scale)
    builder = (
        basis_file_warm_start(initial_basis, general, cf)
        if initial_basis is not None
        else None
    )
    res = solve_computational_form(cf, config, warm_start_builder=builder)
    if not res.is_optimal:
        return GeneralFormResult(
            kind=res.kind, simplex=res, cf=cf, row_names=list(general.row_names)
        )

    reduced: Dict[str, float] = {
        v.name: float(res.x_structural[j]) for j, v in enumerate(general.variables)
    }
    solution = general.compute_full_solution(reduced)
    # Use the (sense-adjusted) device objective, which includes fixed cost.
    solution.objective_value = res.objective
    return GeneralFormResult(
        kind=LinearProgramType.FINITE_OPTIMUM, solution=solution, simplex=res,
        cf=cf, row_names=list(general.row_names),
    )


@dataclass
class GeneralFormResult:
    kind: LinearProgramType
    solution: Optional[Solution] = None
    simplex: Optional[SimplexResult] = None
    # the lowered problem the device solved (None when presolve finished
    # the job) — lets analysis.ranging run off the returned basis
    cf: Optional[object] = None
    # row names of the (presolved) problem the device saw, so api.ranging_of
    # can label rhs ranges like the CLI does
    row_names: Optional[list] = None


def _solve_fleet_pdlp(A, b, c, lb, ub, config: SolverConfig, max_iter: int):
    """First-order fleet engine (config.algorithm="pdlp" through
    :func:`solve_general_forms_batched`): restarted PDHG vmapped over the
    scenario axis with the operator UNBATCHED (``in_axes=None``).

    For the scenario-analysis workload — one base problem, perturbed
    b/c — every per-scenario matvec then fuses into ONE dense
    (m,n)×(n,N) matmul (SURVEY §2.8 "batched solve (DP analogue)").
    f32 rounds with VECTORIZED iterative-refinement zooms (per-scenario dp, same scheme as the
    single-solve driver) and f64 host KKT checks; a scenario is accepted
    at ``config.pdlp_accept`` relative KKT.  A non-shared A stack falls
    back to the per-scenario batched operator (batched GEMV — correct,
    just not GEMM-fused).

    Returns a namespace with per-scenario status/it/art_inf/pi/x, the
    same surface ``solve_batched`` gives the caller.
    """
    import functools
    from types import SimpleNamespace

    import jax.numpy as jnp

    from relp_tpu.fom.pdhg import initial_state, solve_pdhg_chunk
    from relp_tpu.ops.amatrix import DenseMatrix
    from relp_tpu.utils.metrics import logger as _log

    import time

    _t_fleet0 = time.perf_counter()
    A = np.asarray(A, np.float64)
    N = b.shape[0]
    _, m_pad, n_pad = A.shape
    # the caller passes a 1-deep stack when every scenario shares A
    shared = A.shape[0] == 1 or bool(np.all(A[0] == A))

    # Ruiz ∞-norm + one Pock–Chambolle pass (the single-solve recipe) on
    # the shared operator; per-scenario when the stack is heterogeneous
    def _ruiz(M):
        d_r = np.ones(M.shape[0])
        d_c = np.ones(M.shape[1])
        S = np.abs(M)
        for _ in range(10):
            rmax = S.max(axis=1)
            rs = 1.0 / np.sqrt(np.where(rmax > 0, rmax, 1.0))
            S *= rs[:, None]
            cmax = S.max(axis=0)
            cs = 1.0 / np.sqrt(np.where(cmax > 0, cmax, 1.0))
            S *= cs[None, :]
            d_r *= rs
            d_c *= cs
        r1 = S.sum(axis=1)
        rs = 1.0 / np.sqrt(np.where(r1 > 0, r1, 1.0))
        S *= rs[:, None]
        c1 = S.sum(axis=0)
        cs = 1.0 / np.sqrt(np.where(c1 > 0, c1, 1.0))
        d_r *= rs
        d_c *= cs
        return d_r, d_c

    if shared:
        d_r, d_c = _ruiz(A[0])          # (m,), (n,)
        As = d_r[:, None] * A[0] * d_c  # (m, n)
        mat = lambda X: X @ As.T        # noqa: E731  (N,n)→(N,m)
        A_axis = None
    else:
        scal = [_ruiz(A[s]) for s in range(N)]
        d_r = np.stack([s0 for s0, _ in scal])  # (N, m)
        d_c = np.stack([s1 for _, s1 in scal])  # (N, n)
        As = d_r[:, :, None] * A * d_c[:, None, :]
        mat = lambda X: np.einsum("smn,sn->sm", As, X)   # noqa: E731
        A_axis = 0
    B = b * (d_r if not shared else d_r[None, :])
    C = c * (d_c if not shared else d_c[None, :])
    with np.errstate(invalid="ignore"):
        LB = np.where(np.isfinite(lb), lb / (d_c if not shared else d_c[None, :]), lb)
        UB = np.where(np.isfinite(ub), ub / (d_c if not shared else d_c[None, :]), ub)

    # ‖A‖₂ by power iteration (host, f64); non-shared stacks take the max
    # over scenarios so one global η is safe for every subproblem
    v = np.cos(1.7 * np.arange(n_pad) + 0.3) + 0.5
    v /= np.linalg.norm(v)
    V = np.broadcast_to(v, (N if not shared else 1, n_pad)).copy()

    def _aAtA(V_):
        if shared:
            return (V_ @ As.T) @ As
        return np.einsum(
            "smn,sm->sn", As, np.einsum("smn,sn->sm", As, V_)
        )

    for _ in range(30):
        W = _aAtA(V)
        nrm = np.linalg.norm(W, axis=1, keepdims=True)
        V = W / np.maximum(nrm, 1e-300)
    norm_A = float(np.sqrt(
        max(np.max(np.linalg.norm(_aAtA(V), axis=1)), 1e-12)
    ))
    eta0 = 0.9 / norm_A

    A32 = DenseMatrix(jnp.asarray(As, jnp.float32))
    f32 = jnp.float32
    B32, C32, LB32, UB32 = (
        jax.device_put(jnp.asarray(v_, f32)) for v_ in (B, C, LB, UB)
    )
    init_v = jax.jit(jax.vmap(
        functools.partial(initial_state, eta0=eta0, dtype=f32),
        in_axes=(A_axis, 0, 0),
    ))
    init_v64 = jax.jit(jax.vmap(
        functools.partial(initial_state, eta0=eta0),
        in_axes=(A_axis, 0, 0),
    ))

    @jax.jit
    def _ax64(Aop, X):
        if shared:
            return X @ Aop.A.T
        return jnp.einsum("smn,sn->sm", Aop.A, X)

    def _warm_point():
        """One HOST solve of scenario 0 seeds the whole fleet (the
        scenario-analysis warm start): every scenario is a small
        perturbation of the same base, so starting PDHG at the base
        optimum leaves only the perturbation delta to iterate out.  The
        base solve is scipy HiGHS on the lowered (scaled, padded) arrays
        — its wall is charged to the fleet's clock by the caller."""
        try:
            from scipy.optimize import linprog

            A0 = A[0]
            res0 = linprog(
                c[0] if c.ndim == 2 else c,
                A_eq=A0, b_eq=b[0],
                bounds=list(zip(
                    (lb[0] if lb.ndim == 2 else lb),
                    (ub[0] if ub.ndim == 2 else ub),
                )),
                method="highs",
            )
            if res0.status != 0 or res0.eqlin is None:
                return None
            return np.asarray(res0.x), np.asarray(res0.eqlin.marginals)
        except Exception:
            return None
    run = jax.jit(jax.vmap(
        functools.partial(
            solve_pdhg_chunk,
            round_len=int(config.pdlp_round),
            max_rounds=_FLEET_PDLP_ROUNDS,
            tol=float(config.pdlp_tol),
            variant=str(config.pdlp_variant),
        ),
        in_axes=(A_axis, 0, 0, 0, 0, 0),
    ))
    states = init_v(A32, LB32, UB32)

    # ---- device-resident f64 frame: every per-chunk decision transfers
    # only (N,) scalars instead of pulling N·(m+n) f64 to the host. ----
    from relp_tpu.fom.pdhg import _kkt as _kkt_one

    A64 = DenseMatrix(jnp.asarray(As))
    B64, C64, LB64, UB64 = (jnp.asarray(v_) for v_ in (B, C, LB, UB))
    # BASE-frame f32 copies for per-chunk KKT control flow (the zoom-
    # frame B32/C32 vectors describe the SUBPROBLEM, not the composite)
    BF32, CF32, LF32, UF32 = (
        v_.astype(jnp.float32) for v_ in (B64, C64, LB64, UB64)
    )

    kkt_v = jax.vmap(
        lambda Aop, b_, c_, lo_, hi_, x_, y_: _kkt_one(
            Aop, b_, c_, lo_, hi_, x_, y_
        ),
        in_axes=(A_axis, 0, 0, 0, 0, 0, 0),
    )

    # NOTE: the operator and problem vectors are explicit ARGUMENTS of
    # every jitted helper — a closure-captured device array is inlined
    # into the program as a constant (an 80BAU3B-sized f64 operator is
    # 182 MB of program)
    @jax.jit
    def _composite_kkt(Aop, bf, cf_, lf, uf, x32, y32, XBar, YBar, dpd):
        """Composite point in f64; its KKT evaluated in f32 — per-chunk
        decisions tolerate the ~1e-7 f32 eval noise (accept is 1e-6),
        at half the bytes of an f64 evaluation.  One f64 pass at loop exit verifies the
        accept mask exactly."""
        X = XBar + x32.astype(jnp.float64) / dpd[:, None]
        Y = YBar + y32.astype(jnp.float64)
        k = kkt_v(
            Aop, bf, cf_, lf, uf,
            X.astype(jnp.float32), Y.astype(jnp.float32),
        )
        return X, Y, k.astype(jnp.float64)

    @jax.jit
    def _kkt64_final(Aop, bq, cq, lq, uq, bX, bY):
        return kkt_v(Aop, bq, cq, lq, uq, bX, bY)

    @jax.jit
    def _track(bX, bY, bK, X, Y, k):
        imp = k < bK
        return (
            jnp.where(imp[:, None], X, bX),
            jnp.where(imp[:, None], Y, bY),
            jnp.where(imp, k, bK),
        )

    @jax.jit
    def _zoom_arrays(Aop, bq, cq, lq, uq, bX, bY):
        LB64, UB64, B64, C64 = lq, uq, bq, cq
        X = jnp.minimum(jnp.maximum(bX, LB64), UB64)
        if shared:
            r = B64 - X @ Aop.A.T
            d = C64 - bY @ Aop.A
        else:
            r = B64 - jnp.einsum("smn,sn->sm", Aop.A, X)
            d = C64 - jnp.einsum("smn,sm->sn", Aop.A, bY)
        dpd = jnp.clip(
            1.0 / jnp.maximum(jnp.max(jnp.abs(r), axis=1), 1e-14), 1.0, 1e14
        )
        lo = jnp.where(
            jnp.isfinite(LB64),
            jnp.clip((LB64 - X) * dpd[:, None], -1e30, 0.0), -jnp.inf,
        )
        hi = jnp.where(
            jnp.isfinite(UB64),
            jnp.clip((UB64 - X) * dpd[:, None], 0.0, 1e30), jnp.inf,
        )
        return X, bY, dpd, dpd[:, None] * r, d, lo, hi

    accept = float(config.pdlp_accept)
    f32_until = max(10.0 * accept, 100.0 * float(config.pdlp_tol))
    best_kkt = np.full(N, np.inf)
    bX_d = jnp.zeros((N, n_pad))
    bY_d = jnp.zeros((N, m_pad))
    bK_d = jnp.full(N, jnp.inf)
    XBar_d = jnp.zeros((N, n_pad))   # base frame: identity composite
    YBar_d = jnp.zeros((N, m_pad))
    dp_d = jnp.ones(N)
    in_zoom = False
    f32_stage = True
    refines_left = int(config.pdlp_refine)
    kkt_at_refine = np.inf
    best_it = 0
    ref_kmax = np.inf
    last_ok, last_ok_it = 0, 0

    def _promote_to_f64(reason: str) -> bool:
        """f64 endgame for the unaccepted lanes (the single-solve driver's
        _promote_to_f64, fleet-wide): the f32 stage floors near 1e-5
        relative on dense operators (f32 accumulation noise — the DENSE
        fleet froze at 1.9e-5 against accept=1e-6 and every lane fell to
        host cleanup); f64 rounds are only ~2.4× slower per iteration.
        Restarts the fleet state at the best composite, base frame."""
        nonlocal A32, B32, C32, LB32, UB32, states, f32_stage
        nonlocal XBar_d, YBar_d, dp_d, in_zoom, best_it, ref_kmax
        nonlocal refines_left
        if not f32_stage:
            return False
        f32_stage = False
        refines_left = 0  # zooms are an f32-noise tool
        A32 = A64
        B32, C32, LB32, UB32 = B64, C64, LB64, UB64
        XBar_d = jnp.zeros((N, n_pad))
        YBar_d = jnp.zeros((N, m_pad))
        dp_d = jnp.ones(N)
        in_zoom = False
        it_carry = states.it
        X0 = jnp.minimum(jnp.maximum(bX_d, LB64), UB64)
        states = init_v64(A64, LB64, UB64)._replace(
            it=it_carry,
            x=X0, y=bY_d, ax=_ax64(A64, X0),
            x_anchor=X0, y_anchor=bY_d, ax_anchor=_ax64(A64, X0),
        )
        best_it = int(np.max(np.asarray(it_carry)))
        ref_kmax = np.inf
        _log.info("pdlp fleet: f64 endgame (%s)", reason)
        return True

    def _zoom(reason: str):
        nonlocal states, XBar_d, YBar_d, dp_d, refines_left, kkt_at_refine
        nonlocal best_it, ref_kmax, B32, C32, LB32, UB32, in_zoom
        XBar_d, YBar_d, dp_d, bq, cq, lo, hi = _zoom_arrays(
            A64, B64, C64, LB64, UB64, bX_d, bY_d
        )
        B32, C32, LB32, UB32 = (
            v_.astype(f32) for v_ in (bq, cq, lo, hi)
        )
        in_zoom = True
        it_carry = states.it
        states = init_v(A32, LB32, UB32)._replace(it=it_carry)
        refines_left -= 1
        kkt_at_refine = float(np.max(best_kkt))
        best_it = int(np.max(np.asarray(it_carry)))
        ref_kmax = np.inf
        _log.info(
            "pdlp fleet: refinement zoom at it=%d (max dp=%.1e, %s, %d left)",
            best_it, float(jnp.max(dp_d)), reason, refines_left,
        )

    def _dc():
        return d_c if not shared else d_c[None, :]

    if config.pdlp_fleet_warm:
        wp = _warm_point()
        if wp is not None:
            x0, y0 = wp
            # scipy's marginal sign convention is checked empirically:
            # PDHG wants y with reduced costs z = c − Aᵀy sign-feasible
            def _viol(yv):
                z = c[0] - A[0].T @ yv
                v = np.where(
                    (z > 0) & ~np.isfinite(lb[0]), z,
                    np.where((z < 0) & ~np.isfinite(ub[0]), -z, 0.0),
                )
                return float(v.max()) if v.size else 0.0

            if _viol(-y0) < _viol(y0):
                y0 = -y0
            Dr = d_r[None, :] if shared else d_r
            X0 = np.broadcast_to(x0[None, :], (N, n_pad)) / _dc()
            X0 = np.minimum(np.maximum(X0, LB), UB)
            Y0 = np.broadcast_to(y0[None, :], (N, m_pad)) / Dr
            AX0 = jnp.asarray(mat(X0), f32)
            X0j = jnp.asarray(X0, f32)
            Y0j = jnp.asarray(Y0, f32)
            states = states._replace(
                x=X0j, y=Y0j, ax=AX0,
                x_anchor=X0j, y_anchor=Y0j, ax_anchor=AX0,
            )
            _log.info("pdlp fleet: warm-started from a host base solve")

    while True:
        states = run(A32, B32, C32, LB32, UB32, states)
        if f32_stage:
            X_d, Y_d, k_d = _composite_kkt(
                A32, BF32, CF32, LF32, UF32,
                states.x, states.y, XBar_d, YBar_d, dp_d,
            )
        else:
            # f64 endgame: the f32 composite evaluation's dense-row
            # accumulation noise (~1e-6 relative) floors the measured KKT
            # and freezes the best-snapshot tracking while the true state
            # keeps improving — evaluate exactly (base frame, f64)
            X_d, Y_d = states.x, states.y
            k_d = _kkt64_final(A64, B64, C64, LB64, UB64, X_d, Y_d)
        bX_d, bY_d, bK_d = _track(bX_d, bY_d, bK_d, X_d, Y_d, k_d)
        best_kkt = np.asarray(bK_d)
        it_now = int(np.max(np.asarray(states.it)))
        kmax = float(np.max(best_kkt))
        if _log.isEnabledFor(20):
            _log.info(
                "pdlp fleet chunk it=%d kkt max=%.3e med=%.3e "
                "accepted=%d/%d wall=%.1fs",
                it_now, kmax, float(np.median(best_kkt)),
                int((best_kkt <= accept).sum()), N,
                time.perf_counter() - _t_fleet0,
            )
        if kmax < 0.9 * ref_kmax:
            ref_kmax = kmax
            best_it = it_now
        if bool(np.all(best_kkt <= accept)) or it_now >= max_iter:
            break
        can_zoom = (
            refines_left > 0
            and np.isfinite(kmax)
            and kmax < 0.25 * kkt_at_refine
            # a zoom only helps once the f32 PRECISION floor binds; an
            # early oscillation plateau (kkt ~1e-1) is an algorithmic
            # phase the subproblem would inherit unchanged
            and kmax <= max(1e-2, f32_until)
        )
        # f32's observed fleet floor sits just above 1e-5 (relative) —
        # zoom as soon as the base stage enters that territory rather
        # than grinding the plateau window at the floor
        if f32_stage and not in_zoom and kmax <= max(30.0 * accept, f32_until):
            if can_zoom:
                _zoom(f"endgame territory (kkt={kmax:.1e})")
            elif not _promote_to_f64(f"f32 floor at kkt={kmax:.1e}"):
                break  # f32 floor without zoom budget: accept what we have
            continue
        # short window for ZOOMING (the f32-stage heuristic of the
        # single-solve driver), long window for GIVING UP (early PDHG
        # oscillation must not abort the fleet)
        if it_now - best_it >= max(
            int(config.pdlp_plateau) // 4, best_it // 8
        ):
            if can_zoom:
                _zoom(f"plateau at kkt={kmax:.1e}")
                continue
            # zooms exhausted or useless (the post-zoom composite froze
            # on the DENSE fleet): the f64 endgame takes over
            if f32_stage and kmax > accept and _promote_to_f64(
                f"f32 plateau at kkt={kmax:.1e}"
            ):
                continue
        n_ok = int((best_kkt <= accept).sum())
        if n_ok > last_ok:
            last_ok, last_ok_it = n_ok, it_now
        stalled_k = it_now - best_it
        stalled_ok = it_now - last_ok_it
        if (
            n_ok >= 0.9 * N
            and min(stalled_k, stalled_ok) >= int(config.pdlp_plateau) // 4
        ):
            # all but a few stragglers are done: hand those to the host
            # cleanup instead of grinding the full plateau window per
            # scenario (measured: +50k fleet iterations bought +1 accept)
            break
        if (
            stalled_k >= max(int(config.pdlp_plateau), best_it // 2)
            # per-scenario acceptances still arriving count as progress
            # even when the max-KKT straggler is flat
            and stalled_ok >= int(config.pdlp_plateau)
        ):
            if f32_stage and _promote_to_f64(
                f"long plateau at kkt={kmax:.1e}"
            ):
                continue
            break  # floored: per-scenario acceptance decides below

    # exact acceptance: one f64 KKT pass over the best snapshots (the
    # loop's f32 evaluations carry ~1e-7 noise)
    best_kkt = np.asarray(
        _kkt64_final(A64, B64, C64, LB64, UB64, bX_d, bY_d)
    )
    ok = best_kkt <= accept
    x_out = np.asarray(bX_d, np.float64) * _dc()
    pi_out = np.asarray(bY_d, np.float64) * (
        d_r if not shared else d_r[None, :]
    )
    # straggler cleanup: scenarios the fleet could not certify fall back
    # to host HiGHS individually — the fleet call stays exact end-to-end
    # and its wall (the caller times the whole call) charges the cleanup
    host = np.zeros(N, bool)
    if not bool(np.all(ok)):
        from scipy.optimize import linprog

        for s in np.where(~ok)[0]:
            res_s = linprog(
                c[s], A_eq=A[0 if shared else s], b_eq=b[s],
                bounds=list(zip(lb[s], ub[s])), method="highs",
            )
            if res_s.status == 0:
                x_out[s] = res_s.x
                if res_s.eqlin is not None:
                    pi_out[s] = np.asarray(res_s.eqlin.marginals)
                ok[s] = host[s] = True
        _log.info(
            "pdlp fleet: %d straggler(s) solved on host after the fleet "
            "floored", int(host.sum()),
        )
    # raw primal residual against the ORIGINAL (unscaled) stack
    if shared:
        art = np.abs(x_out @ A[0].T - b).max(axis=1)
    else:
        art = np.abs(np.einsum("smn,sn->sm", A, x_out) - b).max(axis=1)
    return SimpleNamespace(
        status=np.where(ok, st.OPTIMAL, st.ITERATION_LIMIT).astype(np.int32),
        it=np.asarray(states.it, np.int32),
        art_inf=art,
        pi=pi_out,
        x=x_out,
        host=host,
    )


def _solve_fleet_ipm(A, b, c, lb, ub, config: SolverConfig, mesh=None):
    """Interior-point fleet engine (config.algorithm="ipm" through
    :func:`solve_general_forms_batched`): the Mehrotra chunk (ipm_chunk)
    vmapped over the scenario axis with the operator UNBATCHED.

    Per iteration the whole fleet does one batched (N,m,n)→(N,m,m)
    normal-equation GEMM and one batched Cholesky — dense work with
    O(√n) iterations per
    scenario regardless of conditioning, where the first-order fleet's
    PDHG tail stalls near 1e-6 relative KKT on dense operators.  Shared-A
    fleets only (the scenario-analysis shape); per-lane b/c/bounds.

    Returns the ``solve_batched``-shaped namespace; lanes the engine
    cannot certify at ``config.ipm_accept`` fall back to host HiGHS,
    charged to the fleet's clock like the PDLP fleet's stragglers.
    """
    import functools
    from types import SimpleNamespace

    import jax.numpy as jnp

    from relp_tpu.simplex.primal_dual import (
        _F32_RUNG_MAX_M, ipm_chunk, ls_start, precision_ladder,
    )
    from relp_tpu.utils.metrics import logger as _log

    N = b.shape[0]
    A0 = np.asarray(A[0], np.float64)
    m_pad, n_pad = A0.shape
    # Ruiz ∞-norm equilibration on the shared operator (the IPM driver's
    # recipe: the f32 Cholesky's conditioning rides on it)
    d_r = np.ones(m_pad)
    d_c = np.ones(n_pad)
    S = np.abs(A0)
    for _ in range(10):
        rmax = S.max(axis=1)
        rs = 1.0 / np.sqrt(np.where(rmax > 0, rmax, 1.0))
        S *= rs[:, None]
        cmax = S.max(axis=0)
        cs = 1.0 / np.sqrt(np.where(cmax > 0, cmax, 1.0))
        S *= cs[None, :]
        d_r *= rs
        d_c *= cs
    As = d_r[:, None] * A0 * d_c
    B = b * d_r[None, :]
    C = c * d_c[None, :]
    with np.errstate(invalid="ignore"):
        LB = np.where(np.isfinite(lb), lb / d_c[None, :], lb)
        UB = np.where(np.isfinite(ub), ub / d_c[None, :], ub)

    free_box = 1e5
    fixed = LB == UB
    free = ~np.isfinite(LB) & ~np.isfinite(UB) & ~fixed
    LBw = np.where(free, -free_box, LB)
    UBw = np.where(free, free_box, UB)
    hl = (np.isfinite(LBw) & ~fixed).astype(np.float64)
    hu = (np.isfinite(UBw) & ~fixed).astype(np.float64)
    dmask = (~fixed).astype(np.float64)
    lbf = np.where(hl > 0, LBw, 0.0)
    ubf = np.where(hu > 0, UBw, 0.0)
    xfix = np.where(fixed, LB, 0.0)
    nb_cnt = (hl + hu).sum(axis=1)
    if np.any(nb_cnt == 0):
        return None

    if mesh is None:
        lanes = rep = None  # default device
    else:
        from jax.sharding import NamedSharding, PartitionSpec as P

        lanes = NamedSharding(mesh, P("batch"))
        rep = NamedSharding(mesh, P())
    A64 = jax.device_put(jnp.asarray(As, jnp.float64), rep)
    ladder = precision_ladder(
        config.ipm_ladder, A64,
        lambda: jax.device_put(jnp.asarray(As, jnp.float32), rep),
    )
    rung = 1 if (len(ladder) > 1 and m_pad > _F32_RUNG_MAX_M) else 0
    # on an accelerator 8 Mehrotra iterations per call spread each host
    # round trip; on the CPU backend there is none to save
    k_max = 1 if jax.default_backend() == "cpu" else 8

    argv = tuple(
        jax.device_put(jnp.asarray(v, jnp.float64), lanes)
        for v in (B, C, lbf, ubf, hl, hu, dmask)
    )
    xfix_d = jax.device_put(jnp.asarray(xfix, jnp.float64), lanes)
    nb_d = jax.device_put(jnp.asarray(nb_cnt, jnp.float64), lanes)
    tol = float(config.ipm_tol)
    accept = float(config.ipm_accept)
    gamma = jnp.float64(0.9995)

    lane_axes = (None, None) + (0,) * 7  # A64, Afac shared; vectors per lane

    def _vstart(fdt, Afac, n_ir):
        f = functools.partial(ls_start, fdt=fdt, n_ir=n_ir)
        return jax.vmap(f, in_axes=lane_axes + (0,))(
            A64, Afac, *argv, xfix_d
        )

    def _vchunk(fdt, Afac, n_ir, state, delta, rho, kkt_ref):
        f = functools.partial(
            ipm_chunk, fdt=fdt, n_ir=n_ir, k_max=k_max,
        )
        return jax.vmap(
            f, in_axes=lane_axes + (0, 0, 0, 0, None, None, 0)
        )(
            A64, Afac, *argv, state, delta, rho, nb_d, gamma,
            jnp.float64(tol), kkt_ref,
        )

    fdt, Afac, n_ir = ladder[rung]
    state = _vstart(fdt, Afac, n_ir)
    if not np.all(np.isfinite(np.asarray(state.x).sum(axis=1))):
        if rung + 1 < len(ladder):
            rung += 1
            fdt, Afac, n_ir = ladder[rung]
            state = _vstart(fdt, Afac, n_ir)

    delta = jnp.full(N, 1e-8)
    rho = jnp.full(N, 1e-10)
    kkt_ref = np.full(N, np.inf)  # per-lane last committed KKT (ir gate)
    best_kkt = np.full(N, np.inf)
    bX = np.zeros((N, n_pad))
    bY = np.zeros((N, m_pad))
    it = 0
    stall = 0
    max_iter = int(config.ipm_max_iter)
    import time as _t

    t0 = _t.perf_counter()
    while it < max_iter:
        out = _vchunk(
            fdt, Afac, n_ir, state, delta, rho,
            jnp.asarray(kkt_ref, jnp.float64),
        )
        state, delta, rho = out.state, out.delta, out.rho
        it += int(np.max(np.asarray(out.committed)))
        d = out.diag
        lane_kkt = np.maximum(
            np.maximum(np.asarray(d.rp), np.asarray(d.rd)), np.asarray(d.gap)
        )
        committed_lanes = np.asarray(out.committed) > 0
        kkt_ref = np.where(
            committed_lanes & np.isfinite(lane_kkt), lane_kkt, kkt_ref
        )
        ck = np.asarray(out.best_kkt)
        imp = ck < best_kkt
        if np.any(imp):
            bx = np.asarray(out.best_x)
            by = np.asarray(out.best_y)
            bX[imp] = bx[imp]
            bY[imp] = by[imp]
        progress = bool(np.any(ck < 0.9 * best_kkt))
        best_kkt = np.minimum(best_kkt, ck)
        n_ok = int((best_kkt <= accept).sum())
        if _log.isEnabledFor(20):
            _log.info(
                "ipm fleet it=%d kkt max=%.3e med=%.3e accepted=%d/%d "
                "wall=%.1fs", it, float(np.max(best_kkt)),
                float(np.median(best_kkt)), n_ok, N,
                _t.perf_counter() - t0,
            )
        if n_ok == N:
            break
        bad = int(np.asarray(out.bad).max())
        committed = int(np.asarray(out.committed).min())
        stall = 0 if progress else stall + 1
        if (bad >= 3 or committed == 0 or stall >= 2) and rung + 1 < len(
            ladder
        ):
            rung += 1
            fdt, Afac, n_ir = ladder[rung]
            stall = 0
            _log.info("ipm fleet: precision ladder → %s", np.dtype(fdt).name)
            continue
        if stall >= 4:
            break

    # free-variable box check per lane (a binding temporary box is not a
    # certificate for the original problem)
    if free.any():
        box_bind = (np.abs(bX) >= 0.5 * free_box) & free
        best_kkt = np.where(box_bind.any(axis=1), np.inf, best_kkt)
    ok = best_kkt <= accept
    x_out = bX * d_c[None, :]
    pi_out = bY * d_r[None, :]
    host = np.zeros(N, bool)
    if not bool(np.all(ok)):
        from scipy.optimize import linprog

        for s in np.where(~ok)[0]:
            res_s = linprog(
                c[s], A_eq=A0, b_eq=b[s],
                bounds=list(zip(lb[s], ub[s])), method="highs",
            )
            if res_s.status == 0:
                x_out[s] = res_s.x
                if res_s.eqlin is not None:
                    pi_out[s] = np.asarray(res_s.eqlin.marginals)
                ok[s] = host[s] = True
        _log.info(
            "ipm fleet: %d straggler(s) solved on host", int(host.sum()),
        )
    art = np.abs(x_out @ A0.T - b).max(axis=1)
    return SimpleNamespace(
        status=np.where(ok, st.OPTIMAL, st.ITERATION_LIMIT).astype(np.int32),
        it=np.full(N, it, np.int32),
        art_inf=art,
        pi=pi_out,
        x=x_out,
        host=host,
    )


def solve_general_forms_batched(
    generals, config: SolverConfig = DEFAULT_CONFIG, mesh=None,
) -> "list[GeneralFormResult]":
    """Solve a fleet of LPs in one vmapped device program (the
    data-parallel analogue; no reference counterpart — SURVEY §2.8).

    Problems are presolved individually on host, lowered, padded to a
    common shape bucket, stacked, and solved by ``jax.vmap`` over the
    scenario axis.  With a ``mesh`` (``parallel.mesh.make_solver_mesh``)
    the scenario axis is sharded over its 'batch' axis — the primal core
    and the interior-point fleet; the first-order fleet runs unsharded.
    Problems that presolve resolves completely (or proves
    infeasible/unbounded) skip the device entirely.
    """
    from relp_tpu.model.computational_form import build_computational_form
    from relp_tpu.parallel.batched import solve_batched

    results: "list[Optional[GeneralFormResult]]" = [None] * len(generals)
    device_jobs = []  # (index, general, cf)
    for idx, general in enumerate(generals):
        trivially = general.trivial_infeasibility()
        if trivially is not None:
            results[idx] = GeneralFormResult(kind=trivially)
            continue
        if config.presolve:
            from relp_tpu.presolve.engine import presolve

            outcome = presolve(general)
            if outcome.status is not None:
                results[idx] = GeneralFormResult(kind=outcome.status)
                continue
        done = general.compute_solution_where_possible()
        if done is not None:
            results[idx] = GeneralFormResult(
                kind=LinearProgramType.FINITE_OPTIMUM, solution=done
            )
            continue
        cf = build_computational_form(general, scale=config.scale)
        if cf.m == 0 or cf.n == 0:
            res = _solve_trivial(cf)
            results[idx] = _finish_general(general, cf, res)
            continue
        device_jobs.append((idx, general, cf))

    # group device jobs by per-instance shape bucket: a mixed-size suite
    # (19 Netlib instances spanning 64..1024 rows) padded to ONE global
    # max shape would run every small instance at the big instance's
    # O(m²)-per-iteration cost AND for the big instance's iteration count
    # (a vmapped while_loop runs until the LAST lane converges).  Same-
    # shape scenario fleets still land in one group, so the shared-A fast
    # path is unchanged.
    groups: "dict[tuple[int, int], list]" = {}
    for job in device_jobs:
        cf_j = job[2]
        if config.bucket_shapes:
            key = (
                _bucket(cf_j.m, config.row_align * 8),
                _bucket(cf_j.n, config.col_align * 2),
            )
        else:
            key = (
                _round_up(cf_j.m, config.row_align),
                _round_up(cf_j.n, config.col_align),
            )
        groups.setdefault(key, []).append(job)


    from relp_tpu.utils.metrics import logger as _blog

    for (m_pad, n_pad), device_jobs in groups.items():
        import time as _time

        _t_grp = _time.perf_counter()
        batch = len(device_jobs)
        if batch == 1 and config.algorithm != "pdlp":
            # a singleton group gains nothing from vmap — give it the
            # full single-solve driver (devex + mixed/partial pricing +
            # tuned chunking), which the vmapped core deliberately omits
            idx, general, cf_1 = device_jobs[0]
            res_1 = solve_computational_form(cf_1, config)
            results[idx] = _finish_general(general, cf_1, res_1)
            if _blog.isEnabledFor(20):
                _blog.info(
                    "batched group (%d,%d) singleton→single-driver "
                    "it=%d wall=%.2fs", m_pad, n_pad, res_1.iterations,
                    _time.perf_counter() - _t_grp,
                )
            continue
        # scenario fleets share A (perturbed b/c only): stack A once —
        # a dense (batch, m, n) stack is ~11 GB at 256×SCTAP3 scale
        cscs = [sp.csc_matrix(cf.A) for _, _, cf in device_jobs]
        shared_A = all(
            csc.shape == cscs[0].shape
            and np.array_equal(csc.indptr, cscs[0].indptr)
            and np.array_equal(csc.indices, cscs[0].indices)
            and np.array_equal(csc.data, cscs[0].data)
            for csc in cscs[1:]
        )
        A = np.zeros((1 if shared_A else batch, m_pad, n_pad))
        b = np.zeros((batch, m_pad))
        c = np.zeros((batch, n_pad))
        lb = np.zeros((batch, n_pad))
        ub = np.zeros((batch, n_pad))
        for s_i, (_, _, cf) in enumerate(device_jobs):
            if s_i == 0 or not shared_A:
                A[s_i, : cf.m, : cf.n] = cscs[s_i].toarray()
            b[s_i, : cf.m] = cf.b
            c[s_i, : cf.n] = cf.c
            lb[s_i, : cf.n] = cf.lb
            ub[s_i, : cf.n] = cf.ub
        if config.algorithm == "ipm" and shared_A:
            outs = _solve_fleet_ipm(A, b, c, lb, ub, config, mesh=mesh)
            if outs is None:  # no finite-bound pair anywhere: trivial
                outs = _solve_fleet_pdlp(
                    A, b, c, lb, ub, config, 1_000_000
                )
        elif config.algorithm in ("pdlp", "ipm"):
            # first-order budget (the simplex resolve_max_iter heuristic is
            # pivot-count-sized; PDHG iterations are 1000× cheaper and
            # proportionally more numerous).  algorithm="ipm" without a
            # shared A also lands here (the batched normal equations need
            # the one-operator scenario shape).
            fo_budget = config.max_iter if config.max_iter > 0 else 1_000_000
            outs = _solve_fleet_pdlp(A, b, c, lb, ub, config, fo_budget)
        else:
            max_iter = config.resolve_max_iter(m_pad, n_pad)
            # express every lane's start through the warm signature (the
            # single driver's trick: one compiled program per shape):
            # slack-crash each lane; a shared-A scenario fleet instead
            # warm-starts every lane from ONE single-driver base solve —
            # perturbed scenarios are a few phase-1 repair pivots from
            # the base optimum, not a cold two-phase solve.
            basis0 = np.tile(
                n_pad + np.arange(m_pad, dtype=np.int32), (batch, 1)
            )
            vstat0 = np.where(
                lb == ub,
                st.NB_FIXED,
                np.where(
                    np.isfinite(lb),
                    st.NB_LOWER,
                    np.where(np.isfinite(ub), st.NB_UPPER, st.NB_FREE),
                ),
            ).astype(np.int32)
            warmed_from_base = False
            if shared_A and batch > 1 and config.pdlp_fleet_warm:
                res0 = solve_computational_form(device_jobs[0][2], config)
                if res0.basis is not None and res0.is_optimal:
                    basis0[:] = np.asarray(res0.basis, np.int32)[None, :]
                    vstat0[:] = np.asarray(res0.vstat, np.int32)[None, :n_pad]
                    warmed_from_base = True
            if not warmed_from_base and config.crash_basis:
                for s_i, (_, _, cf) in enumerate(device_jobs):
                    if len(cf.slack_rows):
                        rows = np.asarray(cf.slack_rows, np.int64)
                        cols = cf.n_structural + np.arange(
                            len(rows), dtype=np.int32
                        )
                        basis0[s_i, rows] = cols
                        vstat0[s_i, cols] = st.BASIC
            at_low = (vstat0 == st.NB_LOWER) | (vstat0 == st.NB_FIXED)
            x0 = np.where(
                at_low, lb, np.where(vstat0 == st.NB_UPPER, ub, 0.0)
            )
            x0 = np.where(vstat0 == st.BASIC, 0.0, x0)
            r0 = b.copy()
            for s_i, (_, _, cf) in enumerate(device_jobs):
                r0[s_i, : cf.m] -= cscs[s_i] @ x0[s_i, : cf.n]
            warm = dict(
                basis0=basis0,
                vstat0=vstat0,
                art_sign0=np.where(r0 >= 0, 1.0, -1.0),
                phase0=np.ones(batch, np.int32),
            )
            if shared_A and batch > 1:
                # 2-D A ⇒ solve_batched vmaps it with in_axes=None: ONE
                # device copy, per-lane matvecs fused into GEMMs
                A = A[0]
            outs = solve_batched(
                A, b, c, lb, ub, cfg=config, max_iter=max_iter, warm=warm,
                mesh=mesh,
            )
        for s_i, (idx, general, cf) in enumerate(device_jobs):
            status = int(outs.status[s_i])
            kind = st.STATUS_TO_TYPE[status]
            host = getattr(outs, "host", None)
            res = SimplexResult(
                kind=kind,
                iterations=int(outs.it[s_i]),
                art_residual=float(outs.art_inf[s_i]),
                host_fallback=bool(host is not None and host[s_i]),
                # same unscaling/sign convention as the single-solve path:
                # duals documented as ORIGINAL row units
                duals=(-1.0 if cf.maximize else 1.0)
                * np.asarray(outs.pi[s_i])[: cf.m]
                * cf.row_scale,
            )
            if kind is LinearProgramType.FINITE_OPTIMUM:
                x_scaled = np.asarray(outs.x[s_i])[: cf.n]
                res.objective = cf.objective_of(x_scaled)
                res.x_structural = cf.structural_values(x_scaled)
            results[idx] = _finish_general(general, cf, res)
        if _blog.isEnabledFor(20):
            _blog.info(
                "batched group (%d,%d) batch=%d shared_A=%s max_it=%d "
                "wall=%.2fs", m_pad, n_pad, batch, shared_A,
                int(np.max(np.asarray(outs.it))),
                _time.perf_counter() - _t_grp,
            )

    return results  # type: ignore[return-value]


def _finish_general(general: GeneralForm, cf, res: SimplexResult) -> GeneralFormResult:
    if not res.is_optimal:
        return GeneralFormResult(kind=res.kind, simplex=res, cf=cf)
    reduced = {
        v.name: float(res.x_structural[j]) for j, v in enumerate(general.variables)
    }
    solution = general.compute_full_solution(reduced)
    solution.objective_value = res.objective
    return GeneralFormResult(
        kind=LinearProgramType.FINITE_OPTIMUM, solution=solution, simplex=res,
        cf=cf,
    )
