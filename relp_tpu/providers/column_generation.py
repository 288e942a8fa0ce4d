"""Lazy column generation: masked pricing over a growing HBM column pool.

Counterpart of the reference's core extension point — providers presenting
"astronomically many" virtual columns (tableau/mod.rs:188-191) exercised by
``examples/column_range.rs``.  The device realization:

- the *master* LP is the current pool, solved fully on device;
- between device solves, a host-side ``generator(pi, pool)`` prices the
  virtual column family against the optimal duals and returns improving
  columns (negative reduced cost), or None when priced out;
- re-solves warm-start from the previous basis (reference
  ``IM::from_basis`` path, carry/mod.rs:428-463) — the old basis stays
  feasible because the pool only grows.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np

from relp_tpu.model.elements import LinearProgramType
from relp_tpu.providers.base import ColumnPool
from relp_tpu.simplex import status as st
from relp_tpu.simplex.core import solve_core
from relp_tpu.utils.config import DEFAULT_CONFIG, SolverConfig

# generator(pi, pool) -> None | (A_new, c_new, lb_new, ub_new, names)
Generator = Callable[[np.ndarray, ColumnPool], Optional[Tuple]]


@dataclass
class ColumnGenerationResult:
    kind: LinearProgramType
    objective: Optional[float]
    x: Optional[np.ndarray]  # over the final pool's columns
    pool: ColumnPool
    rounds: int
    total_iterations: int


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult if x > 0 else mult


def _pad(pool: ColumnPool, config: SolverConfig):
    A, b, c, lb, ub = pool.masked_arrays()
    m, n = A.shape
    mp = _round_up(m, config.row_align)
    npad = _round_up(n, config.col_align)
    Ap = np.zeros((mp, npad))
    Ap[:m, :n] = A
    bp = np.zeros(mp)
    bp[:m] = b
    cp = np.zeros(npad)
    cp[:n] = c
    lbp = np.zeros(npad)
    ubp = np.zeros(npad)
    lbp[:n] = lb
    ubp[:n] = ub
    return Ap, bp, cp, lbp, ubp, m, n, mp, npad


def solve_with_column_generation(
    pool: ColumnPool,
    generator: Generator,
    config: SolverConfig = DEFAULT_CONFIG,
    max_rounds: int = 100,
) -> ColumnGenerationResult:
    total_iters = 0
    warm = None  # (basis over old layout, vstat over old layout, n_old, np_old)

    for round_idx in range(max_rounds):
        Ap, bp, cp, lbp, ubp, m, n, mp, npad = _pad(pool, config)
        max_iter = config.resolve_max_iter(mp, npad)

        if warm is None:
            out = solve_core(Ap, bp, cp, lbp, ubp, cfg=config, max_iter=max_iter)
        else:
            basis_old, vstat_old, n_old, np_old = warm
            # structural indices are stable (pool only appends); artificial
            # indices shift with the padded column count
            basis0 = np.where(
                basis_old >= np_old, basis_old - np_old + npad, basis_old
            ).astype(np.int32)
            vstat0 = np.full(npad, st.NB_FIXED, np.int32)
            vstat0[:n] = np.where(
                lbp[:n] == ubp[:n],
                st.NB_FIXED,
                np.where(
                    np.isfinite(lbp[:n]),
                    st.NB_LOWER,
                    np.where(np.isfinite(ubp[:n]), st.NB_UPPER, st.NB_FREE),
                ),
            )
            vstat0[:n_old] = vstat_old[:n_old]  # preserve at-upper statuses
            out = solve_core(
                Ap, bp, cp, lbp, ubp,
                cfg=config, max_iter=max_iter,
                basis0=basis0, vstat0=vstat0,
            )

        total_iters += int(out.it)
        status = int(out.status)
        if status != st.OPTIMAL:
            return ColumnGenerationResult(
                kind=st.STATUS_TO_TYPE[status],
                objective=None,
                x=None,
                pool=pool,
                rounds=round_idx + 1,
                total_iterations=total_iters,
            )

        pi = np.asarray(out.pi)[:m]
        new = generator(pi, pool)
        if new is None:
            x = np.asarray(out.x)[: pool.nr_columns]
            return ColumnGenerationResult(
                kind=LinearProgramType.FINITE_OPTIMUM,
                objective=float(pool.c @ x),
                x=x,
                pool=pool,
                rounds=round_idx + 1,
                total_iterations=total_iters,
            )

        warm = (np.asarray(out.basis), np.asarray(out.vstat), n, npad)
        pool = pool.with_columns(*new)

    return ColumnGenerationResult(
        kind=LinearProgramType.ITERATION_LIMIT,
        objective=None,
        x=None,
        pool=pool,
        rounds=max_rounds,
        total_iterations=total_iters,
    )
