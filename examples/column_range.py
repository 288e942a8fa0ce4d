"""Lazy column generation with warm starts — the counterpart of the
reference's ``examples/column_range.rs`` exemplar (hand-built provider,
hand-picked initial basis, ``IM::from_basis``, phase-2-only solves).

A cutting-stock LP whose pattern family is priced lazily: the master runs
on device, the knapsack pricing runs on host, each re-solve warm-starts
from the previous basis.

Run:  JAX_PLATFORMS=cpu python examples/column_range.py
"""

import itertools
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import relp_tpu  # noqa: F401,E402
from relp_tpu.providers.base import ColumnPool
from relp_tpu.providers.column_generation import solve_with_column_generation
from relp_tpu.utils.config import SolverConfig

INF = float("inf")
WIDTH = 100.0
SIZES = np.array([45.0, 36.0, 31.0, 14.0])
DEMAND = np.array([97.0, 610.0, 395.0, 211.0])


def pricing(pi, pool):
    best_val, best = -1.0, None
    maxes = (WIDTH // SIZES).astype(int)
    for combo in itertools.product(*[range(mx + 1) for mx in maxes]):
        a = np.array(combo, dtype=float)
        if a @ SIZES <= WIDTH:
            val = float(pi @ a)
            if val > best_val + 1e-12:
                best_val, best = val, a
    if best is None or best_val <= 1.0 + 1e-7:
        return None  # priced out: current master is optimal
    return best.reshape(-1, 1), [1.0], [0.0], [INF], None


def main():
    m = len(DEMAND)
    init = np.diag((WIDTH // SIZES).astype(float))  # single-size patterns
    pool = ColumnPool(
        A=np.concatenate([init, -np.eye(m)], axis=1),
        b=DEMAND.copy(),
        c=np.concatenate([np.ones(m), np.zeros(m)]),
        lb=np.zeros(2 * m),
        ub=np.full(2 * m, INF),
        names=[f"p{j}" for j in range(m)] + [f"s{i}" for i in range(m)],
    )
    result = solve_with_column_generation(pool, pricing, SolverConfig(scale=False))
    print(f"status      {result.kind.value}")
    print(f"objective   {result.objective:.6f} rolls (LP bound)")
    print(f"cg rounds   {result.rounds}")
    print(f"simplex its {result.total_iterations}")
    print(f"pool size   {result.pool.nr_columns} columns")


if __name__ == "__main__":
    main()
