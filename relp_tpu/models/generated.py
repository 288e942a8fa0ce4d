"""Seeded LP families built in the repository.

The repository ships no problem file, so benchmarks, tests and the chip
smoke run build their instances here from a seed.  Each family is named by
its structure, and every instance is feasible and bounded by construction:

- :func:`sparse_box_lp` — a sparse box-bounded equality LP: ``A x = b``
  with about ``nnz_per_col`` nonzeros ±U(0.1, 1) per column at seeded rows
  (every row gets at least one), ``0 ≤ x ≤ 2``, ``b = A·x_feas`` with
  ``x_feas ~ U(0.2, 1)`` and costs N(0, 1).
- :func:`dense_allocation_lp` — a dense resource-allocation LP:
  ``min cᵀx  s.t.  A x = demand, 0 ≤ x ≤ 2`` with a 100%-dense technology
  matrix U(0.05, 1), demand ``A·x_feas`` and costs U(0.1, 1).

Both take a ``scenario`` index: scenario ``s`` keeps ``A`` and perturbs the
feasible point (hence ``b``) and the costs by ``1 + spread·z`` with seeded
normal ``z`` — the shared-A scenario fleet the batched engines serve.
Scenario ``None`` is the unperturbed base.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp

from relp_tpu.model.elements import Objective, RangedConstraintRelation
from relp_tpu.model.general_form import GeneralForm, Variable

SPARSE_BOX_SEED = 0x5B0C5
DENSE_ALLOCATION_SEED = 0xDE55E
SCENARIO_SPREAD = 0.03
UPPER = 2.0


def _scenario_factors(seed: int, scenario: Optional[int], n: int, spread: float):
    """Multiplicative (x_feas, cost) perturbations of one scenario."""
    if scenario is None:
        return np.ones(n), np.ones(n)
    rng = np.random.default_rng([seed, 1 + scenario])
    return (
        1.0 + spread * rng.standard_normal(n),
        1.0 + spread * rng.standard_normal(n),
    )


def _general(A, b, c, name: str) -> GeneralForm:
    m, n = A.shape
    eq = RangedConstraintRelation.equal()
    return GeneralForm(
        objective=Objective.MINIMIZE,
        A=A,
        constraint_types=[eq] * m,
        b=b,
        variables=[
            Variable(f"x{j}", cost=float(c[j]), lower=0.0, upper=UPPER)
            for j in range(n)
        ],
        name=name,
    )


def sparse_box_matrix(m: int, n: int, seed: int = SPARSE_BOX_SEED,
                      nnz_per_col: int = 5) -> sp.csc_matrix:
    """The sparse family's constraint matrix (a row drawn twice for one
    column counts once, so a column holds at most ``nnz_per_col``
    nonzeros, plus one where it covers an otherwise empty row)."""
    rng = np.random.default_rng(seed)
    k = nnz_per_col
    rows = rng.integers(0, m, (n, k))
    cols = np.repeat(np.arange(n), k)
    vals = rng.uniform(0.1, 1.0, n * k) * rng.choice((-1.0, 1.0), n * k)
    rows = rows.ravel()
    # every row needs a nonzero: give each empty row one entry in a
    # seeded column
    empty = np.setdiff1d(np.arange(m), rows)
    rows = np.concatenate([rows, empty])
    cols = np.concatenate([cols, rng.integers(0, n, len(empty))])
    vals = np.concatenate([
        vals,
        rng.uniform(0.1, 1.0, len(empty)) * rng.choice((-1.0, 1.0), len(empty)),
    ])
    # a row drawn twice for one column keeps its first coefficient
    _, first = np.unique(cols * m + rows, return_index=True)
    return sp.csc_matrix(
        (vals[first], (rows[first], cols[first])), shape=(m, n)
    )


def sparse_box_lp(m: int, n: int, seed: int = SPARSE_BOX_SEED, *,
                  nnz_per_col: int = 5, scenario: Optional[int] = None,
                  spread: float = SCENARIO_SPREAD) -> GeneralForm:
    """One instance of the sparse box-bounded equality family."""
    A = sparse_box_matrix(m, n, seed, nnz_per_col)
    rng = np.random.default_rng([seed, 0])
    x_feas = rng.uniform(0.2, 1.0, n)
    c = rng.standard_normal(n)
    fx, fc = _scenario_factors(seed, scenario, n, spread)
    x_s = np.clip(x_feas * fx, 0.0, UPPER)
    tag = "" if scenario is None else f"_s{scenario}"
    return _general(A, A @ x_s, c * fc, f"sparse_box_{m}x{n}_{seed:x}{tag}")


def dense_allocation_lp(m: int = 768, n: int = 1536,
                        seed: int = DENSE_ALLOCATION_SEED, *,
                        scenario: Optional[int] = None,
                        spread: float = SCENARIO_SPREAD) -> GeneralForm:
    """One instance of the dense allocation family."""
    rng = np.random.default_rng(seed)
    A_d = rng.uniform(0.05, 1.0, (m, n))
    x_feas = rng.uniform(0.2, 1.0, n)
    c = rng.uniform(0.1, 1.0, n)
    fx, fc = _scenario_factors(seed, scenario, n, spread)
    x_s = np.clip(x_feas * fx, 0.0, UPPER)
    tag = "" if scenario is None else f"_s{scenario}"
    return _general(
        sp.csc_matrix(A_d), A_d @ x_s, c * fc,
        f"dense_allocation_{m}x{n}_{seed:x}{tag}",
    )


def general_arrays(general: GeneralForm):
    """``(A, b, c, lower, upper)`` of a minimizing all-equality instance —
    the form :func:`highs_solve` takes (and pickles to a worker)."""
    if general.objective is not Objective.MINIMIZE or general.fixed_cost:
        raise ValueError("general_arrays: minimization without fixed cost only")
    if any(t != RangedConstraintRelation.equal() for t in general.constraint_types):
        raise ValueError("general_arrays: equality rows only")
    return (
        general.A, general.b,
        np.array([v.cost for v in general.variables]),
        np.array([v.lower for v in general.variables]),
        np.array([v.upper for v in general.variables]),
    )


def highs_solve(arrays) -> float:
    """Optimal objective of ``min cᵀx, A x = b, lower ≤ x ≤ upper`` from
    scipy's HiGHS on the host in f64 — the plain reference for these
    families.  HiGHS's interior point with its crossover: it returns a
    vertex and runs several times faster than its dual simplex on them."""
    from scipy.optimize import linprog

    A, b, c, lower, upper = arrays
    res = linprog(c, A_eq=A, b_eq=b, bounds=np.column_stack([lower, upper]),
                  method="highs-ipm")
    if res.status != 0:
        raise RuntimeError(f"HiGHS failed: {res.message}")
    return float(res.fun)


def lagrangian_bound(arrays, y) -> float:
    """A lower bound on the optimum of ``min cᵀx, A x = b, lower ≤ x ≤
    upper`` (finite boxes) that holds for ANY row multipliers ``y``:
    ``bᵀy + Σ_j min over the box of (c − Aᵀy)_j x_j``.  With the duals a
    solver returns, it certifies how far that solver's objective can be
    from the optimum — the reference where HiGHS is too slow."""
    A, b, c, lower, upper = arrays
    d = c - A.T @ y
    return float(b @ y + np.sum(np.where(d > 0, d * lower, d * upper)))


def highs_objective(general: GeneralForm) -> float:
    """:func:`highs_solve` of a generated instance."""
    return highs_solve(general_arrays(general))
