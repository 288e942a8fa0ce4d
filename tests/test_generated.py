"""The seeded LP families (relp_tpu/models/generated.py): structure,
feasibility and boundedness, and small solves against HiGHS."""

import numpy as np
import pytest

from relp_tpu.models.generated import (
    dense_allocation_lp,
    general_arrays,
    highs_objective,
    lagrangian_bound,
    sparse_box_lp,
    sparse_box_matrix,
)
from relp_tpu.simplex.driver import solve_general_form
from relp_tpu.utils.config import SolverConfig

FAMILIES = {
    "sparse_box": lambda: sparse_box_lp(40, 120),
    "sparse_box_scenario": lambda: sparse_box_lp(40, 120, scenario=5),
    "dense_allocation": lambda: dense_allocation_lp(16, 32),
    "dense_allocation_scenario": lambda: dense_allocation_lp(16, 32, scenario=2),
}


def test_sparse_box_structure():
    A = sparse_box_matrix(300, 900, nnz_per_col=5)
    counts = np.diff(A.indptr)
    assert counts.max() <= 6 and counts.mean() > 4.5
    assert (np.diff(A.tocsr().indptr) > 0).all()  # no empty row
    vals = np.abs(A.data)
    assert vals.min() >= 0.1 - 1e-12 and vals.max() <= 1.0 + 1e-12
    again = sparse_box_matrix(300, 900, nnz_per_col=5)
    assert (A != again).nnz == 0  # seeded


def test_scenarios_share_a():
    g0, g1 = sparse_box_lp(40, 120, scenario=0), sparse_box_lp(40, 120, scenario=1)
    assert (g0.A != g1.A).nnz == 0
    assert not np.allclose(g0.b, g1.b)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_feasible_and_bounded(family):
    general = FAMILIES[family]()
    A, b, c, lower, upper = general_arrays(general)
    assert np.isfinite(lower).all() and np.isfinite(upper).all()
    assert np.isfinite(highs_objective(general))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_solves_to_highs_objective(family):
    ref = highs_objective(FAMILIES[family]())
    res = solve_general_form(FAMILIES[family](), SolverConfig())
    assert res.solution is not None
    got = res.solution.objective_value
    assert abs(got - ref) <= 1e-6 * max(1.0, abs(ref))


def test_lagrangian_bound_brackets_the_optimum():
    general = sparse_box_lp(40, 120)
    arrays = general_arrays(general)
    opt = highs_objective(general)
    rng = np.random.default_rng(3)
    for _ in range(5):
        assert lagrangian_bound(arrays, rng.standard_normal(40)) <= opt + 1e-9
    res = solve_general_form(sparse_box_lp(40, 120), SolverConfig())
    y = np.zeros(40)
    for name, dual in zip(res.row_names, res.simplex.duals):
        y[int(name[1:])] = dual
    best = max(lagrangian_bound(arrays, y), lagrangian_bound(arrays, -y))
    assert abs(best - opt) <= 1e-7 * max(1.0, abs(opt))
