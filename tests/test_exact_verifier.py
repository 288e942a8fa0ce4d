"""Exact-arithmetic verification of device solutions (SURVEY §2.1 plan:
float64 solve + CPU-side exact certification)."""

from fractions import Fraction

import pytest

import relp_tpu  # noqa: F401
from relp_tpu.api import solve
from relp_tpu.model.elements import LinearProgramType
from relp_tpu.numerics.exact import ExactVerifier
from tests.conftest import reference_problem


@pytest.mark.parametrize("suite,name", [
    ("burkardt", "afiro.mps"),
    ("burkardt", "testprob.mps"),
    ("netlib", "SC50B.SIF"),
])
def test_exact_residuals_small(suite, name):
    path = reference_problem(suite, name)
    res = solve(path)
    assert res.kind is LinearProgramType.FINITE_OPTIMUM
    check = ExactVerifier(path).check(res.solution.as_dict())
    assert check.ok(tol=1e-6), (
        float(check.max_row_violation),
        float(check.max_bound_violation),
    )
    # exact objective of the float solution matches the reported one
    assert float(check.objective) == pytest.approx(
        res.solution.objective_value, abs=1e-6 * (1 + abs(res.solution.objective_value))
    )


def test_exact_objective_testprob_is_54():
    path = reference_problem("burkardt", "testprob.mps")
    res = solve(path)
    check = ExactVerifier(path).check(res.solution.as_dict())
    # testprob's optimum is integral; the float solution should be exact
    assert check.objective == Fraction(54)


@pytest.mark.parametrize("suite,name", [
    ("burkardt", "afiro.mps"),
    ("burkardt", "adlittle.mps"),
    ("netlib", "SC50B.SIF"),
])
def test_exact_optimality_certificate(suite, name):
    """Round-2 verdict item 5: the returned basis is certified OPTIMAL in
    exact rational arithmetic (zero-tolerance primal bounds + reduced-cost
    signs) — the guarantee the reference gets from rational arithmetic by
    construction (tests/burkardt/test.rs:50)."""
    from relp_tpu.numerics.exact import certify_optimal_basis

    res = solve(reference_problem(suite, name))
    cert = certify_optimal_basis(res.cf, res.simplex)
    assert cert.basis_nonsingular
    assert cert.max_primal_violation == 0
    assert cert.max_dual_violation == 0
    assert cert.ok()
    # the exact objective of the certified basis matches the float result
    assert float(cert.objective) == pytest.approx(
        res.solution.objective_value,
        abs=1e-9 * (1 + abs(res.solution.objective_value)),
    )


@pytest.mark.parametrize("name,max_expected_pivots", [
    ("BOEING2.SIF", 8),    # float basis ~1e-16 out of exact optimality
    ("SCORPION.SIF", 12),  # + 18 numerically redundant rows (the rows the
    #                        reference's phase 1 would prove dependent and
    #                        remove; f64 rounding breaks exact dependency)
])
def test_polish_to_certified(name, max_expected_pivots):
    """Round-5: the exact polish finishes a float-optimal basis into an
    EXACTLY optimal one (the reference's by-construction phase-2 contract,
    phase_two.rs:22-51, recovered a posteriori with exact pivots over Q)."""
    from relp_tpu.numerics.exact import (
        certify_optimal_basis, polish_to_certified,
    )

    res = solve(reference_problem("netlib", name))
    cert, piv = polish_to_certified(res.cf, res.simplex)
    assert cert.ok(), (
        float(cert.max_primal_violation), float(cert.max_dual_violation),
    )
    assert piv <= max_expected_pivots
    # the written-back basis re-certifies standalone (no pivots needed)
    cert2 = certify_optimal_basis(res.cf, res.simplex)
    assert cert2.ok()
    assert cert2.objective == cert.objective


def test_refine_solve_matches_dense_elimination():
    """The scalable exact solver (f64-LU refinement + rational
    reconstruction) agrees with dense Fraction elimination."""
    import numpy as np
    import scipy.sparse as sp
    from scipy.sparse.linalg import splu

    from relp_tpu.numerics.exact import (
        _refine_solve_sparse, _solve_fraction_system,
    )

    rng = np.random.default_rng(5)
    m = 40
    Ad = np.where(
        rng.random((m, m)) < 0.15, rng.standard_normal((m, m)), 0.0
    )
    Ad[np.arange(m), np.arange(m)] += 3.0
    A = sp.csc_matrix(Ad)
    cols = [
        [(int(i), Fraction(float(Ad[i, j]))) for i in range(m) if Ad[i, j]]
        for j in range(m)
    ]
    rhs = [Fraction(float(v)) for v in rng.standard_normal(m)]
    lu = splu(A, permc_spec="COLAMD")
    for trans in (False, True):
        got = _refine_solve_sparse(lu, cols, rhs, trans=trans)
        assert got is not None
        B = [[Fraction(float(Ad[i, j])) for j in range(m)] for i in range(m)]
        if trans:
            B = [[B[j][i] for j in range(m)] for i in range(m)]
        want = _solve_fraction_system(B, [rhs])[0]
        assert got == want  # EXACT equality over Q
