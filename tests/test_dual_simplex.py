"""Dual simplex tests: re-solve after bound tightening from the old
(now primal-infeasible, still dual-feasible) optimal basis."""

import numpy as np
import pytest

import relp_tpu  # noqa: F401
from relp_tpu.simplex import status as st
from relp_tpu.simplex.core import solve_core
from relp_tpu.simplex.dual import solve_core_dual
from relp_tpu.utils.config import SolverConfig

CFG = SolverConfig()


def problem(m=16, n=48, seed=11):
    rng = np.random.default_rng(seed)
    A = np.where(rng.random((m, n)) < 0.4, rng.standard_normal((m, n)), 0.0)
    A[np.arange(m), rng.integers(0, n, m)] = 1.0
    b = A @ rng.random(n)
    c = rng.standard_normal(n)
    return A, b, c, np.zeros(n), np.full(n, 10.0)


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_dual_resolve_after_bound_tightening(seed):
    A, b, c, lb, ub = problem(seed=seed)
    n = A.shape[1]
    out = solve_core(A, b, c, lb, ub, cfg=CFG, max_iter=2000)
    assert int(out.status) == st.OPTIMAL
    x = np.asarray(out.x)

    # tighten the upper bound of the largest basic variable below its value
    basis = np.asarray(out.basis)
    structural_basic = basis[basis < n]
    j_star = structural_basic[np.argmax(x[structural_basic])]
    if x[j_star] < 0.5:
        pytest.skip("degenerate instance")
    ub2 = ub.copy()
    ub2[j_star] = x[j_star] * 0.6  # old basis now primal infeasible

    # fresh primal reference
    ref = solve_core(A, b, c, lb, ub2, cfg=CFG, max_iter=2000)
    assert int(ref.status) == st.OPTIMAL

    # dual re-solve from the old basis
    dual = solve_core_dual(
        A, b, c, lb, ub2,
        basis0=basis, vstat0=np.asarray(out.vstat)[:n],
        cfg=CFG, max_iter=2000,
    )
    assert int(dual.status) == st.OPTIMAL
    assert float(dual.obj) == pytest.approx(float(ref.obj), abs=1e-8)
    # warm dual re-solve should take far fewer iterations than from scratch
    assert int(dual.it) < int(ref.it)


def test_dual_detects_infeasible():
    A, b, c, lb, ub = problem(seed=14)
    n = A.shape[1]
    out = solve_core(A, b, c, lb, ub, cfg=CFG, max_iter=2000)
    assert int(out.status) == st.OPTIMAL
    # make the problem infeasible: clamp every variable near zero while
    # b stays far away
    ub2 = np.full(n, 1e-3)
    dual = solve_core_dual(
        A, b, c, lb, ub2,
        basis0=np.asarray(out.basis), vstat0=np.asarray(out.vstat)[:n],
        cfg=CFG, max_iter=2000,
    )
    assert int(dual.status) == st.INFEASIBLE


def test_reoptimize_api_fallbacks():
    from relp_tpu.simplex.reoptimize import reoptimize_with_bounds

    A, b, c, lb, ub = problem(seed=15)
    out = solve_core(A, b, c, lb, ub, cfg=CFG, max_iter=2000)
    assert int(out.status) == st.OPTIMAL
    # loosen + tighten a mix of bounds
    rng = np.random.default_rng(0)
    ub2 = ub * (0.5 + rng.random(len(ub)))
    out2 = reoptimize_with_bounds(A, b, c, lb, ub2, out, CFG)
    ref = solve_core(A, b, c, lb, ub2, cfg=CFG, max_iter=2000)
    assert int(out2.status) == int(ref.status)
    if int(ref.status) == st.OPTIMAL:
        assert float(out2.obj) == pytest.approx(float(ref.obj), abs=1e-8)


# ---- dual simplex as the MAIN algorithm (config.algorithm="dual") ----------


@pytest.mark.netlib
@pytest.mark.parametrize(
    "name,expected,tol",
    [
        ("AFIRO", -464.75314, 1e-3),
        ("ADLITTLE", 2.254949632e05, 2.3e2),
        ("SHARE1B", -7.658931857918568e4, 77.0),
        ("BOEING2", -3.1501872801520288e2, 1e-3),
        ("DEGEN2", -1.4351780e3, 1e-1),
    ],
)
def test_dual_from_scratch(name, expected, tol):
    """Dual simplex from a dual-feasible cold start (sign-matched statuses
    + temporary boxing) must reach the reference objectives; on degenerate
    instances it needs far fewer iterations than the primal (DEGEN2 602 vs
    1480, SCSD8 833 vs 17798 in the round-2 A/B)."""
    import relp_tpu
    from relp_tpu.api import solve as _solve
    from tests.conftest import reference_problem

    res = _solve(
        reference_problem("netlib", f"{name}.SIF"),
        config=SolverConfig(algorithm="dual"),
    )
    from relp_tpu.model.elements import LinearProgramType

    assert res.kind is LinearProgramType.FINITE_OPTIMUM
    assert abs(res.solution.objective_value - expected) <= tol


# ---- externally refactorized (XL) dual path --------------------------------


@pytest.mark.netlib
@pytest.mark.parametrize(
    "name,expected,tol",
    [
        ("AFIRO", -464.75314, 1e-3),
        ("SHARE1B", -7.658931857918568e4, 77.0),
        ("DEGEN2", -1.4351780e3, 1e-1),
    ],
)
def test_dual_xl_external_refactor(name, expected, tol):
    """`refactor_external_m=1` forces every solve through the XL
    orchestration (dual_xl_rebuild/polish/derive/iterate with the
    refactorization OUT of the jitted loop — the form used beyond
    m_pad=config.refactor_external_m).
    Must match the in-loop path's objectives."""
    from relp_tpu.api import solve as _solve
    from relp_tpu.model.elements import LinearProgramType
    from tests.conftest import reference_problem

    res = _solve(
        reference_problem("netlib", f"{name}.SIF"),
        config=SolverConfig(algorithm="dual", refactor_external_m=1),
    )
    assert res.kind is LinearProgramType.FINITE_OPTIMUM
    assert abs(res.solution.objective_value - expected) <= tol


def test_dual_xl_infeasible_falls_back(tmp_path):
    """An infeasible LP through the XL orchestration: the dual's
    INFEASIBLE verdict is not trusted as a certificate for the original
    problem (the temporary box tightens bounds), so the driver must fall
    back to the primal cleanly and report INFEASIBLE."""
    from relp_tpu.api import solve as _solve
    from relp_tpu.model.elements import LinearProgramType

    mps = tmp_path / "infeas.mps"
    mps.write_text(
        "NAME infeas\n"
        "ROWS\n N COST\n E R1\n"
        "COLUMNS\n"
        "    X  COST  1.0  R1  1.0\n"
        "    Y  COST  1.0  R1  1.0\n"
        "RHS\n    RHS  R1  5.0\n"
        "BOUNDS\n UP BND X 1.0\n UP BND Y 1.0\n"
        "ENDATA\n"
    )
    res = _solve(
        str(mps),
        config=SolverConfig(
            algorithm="dual", refactor_external_m=1, presolve=False
        ),
    )
    assert res.kind is LinearProgramType.INFEASIBLE


def test_dual_falls_back_on_unbounded():
    """An unbounded LP has no dual-feasible point reachable without the
    temporary box binding — the driver must fall back to the primal and
    report UNBOUNDED."""
    import relp_tpu
    from relp_tpu.api import solve as _solve
    from relp_tpu.model.elements import LinearProgramType

    res = _solve(
        "/root/reference/tests/burkardt/problem_files/nazareth.mps",
        config=SolverConfig(algorithm="dual"),
    )
    assert res.kind is LinearProgramType.UNBOUNDED


@pytest.mark.netlib
@pytest.mark.parametrize(
    "name,expected,tol",
    [
        ("AFIRO", -464.75314, 1e-3),
        ("ADLITTLE", 2.254949632e05, 2.3e2),
        ("SHARE1B", -7.658931857918568e4, 77.0),
        ("DEGEN2", -1.4351780e3, 1e-1),
    ],
)
def test_dual_devex_weights(name, expected, tol):
    """config.dual_pricing="devex" (reference-weight approximation, no
    per-pivot B⁻¹ matvec) must reach the same objectives as exact DSE —
    both through the in-loop path and the XL external orchestration."""
    from relp_tpu.api import solve as _solve
    from relp_tpu.model.elements import LinearProgramType
    from tests.conftest import reference_problem

    path = reference_problem("netlib", f"{name}.SIF")
    for extra in ({}, {"refactor_external_m": 1}):
        res = _solve(
            path,
            config=SolverConfig(
                algorithm="dual", dual_pricing="devex", **extra
            ),
        )
        assert res.kind is LinearProgramType.FINITE_OPTIMUM
        assert abs(res.solution.objective_value - expected) <= tol
