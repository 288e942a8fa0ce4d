"""Batched end-to-end solves (BASELINE config: afiro + share2b + sc50a)."""

import pytest

import relp_tpu  # noqa: F401
from relp_tpu.io import import_lp
from relp_tpu.model.elements import LinearProgramType
from relp_tpu.simplex.driver import solve_general_forms_batched
from relp_tpu.utils.config import SolverConfig
from tests.conftest import reference_problem

EXPECTED = [
    ("AFIRO.SIF", -4.6475314286e2, 1e-3),
    ("SHARE2B.SIF", -4.157322407e02, 1e-3),
    ("SC50A.SIF", -6.457507706e01, 1e-5),
]


def test_batched_netlib_trio():
    generals = [import_lp(reference_problem("netlib", n)) for n, _, _ in EXPECTED]
    results = solve_general_forms_batched(generals, SolverConfig())
    for (name, expected, tol), res in zip(EXPECTED, results):
        assert res.kind is LinearProgramType.FINITE_OPTIMUM, name
        assert res.solution.objective_value == pytest.approx(expected, abs=tol), name


def test_fleet_pdlp_scenarios_match_highs():
    """Shared-A first-order fleet (driver._solve_fleet_pdlp): perturbed
    same-base scenarios solved as ONE vmapped PDHG program with the
    operator unbatched (per-scenario SpMVs fuse into one GEMM), host
    warm start, vectorized refinement zooms, and host straggler cleanup.
    Objectives must match HiGHS solving each scenario independently."""
    import numpy as np
    from scipy.optimize import linprog

    from relp_tpu.io import import_lp
    from relp_tpu.model.computational_form import build_computational_form
    from relp_tpu.model.elements import LinearProgramType
    from relp_tpu.simplex.driver import solve_general_forms_batched
    from relp_tpu.utils.config import SolverConfig
    from tests.conftest import reference_problem

    path = reference_problem("netlib", "SCTAP2.SIF")
    rng = np.random.default_rng(7)
    n_scen = 3
    zb = rng.standard_normal((n_scen, 10_000))
    zc = rng.standard_normal((n_scen, 10_000))

    def scenarios():
        gens = []
        for s in range(n_scen):
            gf = import_lp(path)
            gf.b = gf.b * (1.0 + 0.03 * zb[s, : len(gf.b)])
            for j, v in enumerate(gf.variables):
                v.cost = v.cost * (1.0 + 0.03 * zc[s, j])
            gens.append(gf)
        return gens

    cfg = SolverConfig(algorithm="pdlp", presolve=False, max_iter=200_000)
    results = solve_general_forms_batched(scenarios(), cfg)
    assert all(
        r.kind is LinearProgramType.FINITE_OPTIMUM for r in results
    ), [str(r.kind) for r in results]
    for r, gf in zip(results, scenarios()):
        cf = build_computational_form(gf, scale=False)
        hr = linprog(cf.c, A_eq=cf.A, b_eq=cf.b,
                     bounds=list(zip(cf.lb, cf.ub)), method="highs")
        assert hr.status == 0
        sigma = -1.0 if cf.maximize else 1.0
        h = sigma * hr.fun + cf.fixed_cost
        got = r.solution.objective_value
        assert abs(got - h) <= 1e-6 * (1.0 + abs(h)), (got, h)


def test_fleet_ipm_dense_scenarios_match_highs():
    """Interior-point fleet (driver._solve_fleet_ipm): a dense shared-A
    scenario fleet solved as vmapped Mehrotra chunks — batched
    normal-equation GEMMs + Cholesky, the dense-GEMM fleet shape (the
    PDHG fleet's tail stalls near 1e-6 relative KKT on dense operators).
    Objectives must match HiGHS solving each scenario independently."""
    import numpy as np
    import scipy.sparse as sp
    from scipy.optimize import linprog

    from relp_tpu.model.elements import (
        LinearProgramType, Objective, RangedConstraintRelation,
    )
    from relp_tpu.model.general_form import GeneralForm, Variable
    from relp_tpu.utils.config import SolverConfig

    m_d, n_d, n_scen = 96, 192, 3
    grng = np.random.default_rng(0xD15E)
    A_d = grng.uniform(0.05, 1.0, (m_d, n_d))
    A_csc = sp.csc_matrix(A_d)
    x0 = grng.uniform(0.2, 1.0, n_d)
    c0 = grng.uniform(0.1, 1.0, n_d)
    z = grng.standard_normal((2, n_scen, n_d))

    def scenarios():
        gens = []
        for s in range(n_scen):
            xs = x0 * (1 + 0.03 * z[0, s])
            cs = c0 * (1 + 0.03 * z[1, s])
            gens.append(GeneralForm(
                objective=Objective.MINIMIZE,
                A=A_csc,
                constraint_types=[RangedConstraintRelation.equal()] * m_d,
                b=A_d @ xs,
                variables=[
                    Variable(f"x{j}", cost=cs[j], lower=0.0, upper=2.0)
                    for j in range(n_d)
                ],
            ))
        return gens

    cfg = SolverConfig(algorithm="ipm", presolve=False)
    results = solve_general_forms_batched(scenarios(), cfg)
    for s, (gf, r) in enumerate(zip(scenarios(), results)):
        assert r.kind is LinearProgramType.FINITE_OPTIMUM, s
        ref = linprog(
            [v.cost for v in gf.variables], A_eq=A_d, b_eq=gf.b,
            bounds=[(0.0, 2.0)] * n_d, method="highs",
        )
        assert ref.status == 0
        assert r.solution.objective_value == pytest.approx(
            ref.fun, rel=1e-6
        ), s


def test_nested_core_matches_inloop():
    """solve_core(nested=True) — the vmap-friendly nested-refactorization
    form — reaches the same optimum as the classic in-loop form."""
    import numpy as np

    from relp_tpu.simplex import status as st
    from relp_tpu.simplex.core import solve_core
    from relp_tpu.utils.config import SolverConfig

    rng = np.random.default_rng(17)
    cfg = SolverConfig()
    for seed in range(3):
        r = np.random.default_rng(seed)
        m, n = 24, 64
        A = np.where(r.random((m, n)) < 0.2, r.standard_normal((m, n)), 0.0)
        A[np.arange(m), r.integers(0, n, m)] = 1.0
        b = A @ r.random(n)
        c = r.standard_normal(n)
        lb = np.zeros(n)
        ub = np.full(n, 10.0)
        o1 = solve_core(A, b, c, lb, ub, cfg=cfg, max_iter=2000)
        o2 = solve_core(
            A, b, c, lb, ub, cfg=cfg, max_iter=2000, nested=True
        )
        assert int(o1.status) == st.OPTIMAL
        assert int(o2.status) == st.OPTIMAL
        assert abs(float(o1.obj) - float(o2.obj)) <= 1e-8 * (
            1 + abs(float(o1.obj))
        )
