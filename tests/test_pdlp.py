"""First-order PDLP engine (relp_tpu/fom/pdhg.py): restarted adaptive
PDHG with Ruiz rescaling must reach simplex-grade objectives on Netlib,
and fall back to simplex cleanly when it cannot certify optimality."""

import numpy as np
import pytest

import relp_tpu  # noqa: F401
from relp_tpu.model.elements import LinearProgramType
from relp_tpu.utils.config import SolverConfig
from tests.conftest import reference_problem


@pytest.mark.netlib
@pytest.mark.parametrize(
    "name,expected",
    [
        ("AFIRO", -464.753142857),
        ("SC50B", -70.0),
        ("ADLITTLE", 2.2549496316e5),
        ("ISRAEL", -8.966448218e5),
        ("SHARE1B", -7.6589318579e4),
    ],
)
def test_pdlp_netlib_objectives(name, expected):
    from relp_tpu.api import solve

    res = solve(
        reference_problem("netlib", f"{name}.SIF"),
        config=SolverConfig(algorithm="pdlp"),
    )
    assert res.kind is LinearProgramType.FINITE_OPTIMUM
    assert res.solution.objective_value == pytest.approx(
        expected, rel=1e-6, abs=1e-5
    )


def test_pdlp_falls_back_on_budget():
    """A tiny iteration budget cannot certify optimality: the driver must
    fall back to the simplex path and still return the right answer."""
    from relp_tpu.api import solve

    res = solve(
        reference_problem("burkardt", "afiro.mps"),
        config=SolverConfig(algorithm="pdlp", max_iter=256),
    )
    assert res.kind is LinearProgramType.FINITE_OPTIMUM
    assert res.solution.objective_value == pytest.approx(
        -464.753142857, rel=1e-8
    )


def test_pdlp_duals_match_simplex():
    """PDHG's y must agree with the simplex duals (both in ORIGINAL row
    units) on a nondegenerate instance."""
    from relp_tpu.api import solve

    path = reference_problem("netlib", "SC50B.SIF")
    fo = solve(path, config=SolverConfig(algorithm="pdlp"))
    sx = solve(path, config=SolverConfig())
    np.testing.assert_allclose(
        fo.simplex.duals, sx.simplex.duals, rtol=1e-4, atol=1e-5
    )


def test_pdhg_chunk_tiny_lp():
    """Unit-level: min -x1-x2 s.t. x1+x2 = 1, 0 ≤ x ≤ 1 → x1+x2 = 1."""
    import jax.numpy as jnp

    from relp_tpu.fom.pdhg import (
        _power_norm, initial_state, solve_pdhg_chunk,
    )

    A = jnp.array([[1.0, 1.0]])
    b = jnp.array([1.0])
    c = jnp.array([-1.0, -1.0])
    lb = jnp.zeros(2)
    ub = jnp.ones(2)
    eta0 = 0.9 / float(_power_norm(A))
    s = initial_state(A, lb, ub, eta0)
    s = solve_pdhg_chunk(A, b, c, lb, ub, s, round_len=64, max_rounds=64)
    assert float(jnp.abs(A @ s.x - b)[0]) < 1e-6
    assert float(c @ s.x) == pytest.approx(-1.0, abs=1e-6)


def test_pdhg_chunk_halpern_tiny_lp():
    """The reflected-Halpern variant reaches the same point (constant
    step, anchor restarts — fom/pdhg.py round_body_halpern)."""
    import jax.numpy as jnp

    from relp_tpu.fom.pdhg import (
        _power_norm, initial_state, solve_pdhg_chunk,
    )

    A = jnp.array([[1.0, 1.0]])
    b = jnp.array([1.0])
    c = jnp.array([-1.0, -1.0])
    lb = jnp.zeros(2)
    ub = jnp.ones(2)
    eta0 = 0.9 / float(_power_norm(A))
    s = initial_state(A, lb, ub, eta0)
    s = solve_pdhg_chunk(
        A, b, c, lb, ub, s, round_len=64, max_rounds=64, variant="halpern"
    )
    assert float(jnp.abs(A @ s.x - b)[0]) < 1e-6
    assert float(c @ s.x) == pytest.approx(-1.0, abs=1e-6)


@pytest.mark.netlib
def test_pdlp_variant_avg_still_converges():
    """Both restart schemes stay selectable (config.pdlp_variant); the
    classic average-restart scheme must keep converging."""
    from relp_tpu.api import solve

    res = solve(
        reference_problem("netlib", "SC50B.SIF"),
        config=SolverConfig(algorithm="pdlp", pdlp_variant="avg"),
    )
    assert res.kind is LinearProgramType.FINITE_OPTIMUM
    assert res.solution.objective_value == pytest.approx(-70.0, rel=1e-6)


def test_pdlp_crossover_exact_vertex():
    """With crossover (default) the PDLP point is polished to the exact
    simplex optimum; without it the objective is only KKT-tol accurate."""
    from relp_tpu.api import solve

    path = reference_problem("netlib", "ISRAEL.SIF")
    res = solve(path, config=SolverConfig(algorithm="pdlp"))
    assert res.kind is LinearProgramType.FINITE_OPTIMUM
    assert res.solution.objective_value == pytest.approx(
        -8.9664482186e5, rel=1e-9
    )
    raw = solve(
        path, config=SolverConfig(algorithm="pdlp", pdlp_crossover=False)
    )
    assert raw.kind is LinearProgramType.FINITE_OPTIMUM
    assert raw.solution.objective_value == pytest.approx(
        -8.9664482186e5, rel=1e-6
    )


# Kennington tier (KEN/PDS/CRE — the reference cannot represent this scale
# at all; its exact solver #[ignore]s everything beyond ~2k rows).
# Expected objectives: HiGHS on this host (2026-08-17); KEN-11/PDS-02 agree
# with Koch "The final Netlib-LP results" to all published digits.
@pytest.mark.netlib
def test_pdlp_ken07():
    from relp_tpu.api import solve

    res = solve(
        reference_problem("netlib", "KEN-07.SIF"),
        config=SolverConfig(algorithm="pdlp", pdlp_crossover=False),
    )
    assert res.kind is LinearProgramType.FINITE_OPTIMUM
    assert res.solution.objective_value == pytest.approx(
        -6.795204434e8, rel=1e-6
    )


@pytest.mark.slow
@pytest.mark.parametrize(
    "name,expected",
    [
        ("KEN-11", -6.972382263e9),
        ("PDS-02", 2.8857862010e10),
        ("PDS-06", 2.7761037600e10),
        ("CRE-A", 2.3595407061e7),
        ("CRE-C", 2.5275116141e7),
    ],
)
def test_pdlp_kennington(name, expected):
    from relp_tpu.api import solve

    res = solve(
        reference_problem("netlib", f"{name}.SIF"),
        config=SolverConfig(
            algorithm="pdlp", pdlp_crossover=False, max_iter=2_000_000
        ),
    )
    assert res.kind is LinearProgramType.FINITE_OPTIMUM
    assert res.solution.objective_value == pytest.approx(expected, rel=1e-5)


def test_pdlp_plateau_accepts_best_point():
    """The driver's plateau machinery (driver._run_pdlp): with an
    unreachable tol, a 1-iteration plateau window and a loose acceptance
    bar, the solve must stop early and return the BEST point seen (whose
    KKT matches state.x — fom/pdhg.py installs the evaluated candidate)."""
    from relp_tpu.api import solve

    res = solve(
        reference_problem("netlib", "SC50B.SIF"),
        config=SolverConfig(
            algorithm="pdlp",
            pdlp_crossover=False,
            pdlp_tol=1e-300,   # unreachable: forces the plateau path
            pdlp_plateau=1,
            pdlp_accept=1e-4,
        ),
    )
    assert res.kind is LinearProgramType.FINITE_OPTIMUM
    # a 1e-4 relative-KKT point on SC50B is well inside 1e-3 objective
    assert res.solution.objective_value == pytest.approx(-70.0, rel=1e-3)


def test_pdhg_batched_scenarios():
    """solve_pdhg_batched: a vmapped scenario fleet (the DP analogue for
    the first-order engine) — each scenario converges to its own b."""
    import jax.numpy as jnp

    from relp_tpu.fom.pdhg import solve_pdhg_batched
    from relp_tpu.simplex import status as st

    # min -x1-x2 s.t. x1+x2 = b_s, 0 <= x <= 1, for three b values
    bs = np.array([0.5, 1.0, 1.5])
    A = np.tile(np.array([[1.0, 1.0]]), (3, 1, 1))
    b = bs.reshape(3, 1)
    c = np.tile(np.array([-1.0, -1.0]), (3, 1))
    lb = np.zeros((3, 2))
    ub = np.ones((3, 2))
    out = solve_pdhg_batched(A, b, c, lb, ub, tol=1e-8)
    assert np.all(np.asarray(out.status) == st.OPTIMAL)
    x = np.asarray(out.x)
    np.testing.assert_allclose(x.sum(axis=1), bs, atol=1e-6)


def test_pdlp_mixed_precision_full_kkt():
    """Mixed precision (f32 rounds + f64 KKT checks + f64 endgame,
    config.pdlp_precision="mixed"): must reach the FULL f64 tolerance —
    the f32 stage accelerates, the f64 endgame certifies."""
    from relp_tpu.api import solve

    res = solve(
        reference_problem("netlib", "SC205.SIF"),
        config=SolverConfig(
            algorithm="pdlp",
            pdlp_crossover=False,
            pdlp_precision="mixed",
        ),
    )
    assert res.kind is LinearProgramType.FINITE_OPTIMUM
    assert res.solution.objective_value == pytest.approx(
        -52.202061211707248, rel=1e-6
    )


def test_pdlp_refinement_zoom_converges(caplog):
    """Iterative refinement (config.pdlp_refine):
    once the f32 stage floors, the driver zooms into the scaled residual
    problem (r = b−Ax, d = c−Aᵀy; LP iterative refinement à la Gleixner)
    and keeps iterating in f32 — ISRAEL's f32 noise floor is ~2e-3, so
    reaching its objective to 1e-6 under precision="mixed" proves the
    zoom engaged and composited correctly (without refinement this path
    needs f64 endgame rounds)."""
    import logging

    from relp_tpu.api import solve

    with caplog.at_level(logging.INFO, logger="relp_tpu"):
        res = solve(
            reference_problem("netlib", "ISRAEL.SIF"),
            config=SolverConfig(
                algorithm="pdlp",
                pdlp_crossover=False,
                pdlp_precision="mixed",
                pdlp_refine=4,
            ),
        )
    assert res.kind is LinearProgramType.FINITE_OPTIMUM
    assert res.solution.objective_value == pytest.approx(
        -8.966448218e5, rel=1e-6
    )
    assert any("refinement zoom" in r.message for r in caplog.records)


def test_pdlp_refinement_disabled_still_converges():
    """pdlp_refine=0 must fall back to the f64-endgame path unchanged."""
    from relp_tpu.api import solve

    res = solve(
        reference_problem("netlib", "SHARE1B.SIF"),
        config=SolverConfig(
            algorithm="pdlp",
            pdlp_crossover=False,
            pdlp_precision="mixed",
            pdlp_refine=0,
        ),
    )
    assert res.kind is LinearProgramType.FINITE_OPTIMUM
    assert res.solution.objective_value == pytest.approx(
        -7.6589318579e4, rel=1e-6
    )
