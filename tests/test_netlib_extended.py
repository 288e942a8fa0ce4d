"""Extended Netlib cross-validation: solve instances the reference does NOT
assert and compare objectives against scipy's HiGHS on the *same* lowered
problem (validates parser + converter + presolve + simplex jointly on much
broader data than the reference's 22 netlib tests)."""

import os

import numpy as np
import pytest
from scipy.optimize import linprog

import relp_tpu  # noqa: F401
from relp_tpu.io import import_lp
from relp_tpu.model.computational_form import build_computational_form
from relp_tpu.model.elements import LinearProgramType
from relp_tpu.simplex.driver import solve_general_form
from relp_tpu.utils.config import SolverConfig
from tests.conftest import REFERENCE_DATA

# small/medium instances beyond the reference's asserted set
EXTENDED = [
    "BEACONFD", "BRANDY", "E226", "ISRAEL", "AGG", "AGG2", "AGG3",
    "BANDM", "SCORPION", "SCTAP1", "SCFXM1", "STAIR", "GROW7",
    "CAPRI", "SEBA", "SHELL", "SCSD1", "SCSD6", "STANDATA", "FORPLAN",
    # round-2 sweep: instances verified against HiGHS on this host
    # (2026-08-17 probe; every one matched to <=3e-11 relative)
    "FIT1D", "WOOD1P", "GROW15", "TUFF", "BOEING1", "STANDGUB",
    "SCSD8", "ETAMACRO", "SHIP04S", "SHIP04L", "PILOT4", "GROW22",
    "DEGEN2", "STANDMPS", "SCAGR25", "SCRS8", "FINNIS", "FFFFF800",
    "GFRD-PNC", "FIT1P", "SCFXM2", "NESM", "SHIP08S", "SHIP08L",
    "MAROS", "SCFXM3", "SCTAP2", "SHIP12S", "SHIP12L", "GANGES",
    "PILOT-WE",
]

# Solve + HiGHS-match verified, but minutes-long on the CPU backend —
# slow-marked like the big ceiling instances: probe walls
# 60-250 s each (PEROLD/BNL1/CZPROB/PILOT-JA/PILOTNOV ~20-60 s but
# numerically heavy; PILOT matched to 2.8e-11 rel in 250 s).
EXTENDED_SLOW = [
    "PEROLD", "BNL1", "CZPROB", "PILOT-JA", "PILOTNOV", "TRUSS",
    "WOODW", "SIERRA", "PILOT", "SCTAP3", "CYCLE", "D6CUBE",
    "MODSZK1", "KEN-07",
]

# Not asserted (with reasons), mirroring the reference's #[ignore] policy:
#   QAP8/QAP12/QAP15 — assignment-polytope relaxations, extreme degeneracy
#     (HiGHS itself needs ~10^5 iterations); QAP8 exceeded a 15-minute CPU
#     probe budget.  D2Q06C, DEGEN3, STOCFOR2, CRE-C — exceeded the CPU
#     probe budget under contention; DFL001/STOCFOR3 are asserted in the
#     XL bench tier instead.  KEN-11/PDS-02/PDS-06/CRE-A/CRE-B —
#     Kennington-scale, CPU-impractical; parse-verified.
# With D2Q06C below, EVERY vendored Netlib file (104/104) asserts an
# objective somewhere: here, test_netlib_suite.py, or test_pdlp.py
# (KEN-11/PDS-02/PDS-06/CRE-A live in test_pdlp_kennington).
SKIP_LISTED: list = []

# D2Q06C defeats both PDHG restart schemes (stalls at relative KKT ~1e-3
# even after Ruiz+PC scaling) and the unperturbed simplex exceeded a
# 15-minute CPU probe — but anti-degeneracy bound perturbation
# (config.perturb, the DEGEN3 medicine) solves it: 15,209 iterations,
# objective rel err 3.9e-8 vs Koch (~27 min on the CPU backend).
PERTURB_RESCUED_SLOW = [
    ("D2Q06C", 1.2278421081e5),
]

# Former skip-listed instances the FIRST-ORDER engine makes tractable on
# the CPU backend (simplex probes exceeded a 15-minute budget; QAP8's
# assignment-polytope degeneracy needs ~1e5 HiGHS iterations — PDHG walks
# through it in 2816 iterations / 1.6 s, and with Pock–Chambolle scaling
# QAP12/QAP15 follow).  Expected objectives: Koch, "The final Netlib-LP
# results".
PDLP_RESCUED = [
    ("STOCFOR2", -3.9024408538e4),          # 3.5 s CPU
    ("QAP8", 2.0350000000e2),               # 1.6 s CPU
    ("QAP12", 5.2289435056e2),              # 10 s CPU
]
PDLP_RESCUED_SLOW = [
    ("DEGEN3", -9.8729400000e2),            # ~130 s CPU
    ("QAP15", 1.0409940410e3),              # ~140 s CPU
    ("CRE-C", 2.5275116141e7),              # ~120 s CPU
]


def highs_objective(path):
    gf = import_lp(path)
    cf = build_computational_form(gf, scale=False)
    res = linprog(
        cf.c,
        A_eq=cf.A,
        b_eq=cf.b,
        bounds=list(zip(cf.lb, cf.ub)),
        method="highs",
    )
    if res.status == 0:
        obj = float(cf._orig_cost @ (res.x[: cf.n_structural])) + cf.fixed_cost
        return "optimal", obj
    return {2: "infeasible", 3: "unbounded"}.get(res.status, "other"), None


def _check_against_highs(name):
    path = os.path.join(REFERENCE_DATA, "netlib", "problem_files", f"{name}.SIF")
    if not os.path.exists(path):
        pytest.skip(f"{name} not vendored")
    ref_kind, ref_obj = highs_objective(path)
    res = solve_general_form(import_lp(path), SolverConfig())
    if ref_kind == "optimal":
        assert res.kind is LinearProgramType.FINITE_OPTIMUM, (name, res.kind)
        got = res.solution.objective_value
        assert got == pytest.approx(ref_obj, abs=1e-5 * (1 + abs(ref_obj))), name
    elif ref_kind == "infeasible":
        assert res.kind is LinearProgramType.INFEASIBLE, name
    elif ref_kind == "unbounded":
        assert res.kind is LinearProgramType.UNBOUNDED, name


@pytest.mark.netlib
@pytest.mark.parametrize("name", EXTENDED)
def test_matches_highs(name):
    _check_against_highs(name)


@pytest.mark.netlib
@pytest.mark.slow
@pytest.mark.parametrize("name", EXTENDED_SLOW)
def test_matches_highs_slow(name):
    _check_against_highs(name)


@pytest.mark.netlib
@pytest.mark.parametrize("name", SKIP_LISTED)
def test_skip_listed_parses(name):
    """Skip-listed instances must at least import cleanly (the reference
    vendored them; its own tests #[ignore] similar cases with reasons)."""
    path = os.path.join(REFERENCE_DATA, "netlib", "problem_files", f"{name}.SIF")
    if not os.path.exists(path):
        pytest.skip(f"{name} not vendored")
    gf = import_lp(path)
    assert gf.nr_constraints > 0 and gf.nr_variables > 0


def _check_pdlp(name, expected):
    path = os.path.join(REFERENCE_DATA, "netlib", "problem_files", f"{name}.SIF")
    if not os.path.exists(path):
        pytest.skip(f"{name} not vendored")
    res = solve_general_form(
        import_lp(path),
        SolverConfig(
            algorithm="pdlp", pdlp_crossover=False, pdlp_accept=3e-6,
            max_iter=1_500_000,
        ),
    )
    assert res.kind is LinearProgramType.FINITE_OPTIMUM, (name, res.kind)
    assert res.solution.objective_value == pytest.approx(
        expected, abs=1e-5 * (1 + abs(expected))
    ), name


@pytest.mark.netlib
@pytest.mark.parametrize("name,expected", PDLP_RESCUED)
def test_pdlp_rescued(name, expected):
    _check_pdlp(name, expected)


@pytest.mark.netlib
@pytest.mark.slow
@pytest.mark.parametrize("name,expected", PDLP_RESCUED_SLOW)
def test_pdlp_rescued_slow(name, expected):
    _check_pdlp(name, expected)


@pytest.mark.netlib
@pytest.mark.slow
@pytest.mark.parametrize("name,expected", PERTURB_RESCUED_SLOW)
def test_perturb_rescued_slow(name, expected):
    path = os.path.join(REFERENCE_DATA, "netlib", "problem_files", f"{name}.SIF")
    if not os.path.exists(path):
        pytest.skip(f"{name} not vendored")
    res = solve_general_form(import_lp(path), SolverConfig(perturb=1e-7))
    assert res.kind is LinearProgramType.FINITE_OPTIMUM, (name, res.kind)
    assert res.solution.objective_value == pytest.approx(
        expected, abs=1e-5 * (1 + abs(expected))
    ), name
