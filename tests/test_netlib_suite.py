"""The full Netlib suite the reference asserts (tests/netlib/test.rs:10-166),
with the same third-party expected objectives and tolerances, plus the
instances the reference *cannot* solve ("too computationally intensive" in
exact rational arithmetic) — breaking that ceiling is an explicit goal
(BASELINE.md).

Marked `netlib` so the quick suite can deselect; the big four are `slow`.
"""

import pytest

import relp_tpu  # noqa: F401
from relp_tpu.api import solve
from relp_tpu.model.elements import LinearProgramType
from relp_tpu.utils.config import SolverConfig
from tests.conftest import reference_problem

# (instance, expected objective, absolute tolerance) — reference netlib/test.rs
CASES = [
    ("ADLITTLE", 2.254949632e05, 1e-3 * 2.3e5),  # Gurobi (rel 1e-3)
    ("AFIRO", -464.75314, 1e-3),
    ("SC50A", -6.457507706e01, 1e-5),
    ("SC50B", -70.0, 1e-7),
    ("KB2", -1.749900130e03, 1e-3),
    ("SC105", -5.220206121e01, 1e-3),
    ("STOCFOR1", -4.113197622e04, 1e-3 * 4.1e4),  # rel
    ("BLEND", -30.81215, 1e-3),
    ("SCAGR7", -2.331389824e06, 1e-1 * 23),  # reference tol 1e-1 on 2.3e6
    ("SC205", -5.220206121e01, 1e-5),
    ("SHARE2B", -4.157322407e02, 1e-3),
    ("RECIPELP", -266.616, 1e-2),
    ("LOTFI", -25.26470606188, 1e-5),
    ("VTP-BASE", 1.298314624613613657395984384889e5, 1e-2 * 13),
    ("SHARE1B", -7.658931857918568112797274346007e4, 1e-3 * 77),
    ("BOEING2", -3.1501872801520287870462195913263e2, 1e-3),
    ("BORE3D", 1.3730803942084927215581987251301e3, 1e-2),
]

# Beyond the reference's capability ceiling (ignored there as "too
# computationally intensive"); float64 on a device should break through.
# Expected objectives: Gurobi (25FV47/80BAU3B per reference comments) and
# Koch, "The final Netlib-LP results" (the rest; BASELINE configs name
# bnl2 and fit2p/pilot87 explicitly).
CEILING_CASES = [
    ("SCORPION", 1.8781248227381066296479411763586e3, 1e-2),
    ("25FV47", 5.5018459e03, 5.5018459e03 * 1e-5),
    ("GREENBEA", -7.2555248129845987457557870574845e7, 1e0),
    ("GREENBEB", -4.3022602612065867539213672544432e6, 1e1),
    ("80BAU3B", 9.872241924e05, 9.872241924e05 * 1e-5),
    ("BNL2", 1.8112365404e3, 1.8112365404e3 * 1e-5),
    ("FIT2P", 6.8464293294e4, 6.8464293294e4 * 1e-5),
    ("PILOT87", 3.0171034733e2, 3.0171034733e2 * 1e-4),
]


def _solve_case(name, expected, tol, config=None):
    path = reference_problem("netlib", f"{name}.SIF")
    res = solve(path, config or SolverConfig())
    assert res.kind is LinearProgramType.FINITE_OPTIMUM, (
        f"{name}: {res.kind} (iters={res.simplex.iterations if res.simplex else '?'},"
        f" art={res.simplex.art_residual if res.simplex else '?'})"
    )
    got = res.solution.objective_value
    assert got == pytest.approx(expected, abs=tol), f"{name}: {got} != {expected}"


@pytest.mark.netlib
@pytest.mark.parametrize("name,expected,tol", CASES, ids=[c[0] for c in CASES])
def test_netlib(name, expected, tol):
    _solve_case(name, expected, tol)


@pytest.mark.netlib
@pytest.mark.slow
@pytest.mark.parametrize(
    "name,expected,tol", CEILING_CASES, ids=[c[0] for c in CEILING_CASES]
)
def test_netlib_beyond_reference_ceiling(name, expected, tol):
    _solve_case(name, expected, tol)
