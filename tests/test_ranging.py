"""Sensitivity ranging (analysis/ranging.py).

Hand-worked textbook values on a tiny LP, sign conventions under
maximization and at-upper-bound variables, and property tests on a real
Netlib instance (AFIRO, scaled + presolved): perturbing a cost or rhs
*inside* its reported range must change the optimum exactly linearly
(slope = activity for costs, dual for rhs), because the basis is unchanged.

The reference has no ranging (roadmap stops at "a convenient API",
README.md:15-28) — this is a beyond-reference capability.
"""

import copy

import numpy as np
import pytest

import relp_tpu  # noqa: F401
from relp_tpu.analysis import ranging
from relp_tpu.model.elements import LinearProgramType
from relp_tpu.simplex.driver import solve_computational_form, solve_general_form
from relp_tpu.utils.config import SolverConfig

from test_simplex_small import make_cf

CFG = SolverConfig()
INF = float("inf")


def test_textbook_cost_and_rhs_ranges():
    # min -2x0 - 3x1  s.t.  x0 + x1 + s0 = 4,  x0 + 3x1 + s1 = 6
    # optimum x = (3, 1); classic ranging answers:
    #   c0 in [-3, -1], c1 in [-6, -2]; slack rc = duals (1.5, 0.5)
    #   b0 in [2, 6], b1 in [4, 12]; duals (-1.5, -0.5)
    cf = make_cf([[1, 1, 1, 0], [1, 3, 0, 1]], [4, 6], [-2, -3, 0, 0])
    res = solve_computational_form(cf, CFG)
    r = ranging(cf, res)
    c = r.cost_by_name()
    assert (c["x0"].lo, c["x0"].hi) == pytest.approx((-3.0, -1.0))
    assert (c["x1"].lo, c["x1"].hi) == pytest.approx((-6.0, -2.0))
    assert c["x0"].basic and c["x1"].basic
    assert c["x2"].reduced_cost == pytest.approx(1.5)
    assert c["x2"].lo == pytest.approx(-1.5) and c["x2"].hi == INF
    b = r.rhs
    assert (b[0].lo, b[0].hi) == pytest.approx((2.0, 6.0))
    assert (b[1].lo, b[1].hi) == pytest.approx((4.0, 12.0))
    assert b[0].dual == pytest.approx(-1.5)
    assert b[1].dual == pytest.approx(-0.5)


def test_maximize_sign_conventions():
    # max 2x0 + 3x1 over the same feasible set == the min problem negated:
    # same ranges with flipped signs, duals positive.  (make_cf's c is the
    # INTERNAL min-space cost; _orig_cost = -c when maximize.)
    cf = make_cf([[1, 1, 1, 0], [1, 3, 0, 1]], [4, 6], [-2, -3, 0, 0],
                 maximize=True)
    res = solve_computational_form(cf, CFG)
    assert res.objective == pytest.approx(9.0)
    r = ranging(cf, res)
    c = r.cost_by_name()
    assert (c["x0"].lo, c["x0"].hi) == pytest.approx((1.0, 3.0))
    assert (c["x1"].lo, c["x1"].hi) == pytest.approx((2.0, 6.0))
    assert r.rhs[0].dual == pytest.approx(1.5)
    assert r.rhs[1].dual == pytest.approx(0.5)


def test_at_upper_bound_variable():
    # min -x0 - x1  s.t.  x0 + x1 + s = 10,  x0 <= 3 (x0 nonbasic at upper)
    cf = make_cf(
        [[1, 1, 1]], [10], [-1, -1, 0],
        lb=[0, 0, 0], ub=[3, INF, INF],
    )
    res = solve_computational_form(cf, CFG)
    assert res.x_structural[:2] == pytest.approx([3.0, 7.0])
    r = ranging(cf, res)
    c = r.cost_by_name()
    # x0 at upper (d0 = c0 - y = -1 - c1 = 0, a degenerate tie at the
    # current costs): raising c0 above -1 makes leaving the upper bound
    # profitable, so hi = -1; any cheaper c0 keeps it pinned at 3
    assert c["x0"].hi == pytest.approx(-1.0)
    assert c["x0"].lo == -INF
    # basic x1: below c1 = -1 the at-upper x0 turns profitable to REDUCE
    # (d0 = -1 - c1 > 0), above c1 = 0 the slack takes over
    assert (c["x1"].lo, c["x1"].hi) == pytest.approx((-1.0, 0.0))


def test_requires_vertex():
    cf = make_cf([[1, 1]], [2], [1, 1])
    res = solve_computational_form(cf, CFG)
    res.basis = None
    with pytest.raises(ValueError):
        ranging(cf, res)


@pytest.fixture(scope="module")
def afiro():
    from relp_tpu.io import import_lp

    general = import_lp("/root/reference/tests/netlib/problem_files/AFIRO.SIF")
    res = solve_general_form(general, CFG)
    assert res.kind is LinearProgramType.FINITE_OPTIMUM
    return general, res


def _resolve_with(cf, dc=None, db=None):
    """Re-solve a copy of cf with original-unit cost/rhs deltas applied."""
    cf2 = copy.deepcopy(cf)
    sigma = -1.0 if cf2.maximize else 1.0
    if dc:
        for j, delta in dc.items():
            cf2.c[j] += sigma * cf2.col_scale[j] * delta
            cf2._orig_cost[j] += delta
    if db:
        b = np.array(cf2.b)
        for i, delta in db.items():
            b[i] += cf2.row_scale[i] * delta
        cf2.b = b
    return solve_computational_form(cf2, CFG)


def test_afiro_ranges_bracket_current_data(afiro):
    # AFIRO's optimum is primal- AND dual-degenerate, so many ranges pinch
    # to zero width (the conservative same-basis answer).  What must still
    # hold: every interval brackets the current coefficient/rhs, and the
    # reported duals match the solver's.
    general, res = afiro
    cf, sres = res.cf, res.simplex
    r = ranging(cf, sres, row_names=general.row_names)
    for cr in r.cost:
        assert cr.lo <= cr.cost + 1e-9 and cr.cost - 1e-9 <= cr.hi, cr.name
        if not cr.basic:
            assert cr.value == pytest.approx(cr.value)  # finite
    for i, rr in enumerate(r.rhs):
        assert rr.lo <= rr.rhs + 1e-9 and rr.rhs - 1e-9 <= rr.hi, rr.name
        assert rr.dual == pytest.approx(float(sres.duals[i]), abs=1e-8)
    assert r.rhs[0].name == general.row_names[0]


@pytest.fixture(scope="module")
def random_lp():
    # max c@x  s.t.  A x <= b,  0 <= x <= 10 — random data is almost surely
    # nondegenerate, so ranging intervals have real width and the
    # same-basis linearity property is testable.
    rng = np.random.default_rng(7)
    m, n = 12, 20
    A = rng.normal(size=(m, n))
    u = rng.uniform(0.5, 1.5, n)
    b = A @ u + rng.uniform(0.5, 1.0, m)
    c = rng.uniform(0.2, 2.0, n)
    A_full = np.hstack([A, np.eye(m)])
    lb = np.zeros(n + m)
    ub = np.concatenate([np.full(n, 10.0), np.full(m, INF)])
    # internal min-space cost: -c for the structurals (maximize)
    cf = make_cf(A_full, b, np.concatenate([-c, np.zeros(m)]),
                 lb=lb, ub=ub, maximize=True)
    res = solve_computational_form(cf, CFG)
    assert res.kind is LinearProgramType.FINITE_OPTIMUM
    return cf, res


def test_cost_ranging_is_linear(random_lp):
    cf, sres = random_lp
    r = ranging(cf, sres)
    base = sres.objective
    checked = 0
    for cr in r.cost:
        j = cf.col_names.index(cr.name)
        width = cr.hi - cr.lo
        if not np.isfinite(width) or width < 1e-6 or not cr.basic:
            continue
        # step to the middle of the allowed interval: same basis stays
        # optimal, so the objective moves by exactly activity * delta
        delta = (min(cr.hi, cr.cost + 1) + max(cr.lo, cr.cost - 1)) / 2 - cr.cost
        if abs(delta) < 1e-9:
            continue
        out = _resolve_with(cf, dc={j: delta})
        assert out.kind is LinearProgramType.FINITE_OPTIMUM
        assert out.objective == pytest.approx(
            base + delta * cr.value, rel=1e-7, abs=1e-7
        ), cr.name
        checked += 1
    assert checked >= 3


def test_cost_ranging_edge_is_tight(random_lp):
    # just beyond a finite range endpoint the basis change must make the
    # objective strictly BETTER than the linear extrapolation (a new basis
    # is only adopted when it wins) — this catches too-narrow ranges being
    # reported as exact
    cf, sres = random_lp
    r = ranging(cf, sres)
    base = sres.objective
    checked = 0
    for cr in r.cost:
        j = cf.col_names.index(cr.name)
        if not cr.basic or not np.isfinite(cr.hi) or cr.hi - cr.lo < 1e-6:
            continue
        eps = 1e-3
        delta = cr.hi - cr.cost  # to the endpoint: still exactly linear
        out = _resolve_with(cf, dc={j: delta})
        assert out.objective == pytest.approx(
            base + delta * cr.value, rel=1e-7, abs=1e-7
        ), cr.name
        out2 = _resolve_with(cf, dc={j: delta + eps})  # beyond: superlinear
        assert out2.objective >= base + delta * cr.value - 1e-9
        checked += 1
        if checked >= 2:
            break
    assert checked >= 1


def test_rhs_ranging_slope_is_dual(random_lp):
    cf, sres = random_lp
    r = ranging(cf, sres)
    base = sres.objective
    checked = 0
    for i, rr in enumerate(r.rhs):
        if rr.hi - rr.lo < 1e-5:
            continue
        # clip semi-infinite ranges to a unit window around the current rhs
        delta = (min(rr.hi, rr.rhs + 1) + max(rr.lo, rr.rhs - 1)) / 2 - rr.rhs
        if abs(delta) < 1e-9:
            continue
        out = _resolve_with(cf, db={i: delta})
        assert out.kind is LinearProgramType.FINITE_OPTIMUM
        assert out.objective == pytest.approx(
            base + delta * rr.dual, rel=1e-7, abs=1e-7
        ), rr.name
        checked += 1
    assert checked >= 3


@pytest.mark.parametrize("name", ["SC50A", "ADLITTLE", "BLEND", "SHARE2B"])
def test_netlib_ranges_bracket_current_data(name):
    # bracket + dual-consistency invariants must hold on real (scaled,
    # presolved, degenerate) instances, not just textbook LPs
    from relp_tpu.io import import_lp

    general = import_lp(
        f"/root/reference/tests/netlib/problem_files/{name}.SIF"
    )
    res = solve_general_form(general, CFG)
    assert res.kind is LinearProgramType.FINITE_OPTIMUM
    r = ranging(res.cf, res.simplex, row_names=general.row_names)
    assert len(r.rhs) == res.cf.m
    for cr in r.cost:
        assert cr.lo <= cr.cost + 1e-7 and cr.cost - 1e-7 <= cr.hi, cr.name
    for i, rr in enumerate(r.rhs):
        assert rr.lo <= rr.rhs + 1e-7 and rr.rhs - 1e-7 <= rr.hi, rr.name
        assert rr.dual == pytest.approx(
            float(res.simplex.duals[i]), abs=1e-7
        )


def test_api_ranging_of():
    from relp_tpu.api import ranging_of, solve

    res = solve("/root/reference/tests/burkardt/problem_files/testprob.mps")
    r = ranging_of(res)
    assert r.cost and r.rhs


def test_cli_ranging_json(tmp_path):
    import json
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, "-m", "relp_tpu",
         "/root/reference/tests/netlib/problem_files/AFIRO.SIF",
         "--json", "--ranging", "-q"],
        capture_output=True, text=True, timeout=600,
        env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin",
             "HOME": "/root"},
    )
    assert out.returncode == 0, out.stderr
    payload = json.loads(out.stdout.strip().splitlines()[-1])
    assert "ranging" in payload
    rng = payload["ranging"]
    assert rng["cost"] and rng["rhs"]
    row = next(iter(rng["rhs"].values()))
    assert set(row) == {"rhs", "lo", "hi", "dual"}
