"""Benchmark: Netlib suite wall-clock, iterations/s, and external baselines.

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": ..., "hardware": ..., ...}

Anchors:
- ``vs_highs_wall`` — speedup over scipy's bundled HiGHS (dual simplex,
  state-of-the-art CPU solver) measured on the SAME instances on THIS
  host at bench time.  >1.0 means this framework is faster end-to-end.
- ``flops_rate_gflops_s`` — modeled useful FLOPs over wall (the
  per-iteration model is 2·m·n pricing + 2·m·n devex row and 2·m² FTRAN +
  2·m² rank-1 update; see ``_flops_for``).
- ``hardware`` — device count and kind as JAX reports them, plus the
  card's name and power limit from ``nvidia-smi`` on a GPU.

Suites:
    --suite small   17 reference-asserted instances
    --suite full    + SCORPION, 25FV47 (default)
    --suite large   the 8 beyond-reference-ceiling instances
                    (BNL2, PILOT87, FIT2P, GREENBEA/B, 80BAU3B, 25FV47,
                    SCORPION) with per-instance wall/iters/objective checks
    --suite fleet   perturbed scenarios of one base, one batched solve

The Netlib suites read the reference corpus under NETLIB_DIR; the fleet's
DENSE base is generated in the repository (relp_tpu.models.generated).

Usage: python bench.py [--quick] [--suite small|full|large|xl|fleet] [--verbose]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

SUITE_SMALL = [
    "AFIRO", "SC50A", "SC50B", "KB2", "SC105", "BLEND", "SHARE2B",
    "ADLITTLE", "SC205", "RECIPELP", "LOTFI", "STOCFOR1", "SCAGR7",
    "BOEING2", "SHARE1B", "VTP-BASE", "BORE3D",
]
# adds instances beyond the reference's exact-arithmetic ceiling.
SUITE_FULL = SUITE_SMALL + ["SCORPION", "25FV47"]
# the full beyond-ceiling set the reference #[ignore]s as "too
# computationally intensive" (tests/netlib/test.rs:129-166) — expected
# objectives from Gurobi / Koch "The final Netlib-LP results"
# (tests/test_netlib_suite.py::CEILING_CASES).
SUITE_LARGE = [
    "SCORPION", "25FV47", "BNL2", "80BAU3B",
    "GREENBEA", "GREENBEB", "FIT2P", "PILOT87",
]
# the scale tier the round-1 dense engine could not represent at all:
# sparse ELL device matrix + block product-form inverse.  Expected
# objectives: Koch "The final Netlib-LP results", cross-checked against
# HiGHS.  The Kennington
# instances (KEN/PDS/CRE — up to 14.7k x 21.3k) are the first-order
# engine's tier: bench them with --algorithm pdlp.
SUITE_XL = [
    "KEN-07", "PDS-02", "CRE-A", "CRE-C", "PDS-06", "KEN-11",
    "DFL001", "STOCFOR3",
]
# batched-suite objective checks (tests/test_netlib_suite.py::CASES — the
# reference's own asserted optima, same tolerances)
_SMALL_EXPECTED = {
    "ADLITTLE": (2.254949632e05, 1e-3 * 2.3e5),
    "AFIRO": (-464.75314, 1e-3),
    "SC50A": (-6.457507706e01, 1e-5),
    "SC50B": (-70.0, 1e-7),
    "KB2": (-1.749900130e03, 1e-3),
    "SC105": (-5.220206121e01, 1e-3),
    "STOCFOR1": (-4.113197622e04, 1e-3 * 4.1e4),
    "BLEND": (-30.81215, 1e-3),
    "SCAGR7": (-2.331389824e06, 1e-1 * 23),
    "SC205": (-5.220206121e01, 1e-5),
    "SHARE2B": (-4.157322407e02, 1e-3),
    "RECIPELP": (-266.616, 1e-2),
    "LOTFI": (-25.26470606188, 1e-5),
    "VTP-BASE": (1.2983146246e5, 1e-2 * 13),
    "SHARE1B": (-7.6589318579e4, 1e-3 * 77),
    "BOEING2": (-3.1501872801e2, 1e-3),
    "BORE3D": (1.3730803942e3, 1e-2),
}

LARGE_EXPECTED = {
    "SCORPION": (1.8781248227381066e3, 1e-2),
    "25FV47": (5.5018459e03, 5.5018459e03 * 1e-5),
    "GREENBEA": (-7.2555248129845987e7, 1e0),
    "GREENBEB": (-4.3022602612065868e6, 1e1),
    "80BAU3B": (9.872241924e05, 9.872241924e05 * 1e-5),
    "BNL2": (1.8112365404e3, 1.8112365404e3 * 1e-5),
    "FIT2P": (6.8464293294e4, 6.8464293294e4 * 1e-5),
    "PILOT87": (3.0171034733e2, 3.0171034733e2 * 1e-4),
    "DFL001": (1.1266396047e7, 1.1266396047e7 * 1e-5),
    "STOCFOR3": (-3.9976783944e4, 3.9976783944e4 * 1e-5),
    # Kennington tier — HiGHS on this host (2026-08-17); KEN-11/PDS-02
    # agree with Koch to all published digits.
    "KEN-07": (-6.795204434e8, 6.795204434e8 * 1e-5),
    "KEN-11": (-6.972382263e9, 6.972382263e9 * 1e-5),
    "PDS-02": (2.8857862010e10, 2.8857862010e10 * 1e-5),
    "PDS-06": (2.7761037600e10, 2.7761037600e10 * 1e-5),
    "CRE-A": (2.3595407061e7, 2.3595407061e7 * 1e-5),
    "CRE-C": (2.5275116141e7, 2.5275116141e7 * 1e-5),
}

NETLIB_DIR = "/root/reference/tests/netlib/problem_files"


def _flops_for(metrics, config) -> float:
    """Modeled useful FLOPs for one solve (see module docstring).

    With the ELL layout, pricing + devex cost 2·nnz each instead of 2·m·n;
    with the eta backend the O(m²) inverse fold amortizes over eta_block
    pivots (plus O(m·T) per-pivot eta work, folded into the constant)."""
    m, n, it = metrics.m_padded, metrics.n_padded, metrics.iterations
    if config.algorithm == "pdlp" and metrics.pivots == 0:
        # PDHG: two SpMVs + O(m+n) vector work per iteration, no inverse
        return float(it) * (4.0 * (metrics.nnz or m * n) + 10.0 * (m + n))
    if config.algorithm == "ipm" and metrics.pivots == 0:
        # Mehrotra: one (m,n)·(n,m) normal-equation GEMM + one m³/3
        # Cholesky per iteration (predictor+corrector share the factor)
        return float(it) * (2.0 * m * m * n + m**3 / 3.0)
    if metrics.matrix_format in ("ell", "hybrid") and metrics.nnz:
        pricing = 4.0 * metrics.nnz
    else:
        pricing = 4.0 * m * n
    inv_div = config.eta_block if config.inverse == "eta" else 1
    return float(it) * (pricing + 4.0 * m * m / inv_div)


def _hbm_bytes(metrics, config=None) -> int:
    """Estimated resident device bytes for the problem's arrays."""
    m, n = metrics.m_padded, metrics.n_padded
    # PDHG holds no basis inverse — just A and O(m+n) vectors
    pdlp = (
        config is not None
        and config.algorithm == "pdlp"
        and metrics.pivots == 0
    )
    binv = 0 if pdlp else 8 * m * m
    if metrics.matrix_format in ("ell", "hybrid") and metrics.nnz:
        # padded ELL: f64 data + i32 rows + f32 shadow, K·n slots ≥ nnz
        a_bytes = metrics.nnz * 16 * 2  # generous ×2 for K padding
    else:
        a_bytes = m * n * 12  # f64 + f32 shadow
    return int(binv + a_bytes + 8 * (6 * n + 6 * m))


def _highs_solve_cf(arg):
    """Worker for the multiprocess HiGHS fleet baseline (module-level for
    pickling): one scenario from its lowered arrays."""
    c, A, b, lb, ub, maximize, fixed_cost = arg
    from scipy.optimize import linprog

    res = linprog(c, A_eq=A, b_eq=b, bounds=list(zip(lb, ub)),
                  method="highs")
    sigma = -1.0 if maximize else 1.0
    return (
        int(res.status),
        sigma * res.fun + fixed_cost if res.status == 0 else None,
    )


def _highs_wall(paths, verbose=False):
    """Wall-clock for scipy's HiGHS on the same lowered problems (host CPU)."""
    from scipy.optimize import linprog

    from relp_tpu.io import import_lp
    from relp_tpu.model.computational_form import build_computational_form

    total = 0.0
    solved = 0
    for name, path in paths:
        try:
            gf = import_lp(path)
            cf = build_computational_form(gf, scale=False)
            t0 = time.perf_counter()
            res = linprog(
                cf.c, A_eq=cf.A, b_eq=cf.b,
                bounds=list(zip(cf.lb, cf.ub)), method="highs",
            )
            dt = time.perf_counter() - t0
            total += dt
            solved += int(res.status == 0)
            if verbose:
                print(f"# highs {name}: status={res.status} wall={dt:.3f}s",
                      file=sys.stderr)
        except Exception as e:
            print(f"# highs {name}: EXC {e}", file=sys.stderr)
    return total, solved


def _hardware() -> str:
    """Device count and kind; on a GPU also the card's name and power
    limit (a card below its maximum limit runs slower under load)."""
    import subprocess

    import jax

    devs = jax.devices()
    hw = f"{len(devs)}x {devs[0].device_kind}"
    if devs[0].platform == "gpu":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
        hw += f" ({smi})"
    return hw


def run_fleet(args, base_dir) -> int:
    """--suite fleet: N perturbed same-shape scenarios of one instance,
    solved as ONE vmapped device program (parallel/batched.py) vs HiGHS
    solving the same fleet on the host, sequentially and as a pool."""
    import numpy as np

    import relp_tpu  # noqa: F401
    from relp_tpu.io import import_lp
    from relp_tpu.model.elements import LinearProgramType
    from relp_tpu.simplex.driver import solve_general_forms_batched
    from relp_tpu.utils.config import SolverConfig

    name = args.fleet_base
    n_scen = args.fleet_n

    if name.upper().startswith("DENSE"):
        # the dense allocation family (relp_tpu/models/generated.py),
        # scenarios perturbing demand and cost; objectives are verified
        # against HiGHS solving each scenario from scratch.
        # Usage: --fleet-base DENSE or DENSE-<m>x<n> (default 768x1536).
        from relp_tpu.models.generated import dense_allocation_lp

        dims = name.split("-", 1)[1] if "-" in name else "768x1536"
        m_d, n_d = (int(v) for v in dims.lower().split("x"))

        def scenarios():
            return [
                dense_allocation_lp(m_d, n_d, scenario=s)
                for s in range(n_scen)
            ]
    else:
        path = f"{base_dir}/{name}.SIF"
        rng = np.random.default_rng(20260819)
        zb = rng.standard_normal((n_scen, 30_000))
        zc = rng.standard_normal((n_scen, 30_000))

        def scenarios():
            gens = []
            for s in range(n_scen):
                gf = import_lp(path)
                gf.b = gf.b * (1.0 + 0.03 * zb[s, : len(gf.b)])
                for j, v in enumerate(gf.variables):
                    v.cost = v.cost * (1.0 + 0.03 * zc[s, j])
                gens.append(gf)
            return gens

    # default engine: the first-order fleet (_solve_fleet_pdlp) — every
    # scenario shares A, so the vmapped SpMVs fuse into ONE GEMM per step;
    # one host HiGHS base solve warm-starts the whole fleet.  "simplex" =
    # the vmapped two-phase core (exactness path).  Presolve stays OFF for
    # every engine: per-scenario presolve would make the lowered shapes
    # diverge, splitting the fleet into singleton groups and losing the
    # shared-A fast path AND the base-solve warm start.
    config = SolverConfig(
        algorithm={"pdlp": "pdlp", "ipm": "ipm"}.get(
            args.fleet_engine, "primal"
        ),
        presolve=False,
    )
    # compile warmup: the vmapped program's shape depends on the batch
    # size, so warm the FULL batch shape once
    solve_general_forms_batched(scenarios(), config)

    t0 = time.perf_counter()
    results = solve_general_forms_batched(scenarios(), config)
    wall = time.perf_counter() - t0
    ok = sum(1 for r in results if r.kind is LinearProgramType.FINITE_OPTIMUM)
    objs = [
        r.solution.objective_value if r.solution is not None else None
        for r in results
    ]

    # HiGHS baselines: the same fleet on the host from the same lowered
    # form (its own presolve included — best CPU practice), BOTH
    # sequentially (the classic workflow) and as a one-process-per-core
    # pool (the strongest realistic CPU fleet baseline on this host)
    highs_wall = None
    highs_par_wall = None
    highs_ok = 0
    obj_match = None
    if not args.no_highs:
        import multiprocessing as _mp
        import os as _os

        from scipy.optimize import linprog

        from relp_tpu.model.computational_form import build_computational_form

        cfs = [
            build_computational_form(gf, scale=False) for gf in scenarios()
        ]
        t0 = time.perf_counter()
        highs_objs = []
        for cf in cfs:
            res = linprog(
                cf.c, A_eq=cf.A, b_eq=cf.b,
                bounds=list(zip(cf.lb, cf.ub)), method="highs",
            )
            highs_ok += int(res.status == 0)
            sigma = -1.0 if cf.maximize else 1.0
            highs_objs.append(
                sigma * res.fun + cf.fixed_cost if res.status == 0 else None
            )
        highs_wall = time.perf_counter() - t0

        jobs = [
            (cf.c, cf.A, cf.b, cf.lb, cf.ub, cf.maximize, cf.fixed_cost)
            for cf in cfs
        ]
        ncore = _os.cpu_count() or 1
        t0 = time.perf_counter()
        # spawn: a forked child would inherit this process's device context
        with _mp.get_context("spawn").Pool(processes=ncore) as pool:
            par = pool.map(_highs_solve_cf, jobs)
        highs_par_wall = time.perf_counter() - t0
        par_ok = sum(1 for st_, _ in par if st_ == 0)
        if par_ok != highs_ok:
            print(f"# highs pool: {par_ok}/{len(jobs)} (seq {highs_ok})",
                  file=sys.stderr)
        match = [
            o is not None and h is not None
            and abs(o - h) <= 1e-6 * (1.0 + abs(h))
            for o, h in zip(objs, highs_objs)
        ]
        obj_match = sum(match)

    payload = {
        "metric": "fleet_lps_per_s",
        "value": round(ok / max(wall, 1e-9), 2),
        "unit": "LPs/s aggregate (higher is better)",
        "fleet_base": name,
        "fleet_n": n_scen,
        "fleet_engine": args.fleet_engine,
        "wall_s": round(wall, 3),
        "solved": f"{ok}/{n_scen}",
        "hardware": _hardware(),
    }
    if highs_wall is not None:
        payload["highs_wall_s"] = round(highs_wall, 3)
        payload["highs_solved"] = f"{highs_ok}/{n_scen}"
        payload["vs_highs_wall"] = round(highs_wall / max(wall, 1e-9), 3)
        payload["objective_matches_highs"] = f"{obj_match}/{n_scen}"
        payload["highs_parallel_wall_s"] = round(highs_par_wall, 3)
        payload["highs_parallel_procs"] = _os.cpu_count()
        payload["vs_highs_parallel_wall"] = round(
            highs_par_wall / max(wall, 1e-9), 3
        )
    print(json.dumps(payload))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--suite", choices=["small", "full", "large", "xl", "fleet"],
        default="full",
    )
    ap.add_argument(
        "--fleet-base", default="SCTAP3",
        help="fleet suite: base instance to perturb (a Netlib name, or "
             "DENSE / DENSE-<m>x<n> for the generated dense allocation LP)",
    )
    ap.add_argument(
        "--fleet-n", type=int, default=256,
        help="fleet suite: number of perturbed scenarios",
    )
    ap.add_argument(
        "--fleet-engine", choices=["pdlp", "simplex", "ipm"], default="pdlp",
        help="fleet suite solver: shared-A GEMM-fused PDHG (default), "
             "the vmapped two-phase simplex core, or the vmapped "
             "interior-point engine (batched normal-equation GEMMs + "
             "Cholesky — the dense-fleet engine)",
    )
    ap.add_argument(
        "--inverse", choices=["dense", "eta"], default=None,
        help="override the inverse backend (xl defaults to eta)",
    )
    ap.add_argument(
        "--algorithm", choices=["primal", "dual", "pdlp", "ipm", "auto"],
        default=None,
        help="solver engine (xl defaults to pdlp — the first-order scale "
             "path; crossover disabled in-bench to keep one engine timed). "
             "'auto' picks per instance from the measured engine map "
             "(large suite: IPM everywhere except the known IPM-stall "
             "instances, which go straight to the primal simplex)",
    )
    ap.add_argument("--quick", action="store_true", help="3 instances only")
    ap.add_argument(
        "--sequential", action="store_true",
        help="small/full suites: solve instances one by one (the pre-r4 "
             "headline mode) instead of grouped vmapped batches",
    )
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument(
        "--no-highs", action="store_true",
        help="skip the HiGHS external-baseline pass",
    )
    ap.add_argument(
        "--batch",
        action="store_true",
        help="also time the small suite as one vmapped fleet solve",
    )
    args = ap.parse_args(argv)

    import relp_tpu  # noqa: F401
    from relp_tpu.io import import_lp
    from relp_tpu.model.elements import LinearProgramType
    from relp_tpu.simplex.driver import solve_general_form
    from relp_tpu.utils.config import SolverConfig

    if args.suite == "fleet":
        return run_fleet(args, NETLIB_DIR)

    names = {
        "small": SUITE_SMALL,
        "full": SUITE_FULL,
        "large": SUITE_LARGE,
        "xl": SUITE_XL,
    }[args.suite]
    if args.quick:
        names = names[:3]
    inverse = args.inverse or ("eta" if args.suite == "xl" else "dense")
    auto_engine = args.algorithm == "auto"
    algorithm = (
        ("ipm" if args.suite == "large" else "pdlp")
        if auto_engine
        else (args.algorithm or ("pdlp" if args.suite == "xl" else "primal"))
    )
    config = SolverConfig(
        inverse=inverse,
        algorithm=algorithm,
        # first-order/interior engines are timed WITHOUT the crossover
        # polish (one engine per number; the suite's objective checks
        # accept the certified non-vertex point)
        pdlp_crossover=algorithm not in ("pdlp", "ipm"),
        # XL tier: the f64 relative-KKT floor sits above 1e-6 on STOCFOR3
        # (~2.5e-6, where the objective is already within 6e-9 of Koch);
        # the suite's objective checks are at rel 1e-5, so accept 3e-6
        # instead of burning the budget in the simplex fallback
        pdlp_accept=3e-6 if args.suite == "xl" else 1e-6,
    )
    base = NETLIB_DIR
    paths = [(n, f"{base}/{n}.SIF") for n in names]

    # per-instance engine map for --algorithm auto: the IPM converges 7/8
    # large instances in 21-89 Mehrotra iterations.  GREENBEA stays on the
    # primal simplex: GREENBEA's magnitudes (|obj| = 7.3e7, duals ~1e5)
    # turn a 2e-7 scaled-space KKT into ~9e4 absolute objective slop —
    # the suite's 1e0 absolute check effectively demands a VERTEX.
    # (Measured before the H100; re-measure before relying on it.)
    AUTO_PRIMAL = {"GREENBEA"}

    def cfg_for(name):
        if not auto_engine or name not in AUTO_PRIMAL:
            return config
        import dataclasses as _dc2

        return _dc2.replace(
            config, algorithm="primal", pdlp_crossover=True
        )

    # ---- suite-level batching: the small Netlib instances are
    # embarrassingly parallel — group them by shape bucket and solve each
    # group as ONE vmapped warm-started device program, so the suite wall
    # amortizes dispatch and per-instance Python.
    batched = (
        args.suite in ("small", "full")
        and not args.sequential
        and not args.quick
        and algorithm == "primal"
    )

    if batched:
        import dataclasses as _dc

        from relp_tpu.simplex.driver import solve_general_forms_batched

        # Per-instance engine choice: 25FV47's 3779 sequential pivots set
        # the suite's floor; the interior-point engine solves it in ~26
        # Mehrotra iterations of GEMMs + Cholesky (kkt ~3e-10).  The IPM
        # program for its bucket is warmed (untimed) like every batched
        # group program.
        ipm_names = {"25FV47"}
        ipm_paths = [(n, p) for n, p in paths if n in ipm_names]
        bat_paths = [(n, p) for n, p in paths if n not in ipm_names]
        ipm_config = _dc.replace(
            config, algorithm="ipm", pdlp_crossover=False
        )

        solve_general_forms_batched(
            [import_lp(p) for _, p in bat_paths], config
        )  # warmup: compile every group's program
        for _, p in ipm_paths:
            solve_general_form(import_lp(p), ipm_config)
        generals = [import_lp(p) for _, p in bat_paths]
        ipm_generals = [import_lp(p) for _, p in ipm_paths]
        t0 = time.perf_counter()
        results = solve_general_forms_batched(generals, config)
        ipm_results = []
        for (name, _), g in zip(ipm_paths, ipm_generals):
            r = solve_general_form(g, ipm_config)
            obj = r.solution.objective_value if r.solution else None
            exp = LARGE_EXPECTED.get(name) or _SMALL_EXPECTED.get(name)
            if (
                r.kind is not LinearProgramType.FINITE_OPTIMUM
                or obj is None
                or (exp is not None and abs(obj - exp[0]) > exp[1])
            ):
                # honest fallback INSIDE the timed region: the simplex
                # re-solve pays for the failed IPM attempt
                r = solve_general_form(import_lp(dict(paths)[name]), config)
            ipm_results.append(r)
        total_wall = time.perf_counter() - t0
        solved = 0
        total_iters = 0
        per_instance = {}
        objs = {}
        for (name, _), res in zip(
            bat_paths + ipm_paths, list(results) + ipm_results
        ):
            ok = res.kind is LinearProgramType.FINITE_OPTIMUM
            solved += int(ok)
            iters = res.simplex.iterations if res.simplex else 0
            total_iters += iters
            obj = res.solution.objective_value if res.solution else None
            objs[name] = obj
            entry = {"status": res.kind.value, "iters": iters,
                     "objective": obj}
            exp = LARGE_EXPECTED.get(name) or _SMALL_EXPECTED.get(name)
            if exp is not None and obj is not None:
                entry["objective_ok"] = bool(abs(obj - exp[0]) <= exp[1])
                solved -= int(ok and not entry["objective_ok"])
            per_instance[name] = entry
            if args.verbose:
                print(f"# {name}: {res.kind.value} iters={iters}",
                      file=sys.stderr)

        payload = {
            "metric": f"netlib_{args.suite}_wall_s",
            "value": round(total_wall, 3),
            "unit": "seconds (lower is better)",
            "mode": "batched",
            "solved": f"{solved}/{len(names)}",
            "iters_per_s": round(total_iters / max(total_wall, 1e-9), 2),
            "total_iters": total_iters,
            "hardware": _hardware(),
        }
        if not args.no_highs:
            highs_wall, highs_solved = _highs_wall(paths, verbose=args.verbose)
            payload["highs_wall_s"] = round(highs_wall, 3)
            payload["highs_solved"] = f"{highs_solved}/{len(names)}"
            payload["vs_highs_wall"] = round(
                highs_wall / max(total_wall, 1e-9), 3
            )
        if args.verbose:
            payload["instances"] = per_instance
        print(json.dumps(payload))
        return 0

    # warmup pass: populate the jit cache for every padded shape bucket
    for name, path in paths:
        try:
            solve_general_form(import_lp(path), cfg_for(name))
        except Exception as e:  # keep benching the rest
            print(f"# warmup {name}: {e}", file=sys.stderr)

    total_wall = 0.0
    total_iters = 0
    total_flops = 0.0
    rows_removed = 0
    cols_removed = 0
    solved = 0
    per_instance = {}
    for name, path in paths:
        t0 = time.perf_counter()
        try:
            general = import_lp(path)
            m0, n0 = general.nr_constraints, general.nr_variables
            res = solve_general_form(general, cfg_for(name))
        except Exception as e:
            print(f"# {name}: EXC {e}", file=sys.stderr)
            per_instance[name] = {"status": "exception"}
            continue
        dt = time.perf_counter() - t0
        ok = res.kind is LinearProgramType.FINITE_OPTIMUM
        iters = res.simplex.iterations if res.simplex else 0
        total_wall += dt
        total_iters += iters
        rows_removed += m0 - general.nr_constraints
        cols_removed += n0 - general.nr_variables
        if res.simplex and res.simplex.metrics:
            total_flops += _flops_for(res.simplex.metrics, cfg_for(name))
        obj = res.solution.objective_value if res.solution else None
        entry = {
            "status": res.kind.value,
            "iters": iters,
            "wall_s": round(dt, 3),
            "objective": obj,
            "engine": cfg_for(name).algorithm,
            "presolve_removed": [m0 - general.nr_constraints,
                                 n0 - general.nr_variables],
        }
        if res.simplex and res.simplex.metrics:
            entry["matrix_format"] = res.simplex.metrics.matrix_format
            entry["hbm_bytes_est"] = _hbm_bytes(res.simplex.metrics, cfg_for(name))
        exp = LARGE_EXPECTED.get(name)
        if exp is not None and obj is not None:
            entry["objective_ok"] = bool(abs(obj - exp[0]) <= exp[1])
            ok = ok and entry["objective_ok"]
        per_instance[name] = entry
        solved += int(ok)
        if args.verbose:
            print(f"# {name}: {res.kind.value} iters={iters} wall={dt:.3f}s",
                  file=sys.stderr)

    iters_per_s = total_iters / max(total_wall, 1e-9)
    payload = {
        "metric": f"netlib_{args.suite}_wall_s",
        "value": round(total_wall, 3),
        "unit": "seconds (lower is better)",
        "solved": f"{solved}/{len(names)}",
        "iters_per_s": round(iters_per_s, 2),
        "total_iters": total_iters,
        "flops_modeled_gflops": round(total_flops / 1e9, 1),
        "flops_rate_gflops_s": round(total_flops / max(total_wall, 1e-9) / 1e9, 2),
        "presolve_rows_removed": rows_removed,
        "presolve_cols_removed": cols_removed,
        "hardware": _hardware(),
    }

    if not args.no_highs:
        highs_wall, highs_solved = _highs_wall(paths, verbose=args.verbose)
        payload["highs_wall_s"] = round(highs_wall, 3)
        payload["highs_solved"] = f"{highs_solved}/{len(names)}"
        payload["vs_highs_wall"] = round(highs_wall / max(total_wall, 1e-9), 3)

    if args.suite in ("large", "xl") or args.verbose:
        payload["instances"] = per_instance

    if args.batch:
        from relp_tpu.simplex.driver import solve_general_forms_batched

        fleet_names = SUITE_SMALL
        generals = [import_lp(f"{base}/{n}.SIF") for n in fleet_names]
        solve_general_forms_batched(generals, config)  # warmup/compile
        generals = [import_lp(f"{base}/{n}.SIF") for n in fleet_names]
        t0 = time.perf_counter()
        results = solve_general_forms_batched(generals, config)
        dt = time.perf_counter() - t0
        ok = sum(
            1
            for r in results
            if r.kind is LinearProgramType.FINITE_OPTIMUM
        )
        payload["batch_small_wall_s"] = round(dt, 3)
        payload["batch_small_solved"] = f"{ok}/{len(fleet_names)}"

    print(json.dumps(payload))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
