#!/usr/bin/env python3
"""Smoke run of every solve engine on one GPU, checked against HiGHS.

Usage (from the root of a checkout):

    python chip_smoke.py                  # phases 0-6 on one card
    python chip_smoke.py --multi-gpu      # the four-card paths only
    python chip_smoke.py --ab pdlp        # A/B timings of one engine choice
    python chip_smoke.py --log run.log    # also write the solver's log

Phases (one process; the CLI phases call ``relp_tpu.cli.main`` in-process
so no second process ever opens the card):

    0 device      the GPU, its name and power limit, JAX, compile cache
    1 cli-primal  sparse main LP → MPS file → CLI, default (primal) engine
    2 dual        the same file through the CLI with --algorithm dual
    3 ipm         dense allocation LP, interior point + crossover
    4 pdlp        sparse main LP, first-order PDHG + crossover
    5 fleets      batched IPM fleet of dense scenarios, batched PDLP and
                  primal-core fleets of small sparse scenarios
    6 xl-pdlp     sparse XL LP, first-order PDHG (one run)
      xl-default  the default engine's XL routes solved to the end (host
                  sparse-LU dual, external device dual and primal), and
                  on the XL LP itself for a fixed pivot budget

Every solve prints one line: engine, padded shape, matrix layout,
iterations, cold wall (compile included) and warm wall, the objective next
to HiGHS's, and the relative error against its tolerance.  Vertex results
must agree to 1e-6, first-order and interior results without crossover to
1e-5 (those engines stop at a relative KKT of 1e-6).  At the XL size the
reference is a duality-gap certificate computed on the host (HiGHS needs
more than a quarter of an hour there); the default engine's XL routes are
checked to the end on smaller instances (see :func:`phase_xl`).
Any failure exits non-zero.  The last line of standard output is one JSON
object naming the device; it is printed only when every phase passed on a
GPU.

HiGHS runs on the host in worker processes started with ``spawn``; they
never import the solver's device code, so only this process uses the card.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import logging
import os
import subprocess
import sys
import tempfile
import time

VERTEX_TOL = 1e-6
FIRST_ORDER_TOL = 1e-5
# (rows, columns) of each generated instance
SIZES = {
    "main": (2000, 6000),
    "xl": (16000, 48000),
    "fleet": (200, 600),
    "dense": (768, 1536),
}
FLEET_N = 16
XL_ROUTE_ITERS = 2000
REFACTOR_SIZES = (2048, 16384)  # the main and XL row buckets
PHASES = ("cli-primal", "dual", "ipm", "pdlp", "fleets", "xl-pdlp", "xl-default")
AB_CHOICES = ("pdlp", "ipm", "xl-pdlp", "xl-route", "refactor")
ROOT = os.path.dirname(os.path.abspath(__file__))


class SmokeFailure(RuntimeError):
    """A phase missed its tolerance or did not solve."""


def rel_err(obj: float, ref: float) -> float:
    return abs(obj - ref) / max(1.0, abs(ref))


class SolveLog(logging.Handler):
    """Collects the per-solve metrics records the driver logs."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("solve {"):
            self.records.append(json.loads(msg[len("solve "):]))

    def last(self) -> dict:
        return self.records[-1] if self.records else {}


class References:
    """HiGHS objectives computed in a pool of spawned host processes, so
    they overlap the device phases."""

    def __init__(self, workers: int):
        import multiprocessing as mp

        self._pool = mp.get_context("spawn").Pool(processes=workers)
        self._jobs = {}

    def submit(self, key, general):
        from relp_tpu.models.generated import general_arrays, highs_solve

        if key not in self._jobs:
            self._jobs[key] = self._pool.apply_async(
                highs_solve, (general_arrays(general),)
            )

    def get(self, key) -> float:
        return self._jobs[key].get()

    def close(self):
        self._pool.terminate()
        self._pool.join()


def _timed(fn):
    """Run ``fn`` twice: cold (compiles) and warm.  Returns the warm result
    and both walls."""
    t0 = time.perf_counter()
    fn()
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = fn()
    return out, cold, time.perf_counter() - t0


def report(phase, engine, obj, ref, tol, cold, warm, metrics=None, extra="",
           ref_label="highs"):
    err = rel_err(obj, ref) if obj is not None else float("inf")
    ok = err <= tol
    m = metrics or {}
    print(
        f"[{phase}] {engine:<16} m_pad={m.get('m_padded', '-')} "
        f"n_pad={m.get('n_padded', '-')} format={m.get('matrix_format') or '-'} "
        f"iters={m.get('iterations', '-')} cold_s={cold:.3f} "
        + (f"warm_s={warm:.3f} " if warm is not None else "warm_s=not-run ")
        + f"obj={obj!r} {ref_label}={ref!r} rel_err={err:.3e} tol={tol:.0e} "
        f"{'OK' if ok else 'FAIL'}{extra}",
        flush=True,
    )
    if not ok:
        raise SmokeFailure(f"{phase} {engine}: rel_err {err:.3e} > {tol:.0e}")


def _objective(res) -> float:
    from relp_tpu.model.elements import LinearProgramType

    if res.kind is not LinearProgramType.FINITE_OPTIMUM or res.solution is None:
        raise SmokeFailure(f"not solved: {res.kind.value}")
    return float(res.solution.objective_value)


# ---- instances --------------------------------------------------------------

def main_lp():
    from relp_tpu.models.generated import sparse_box_lp

    return sparse_box_lp(*SIZES["main"])


def xl_lp():
    from relp_tpu.models.generated import sparse_box_lp

    return sparse_box_lp(*SIZES["xl"])


def dense_lp(scenario=None):
    from relp_tpu.models.generated import dense_allocation_lp

    return dense_allocation_lp(*SIZES["dense"], scenario=scenario)


def fleet_lp(scenario):
    from relp_tpu.models.generated import sparse_box_lp

    return sparse_box_lp(*SIZES["fleet"], scenario=scenario)


# the default engine's XL routes, each run at a size where it finishes:
# (engine, instance, reference key, config).  refactor_external_m=1 turns
# the XL routing on at any size; xl_engine="dense" takes its device dual
# instead of the host LU, xl_engine="primal" (with the threshold left as
# it is) its device primal
XL_ROUTES = (
    ("xl-route/host-lu", main_lp, "main", {"refactor_external_m": 1}),
    ("xl-route/dev-dual", lambda: fleet_lp(None), ("fleet", None),
     {"refactor_external_m": 1, "xl_engine": "dense"}),
    ("xl-route/dev-primal", lambda: fleet_lp(None), ("fleet", None),
     {"xl_engine": "primal"}),
)


def submit_references(refs: References, phases):
    if {"cli-primal", "dual", "pdlp", "xl-default"} & set(phases):
        refs.submit("main", main_lp())
    if "xl-default" in phases:
        refs.submit(("fleet", None), fleet_lp(None))
    if "ipm" in phases:
        refs.submit("dense", dense_lp())
    if "fleets" in phases:
        for s in range(FLEET_N):
            refs.submit(("dense", s), dense_lp(s))
            refs.submit(("fleet", s), fleet_lp(s))


# ---- phases -----------------------------------------------------------------

def phase_device() -> dict:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SmokeFailure(
            f"JAX found no GPU (device 0 is {dev.platform}: {dev.device_kind})"
        )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    from relp_tpu.io.native import native_available
    from relp_tpu.simplex import ftlu

    print(f"[device] {smi}", flush=True)
    print(
        f"[device] jax={jax.__version__} platform={dev.platform} "
        f"kind={dev.device_kind} count={len(jax.devices())} "
        f"compile_cache={jax.config.jax_compilation_cache_dir} "
        f"native_mps_scan={native_available()} native_ftlu={ftlu.available()}",
        flush=True,
    )
    return {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }


def _cli(path, *flags):
    from relp_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([path, "--json", "-q", *flags])
    if rc != 0:
        raise SmokeFailure(f"cli exit {rc}: {buf.getvalue()[-300:]}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def phase_cli(refs, log, workdir, phases):
    """Phases 1 and 2: the user's path, file → parse → presolve → lower →
    device simplex, through the CLI."""
    from relp_tpu.io.mps_write import export_mps

    path = os.path.join(workdir, "sparse_box_main.mps")
    export_mps(main_lp(), path)
    ref = refs.get("main")
    for phase, flags in (("cli-primal", ()), ("dual", ("--algorithm", "dual"))):
        if phase not in phases:
            continue
        out, cold, warm = _timed(lambda: _cli(path, *flags))
        met = log.last()
        extra = ""
        if phase == "cli-primal":
            extra = (
                f" refactor_polish={met.get('refactor_polish')} "
                f"refactor_newton={met.get('refactor_newton')} "
                f"refactor_gauss_jordan={met.get('refactor_gj')}"
            )
        report(phase, flags[-1] if flags else "primal", out["objective"],
               ref, VERTEX_TOL, cold, warm, met, extra)


def phase_ipm(refs, log):
    from relp_tpu.simplex.driver import solve_general_form
    from relp_tpu.utils.config import SolverConfig

    cfg = SolverConfig(algorithm="ipm")
    res, cold, warm = _timed(lambda: solve_general_form(dense_lp(), cfg))
    report("ipm", "ipm+crossover", _objective(res), refs.get("dense"),
           VERTEX_TOL, cold, warm, log.last())


def phase_pdlp(refs, log):
    from relp_tpu.simplex.driver import solve_general_form
    from relp_tpu.utils.config import SolverConfig

    cfg = SolverConfig(algorithm="pdlp")
    res, cold, warm = _timed(lambda: solve_general_form(main_lp(), cfg))
    report("pdlp", "pdlp+crossover", _objective(res), refs.get("main"),
           VERTEX_TOL, cold, warm, log.last())


def run_fleet(refs, kind, algorithm, cfg_extra=None, mesh=None):
    """One batched fleet; returns (results, cold, warm, refs)."""
    from relp_tpu.simplex.driver import solve_general_forms_batched
    from relp_tpu.utils.config import SolverConfig

    make = dense_lp if kind == "dense" else fleet_lp
    # presolve off keeps every lane's lowered A identical (the shared-A
    # fleet shape)
    cfg = SolverConfig(algorithm=algorithm, presolve=False, **(cfg_extra or {}))
    results, cold, warm = _timed(lambda: solve_general_forms_batched(
        [make(s) for s in range(FLEET_N)], cfg, mesh=mesh,
    ))
    return results, cold, warm, [refs.get((kind, s)) for s in range(FLEET_N)]


def report_fleet(phase, engine, results, cold, warm, ref, tol):
    errs = [rel_err(_objective(r), h) for r, h in zip(results, ref)]
    host = sum(bool(r.simplex and r.simplex.host_fallback) for r in results)
    iters = max(r.simplex.iterations for r in results if r.simplex)
    worst = max(errs)
    ok = worst <= tol and host == 0
    print(
        f"[{phase}] {engine:<16} lanes={len(results)} device_lanes="
        f"{len(results) - host} host_lanes={host} iters={iters} "
        f"cold_s={cold:.3f} warm_s={warm:.3f} lanes_per_s={len(results) / warm:.3f} "
        f"max_rel_err={worst:.3e} tol={tol:.0e} {'OK' if ok else 'FAIL'}",
        flush=True,
    )
    if not ok:
        raise SmokeFailure(
            f"{phase} {engine}: max rel_err {worst:.3e}, {host} host lanes"
        )


def phase_fleets(refs, log):
    # the first-order fleet runs the sparse scenarios: on the dense ones it
    # floors near a relative KKT of 2.5e-5 on the H100 and hands 15 of 16
    # lanes to the host (PERF.md); dense fleets are the IPM fleet's job
    for kind, algorithm in (("dense", "ipm"), ("fleet", "pdlp"),
                            ("fleet", "primal")):
        results, cold, warm, ref = run_fleet(refs, kind, algorithm)
        tol = VERTEX_TOL if algorithm == "primal" else FIRST_ORDER_TOL
        report_fleet("fleets", f"{algorithm}-fleet/{kind}", results, cold,
                     warm, ref, tol)


def certify(arrays, res):
    """Host f64 check of a result where HiGHS is too slow: the primal
    residual, and the objective against the Lagrangian lower bound of the
    returned duals.  Returns ``(objective, bound, residual)``."""
    import numpy as np

    from relp_tpu.models.generated import lagrangian_bound

    A, b, c, lower, upper = arrays
    m, n = A.shape
    values = dict(res.solution.solution_values)
    x = np.array([values[f"x{j}"] for j in range(n)])
    resid = max(
        float(np.max(np.abs(A @ x - b))) / (1.0 + float(np.max(np.abs(b)))),
        float(np.max(np.maximum(lower - x, 0.0))),
        float(np.max(np.maximum(x - upper, 0.0))),
    )
    y = np.zeros(m)
    for name, dual in zip(res.row_names, res.simplex.duals):
        y[int(name[1:])] = dual  # generated rows are named r<i>
    # any multipliers give a valid bound, so either sign convention may
    # be tried
    bound = max(lagrangian_bound(arrays, y), lagrangian_bound(arrays, -y))
    return float(c @ x), bound, resid


def phase_xl(refs, phases, log):
    """Phase 6, the XL tier.

    ``xl-pdlp``: PDLP on the XL instance, checked by :func:`certify`
    (HiGHS needs more than a quarter of an hour there).

    ``xl-default``: the default engine's XL routing (``m_pad >
    refactor_external_m``) solved to the end and checked against HiGHS:
    the host sparse-LU dual on the main instance, and the externally
    refactorized device dual and primal, which the default engine falls
    back to, on the fleet-size instance (:data:`XL_ROUTES` forces each at
    these sizes), so the same programs run to an answer inside the smoke's
    limit.  No route finishes the XL instance itself in that limit, so
    there it runs a fixed pivot budget: a check that its programs fit and
    run on the card, not of an answer."""
    from relp_tpu.model.elements import LinearProgramType
    from relp_tpu.models.generated import general_arrays
    from relp_tpu.simplex.driver import solve_general_form
    from relp_tpu.utils.config import SolverConfig

    if "xl-pdlp" in phases:
        arrays = general_arrays(xl_lp())
        cfg = SolverConfig(algorithm="pdlp", pdlp_crossover=False)
        t0 = time.perf_counter()
        res = solve_general_form(xl_lp(), cfg)
        wall = time.perf_counter() - t0
        _objective(res)
        obj, bound, resid = certify(arrays, res)
        report("xl", "pdlp", obj, bound, FIRST_ORDER_TOL, wall, None,
               log.last(), extra=f" primal_resid={resid:.3e}",
               ref_label="dual_bound")
        if resid > FIRST_ORDER_TOL:
            raise SmokeFailure(f"xl pdlp: primal residual {resid:.3e}")
    if "xl-default" in phases:
        for engine, make, key, changes in XL_ROUTES:
            # one run each (compile included): the host LU's wall is host
            # work, the same cold and warm
            t0 = time.perf_counter()
            res = solve_general_form(make(), SolverConfig(**changes))
            report("xl", engine, _objective(res), refs.get(key), VERTEX_TOL,
                   time.perf_counter() - t0, None, log.last())
        t0 = time.perf_counter()
        res = solve_general_form(xl_lp(), SolverConfig(max_iter=XL_ROUTE_ITERS))
        wall = time.perf_counter() - t0
        met = log.last()
        ran = res.kind in (LinearProgramType.ITERATION_LIMIT,
                           LinearProgramType.FINITE_OPTIMUM)
        print(
            f"[xl] default-budget    m_pad={met.get('m_padded', '-')} "
            f"budget={XL_ROUTE_ITERS}/route iters={met.get('iterations', '-')} "
            f"wall_s={wall:.3f} status={res.kind.value} "
            f"{'RAN' if ran else 'FAIL'} (no answer to check)",
            flush=True,
        )
        if not ran:
            raise SmokeFailure(f"xl default routes: {res.kind.value}")


# ---- four cards -------------------------------------------------------------

def run_multi_gpu(refs, log):
    """Column-sharded pricing (mesh_cols=4) on the main LP and the dense IPM
    fleet sharded over 'batch', each beside the same solve on device 0."""
    import jax

    from relp_tpu.parallel.mesh import make_solver_mesh
    from relp_tpu.simplex.driver import solve_general_form
    from relp_tpu.utils.config import SolverConfig

    if len(jax.devices()) < 4:
        raise SmokeFailure(f"--multi-gpu needs 4 cards, found {len(jax.devices())}")
    ref = refs.get("main")
    for cols in (1, 4):
        # one run each (compile included): four cards bill four times
        t0 = time.perf_counter()
        res = solve_general_form(main_lp(), SolverConfig(mesh_cols=cols))
        report("multi-gpu", f"primal/cols={cols}", _objective(res), ref,
               VERTEX_TOL, time.perf_counter() - t0, None, log.last())
    mesh = make_solver_mesh(batch=4, cols=1, devices=jax.devices()[:4])
    for label, m in (("ipm-fleet/1-card", None), ("ipm-fleet/batch=4", mesh)):
        results, cold, warm, fref = run_fleet(refs, "dense", "ipm", mesh=m)
        report_fleet("multi-gpu", label, results, cold, warm, fref,
                     FIRST_ORDER_TOL)


# ---- A/B timings of engine choices -------------------------------------------

def _ab_line(name, variant, obj, ref, cold, warm, met):
    print(
        f"[ab {name}] {variant:<28} iters={met.get('iterations', '-')} "
        f"cold_s={cold:.3f} warm_s={warm:.3f} obj={obj!r} "
        f"rel_err={rel_err(obj, ref):.3e}",
        flush=True,
    )


@contextlib.contextmanager
def _pdlp_rounds(rounds, fleet=False):
    """Sets the driver's PDHG rounds per device call (single solve or
    fleet) for one A/B side, and restores it."""
    from relp_tpu.simplex import driver

    attr = "_FLEET_PDLP_ROUNDS" if fleet else "_PDLP_ROUNDS"
    old = getattr(driver, attr)
    if rounds is not None:
        setattr(driver, attr, rounds)
    try:
        yield
    finally:
        setattr(driver, attr, old)


def run_ab(name, refs, log):
    """Time both sides of one engine choice on the smoke instances."""
    import dataclasses

    from relp_tpu.simplex.driver import solve_general_form
    from relp_tpu.utils.config import SolverConfig

    def solve_variants(make, ref_key, base, variants, rounds=None):
        """Each variant cold (compile included) then warm, in one process;
        ``rounds`` maps a label to the driver's PDHG rounds per call."""
        if ref_key == "xl":
            from relp_tpu.models.generated import general_arrays

            arrays = general_arrays(make())
        else:
            ref = refs.get(ref_key)
        for label, changes in variants:
            cfg = dataclasses.replace(base, **changes)
            with _pdlp_rounds((rounds or {}).get(label)):
                res, cold, warm = _timed(lambda: solve_general_form(make(), cfg))
            if ref_key == "xl":
                _objective(res)
                obj, ref, _ = certify(arrays, res)
            else:
                obj = _objective(res)
            _ab_line(name, label, obj, ref, cold, warm, log.last())

    if name in ("pdlp", "xl-pdlp"):
        make, key = (main_lp, "main") if name == "pdlp" else (xl_lp, "xl")
        base = SolverConfig(algorithm="pdlp", pdlp_crossover=False,
                            pdlp_matrix="ell", pdlp_precision="f64")
        variants = [
            ("ell/f64/rounds=256", {}),
            ("bricks/f64/rounds=256", {"pdlp_matrix": "bricks"}),
            ("ell/mixed/rounds=256", {"pdlp_precision": "mixed"}),
            ("ell/f64/rounds=32", {}),
            ("bricks/mixed/rounds=32",
             {"pdlp_matrix": "bricks", "pdlp_precision": "mixed"}),
        ]
        rounds = {label: int(label.rsplit("=", 1)[1]) for label, _ in variants}
        if name == "xl-pdlp":
            # bricks lose 16x at this size on one cold run; the A/B left
            # open there is precision and the round cap
            variants = [v for v in variants if v[0].startswith("ell/")]
        solve_variants(make, key, base, variants, rounds=rounds)
        if name == "pdlp":
            # the fleet's rounds per device call
            for cap in (8, 32, 256):
                with _pdlp_rounds(cap, fleet=True):
                    results, cold, warm, fref = run_fleet(refs, "fleet", "pdlp")
                report_fleet(f"ab {name}", f"fleet/rounds={cap}", results,
                             cold, warm, fref, FIRST_ORDER_TOL)
    elif name == "ipm":
        base = SolverConfig(algorithm="ipm", pdlp_crossover=False)
        solve_variants(dense_lp, "dense", base, [
            ("single/f64", {"ipm_ladder": "f64"}),
            ("single/mixed", {"ipm_ladder": "mixed"}),
        ])
        for ladder in ("f64", "mixed"):
            results, cold, warm, fref = run_fleet(
                refs, "dense", "ipm", {"ipm_ladder": ladder}
            )
            report_fleet(f"ab {name}", f"fleet/{ladder}", results, cold,
                         warm, fref, FIRST_ORDER_TOL)
    elif name == "xl-route":
        # rates over a fixed iteration budget: the routes above
        # refactor_external_m (host sparse-LU dual, in-loop device primal,
        # externally refactorized device primal)
        for label, changes in (
            ("host-lu", {}),
            ("device-inloop", {"refactor_external_m": 1 << 30}),
            ("device-external", {"xl_engine": "primal"}),
        ):
            cfg = SolverConfig(max_iter=XL_ROUTE_ITERS, **changes)
            t0 = time.perf_counter()
            res = solve_general_form(xl_lp(), cfg)
            wall = time.perf_counter() - t0
            it = res.simplex.iterations if res.simplex else 0
            print(f"[ab {name}] {label:<16} status={res.kind.value} "
                  f"iters={it} wall_s={wall:.3f} iters_per_s={it / wall:.1f}",
                  flush=True)
    elif name == "refactor":
        ab_refactor()
    else:
        raise SmokeFailure(f"unknown --ab {name}")


def ab_refactor():
    """One refactorization at the main and XL bucket sizes: the repo's
    f32-seed + Newton inverse against XLA's f64 LU inverse."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from relp_tpu.models.generated import sparse_box_matrix
    from relp_tpu.ops.linalg import robust_inverse

    for m in REFACTOR_SIZES:
        # a basis of the sparse family's shape: m seeded columns, each
        # with a unit diagonal so it is nonsingular
        B = sparse_box_matrix(m, m, seed=7).toarray() + np.eye(m)
        Bd = jax.device_put(jnp.asarray(B))
        fns = {
            "robust_inverse": jax.jit(lambda B: robust_inverse(B)[0]),
            "jnp.linalg.inv": jax.jit(jnp.linalg.inv),
        }
        for label, fn in fns.items():
            X = jax.block_until_ready(fn(Bd))  # compile
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                X = jax.block_until_ready(fn(Bd))
                walls.append(time.perf_counter() - t0)
            resid = float(jnp.max(jnp.abs(jnp.eye(m) - Bd @ X)))
            print(f"[ab refactor] m={m} {label:<16} best_s={min(walls):.4f} "
                  f"walls={[round(w, 4) for w in walls]} resid={resid:.2e}",
                  flush=True)


# ---- entry point --------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi-gpu", action="store_true",
                    help="run only the four-card paths (needs 4 GPUs)")
    ap.add_argument("--ab", choices=AB_CHOICES,
                    help="time both sides of one engine choice, then stop")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--log", help="write the solver's INFO log to this file")
    args = ap.parse_args(argv)

    # the solver must come from this checkout: run alone, the script fails
    sys.path.insert(0, ROOT)
    try:
        import relp_tpu
    except ImportError as e:
        print(f"chip_smoke: cannot import the solver next to {ROOT}: {e}",
              file=sys.stderr)
        return 2
    if not os.path.abspath(relp_tpu.__file__).startswith(ROOT + os.sep):
        print(f"chip_smoke: relp_tpu imported from {relp_tpu.__file__}, "
              f"not from {ROOT}", file=sys.stderr)
        return 2

    phases = [p for p in args.phases.split(",") if p]
    if args.multi_gpu:
        phases = ["cli-primal", "fleets"]  # their references only
    elif args.ab:
        phases = {"pdlp": ["pdlp", "fleets"], "ipm": ["ipm", "fleets"],
                  "xl-pdlp": [], "xl-route": [], "refactor": []}[args.ab]

    logger = logging.getLogger("relp_tpu")
    logger.setLevel(logging.INFO)
    solves = SolveLog()
    handlers = [solves]
    if args.log:
        handlers.append(logging.FileHandler(args.log, mode="w"))
        handlers[-1].setFormatter(
            logging.Formatter("%(relativeCreated)d %(message)s")
        )
    for h in handlers:
        logger.addHandler(h)

    refs = None
    try:
        device = phase_device()
        refs = References(workers=min(8, os.cpu_count() or 1))
        submit_references(refs, phases)
        if args.multi_gpu:
            run_multi_gpu(refs, solves)
        elif args.ab:
            run_ab(args.ab, refs, solves)
        else:
            with tempfile.TemporaryDirectory(dir=ROOT) as workdir:
                if {"cli-primal", "dual"} & set(phases):
                    phase_cli(refs, solves, workdir, phases)
            if "ipm" in phases:
                phase_ipm(refs, solves)
            if "pdlp" in phases:
                phase_pdlp(refs, solves)
            if "fleets" in phases:
                phase_fleets(refs, solves)
            if {"xl-pdlp", "xl-default"} & set(phases):
                phase_xl(refs, phases, solves)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        if refs is not None:
            refs.close()
        for h in handlers:
            logger.removeHandler(h)
            h.close()
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
