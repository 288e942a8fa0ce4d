"""Scenario-fleet solving: many perturbed LPs in one vmapped device program
(the data-parallel analogue; reference solves one LP per process).

Run:  JAX_PLATFORMS=cpu python examples/scenario_fleet.py
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import relp_tpu  # noqa: E402,F401
from relp_tpu.io import import_lp  # noqa: E402
from relp_tpu.simplex.driver import solve_general_forms_batched  # noqa: E402
from relp_tpu.utils.config import SolverConfig  # noqa: E402

BASE = "/root/reference/tests/burkardt/problem_files/afiro.mps"
N_SCENARIOS = 16


def main():
    rng = np.random.default_rng(0)
    generals = []
    for s in range(N_SCENARIOS):
        gf = import_lp(BASE)
        gf.b = gf.b * (1.0 + 0.05 * rng.standard_normal(len(gf.b)))  # demand shocks
        generals.append(gf)

    cfg = SolverConfig()
    solve_general_forms_batched([import_lp(BASE)], cfg)  # warm the jit cache
    t0 = time.perf_counter()
    results = solve_general_forms_batched(generals, cfg)
    dt = time.perf_counter() - t0

    objs = [r.solution.objective_value if r.solution else None for r in results]
    ok = sum(1 for r in results if r.solution is not None)
    print(f"solved {ok}/{N_SCENARIOS} scenarios in {dt:.3f}s (one device program)")
    finite = [o for o in objs if o is not None]
    print(f"objective range: [{min(finite):.3f}, {max(finite):.3f}]")


if __name__ == "__main__":
    main()
