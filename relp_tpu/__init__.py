"""relp_tpu — a linear programming framework on accelerators, in JAX.

A from-scratch rebuild of the capabilities of RELP (vandenheuvel/rust-lp)
designed for an accelerator:

- the revised simplex method runs as a single jitted ``lax.while_loop`` on
  device (pricing = one fused matvec over the column pool, FTRAN = matvec
  against a maintained dense basis inverse, basis update = rank-1
  product-form update),
- exact rational arithmetic (reference ``src/data/number_types/``) is replaced
  by float64 with tolerance-based pivoting, periodic refactorization and an
  optional CPU-side exact verifier (``relp_tpu.numerics``),
- lazy column generation (reference ``MatrixProvider``,
  ``src/algorithm/two_phase/matrix_provider/mod.rs:37-136``) becomes masked
  pricing over a column pool resident in device memory,
- scaling is via ``jax.sharding`` meshes: column blocks sharded for pricing,
  scenario batches vmapped/sharded for throughput (``relp_tpu.parallel``).

Layout:
    model/      problem representations (GeneralForm, elements, Solution)
    io/         MPS/SIF parsing (free + fixed format) and conversion
    presolve/   presolving rules + postsolve reconstruction
    providers/  column-oracle layer (standard-form builder, filters)
    models/     LP model families (networks, seeded generated families)
    simplex/    the two-phase revised simplex engine (device code)
    ops/        device kernels: linalg/refactorization, matrix layouts
                (dense/ELL/hybrid/bricks), panel matvecs
    parallel/   device meshes, sharded pricing, batched solves
    utils/      config, logging, timers

The platform is JAX's own choice; ``JAX_PLATFORMS=cpu`` runs on the host.
"""

import os

import jax

# The solver carries f64 state (reference uses exact rationals; see
# SURVEY.md §2.1). Must be set before any JAX computation.
jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: the solve core is one large while_loop whose
# first compile is expensive.  JAX_COMPILATION_CACHE_DIR, when set, is JAX's
# own setting and stays untouched; otherwise the cache lives at a fixed path
# inside the checkout (the path is part of the cache key).
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)

from relp_tpu.model.elements import (  # noqa: E402
    ConstraintRelation,
    LinearProgramType,
    Objective,
    RangedConstraintRelation,
    VariableType,
)
from relp_tpu.model.solution import Solution  # noqa: E402
from relp_tpu.utils.config import SolverConfig  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "ConstraintRelation",
    "LinearProgramType",
    "Objective",
    "RangedConstraintRelation",
    "Solution",
    "SolverConfig",
    "VariableType",
    "__version__",
]
