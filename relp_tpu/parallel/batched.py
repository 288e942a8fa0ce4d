"""Scenario-batched solves: many same-shape LPs at once (the DP analogue).

The reference solves one LP per process; on a device, throughput for LP *fleets*
(scenario analysis, column-generation subproblems, relaxations in a future
branch-and-bound) comes from vmapping the whole two-phase solve over a
leading scenario axis and sharding that axis over the 'batch' mesh
dimension.  Every scenario runs the same static program; divergent iteration
counts are handled by the shared ``max_iter`` bound with early-exited
scenarios idling (their ``status`` freezes the state via the while-loop
condition being per-program — scenarios that finish keep executing no-op
iterations until all are done; acceptable for same-shape fleets).
"""

from __future__ import annotations

import functools

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from relp_tpu.simplex.core import solve_core
from relp_tpu.utils.config import SolverConfig


@functools.partial(jax.jit, static_argnames=("cfg",))
def _solve_batch(A, b, c, lb, ub, cfg: SolverConfig, max_iter: int):
    # a 2-D A is SHARED across the fleet (in_axes=None): one device copy
    # serves every lane and the per-lane matvecs fuse into GEMMs — a
    # materialized (batch, m, n) stack of a shared 80BAU3B-scale A would
    # be tens of GB
    a_ax = None if A.ndim == 2 else 0
    # nested=True: hoists the refactorization out of the iteration body —
    # under vmap an in-loop refactor cond lowers to a select whose O(m³)
    # branch would execute on EVERY iteration (see solve_core)
    solver = functools.partial(
        solve_core, cfg=cfg, max_iter=max_iter, nested=True
    )
    return jax.vmap(solver, in_axes=(a_ax, 0, 0, 0, 0))(A, b, c, lb, ub)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _solve_batch_warm(A, b, c, lb, ub, basis0, vstat0, art_sign0, phase0,
                      cfg: SolverConfig, max_iter: int):
    a_ax = None if A.ndim == 2 else 0

    def solver(A, b, c, lb, ub, basis0, vstat0, art_sign0, phase0):
        return solve_core(
            A, b, c, lb, ub, cfg=cfg, max_iter=max_iter,
            basis0=basis0, vstat0=vstat0, art_sign0=art_sign0, phase0=phase0,
            nested=True,
        )
    return jax.vmap(solver, in_axes=(a_ax,) + (0,) * 8)(
        A, b, c, lb, ub, basis0, vstat0, art_sign0, phase0
    )


def solve_batched(
    A, b, c, lb, ub, cfg: SolverConfig, max_iter: int, mesh: Mesh = None,
    warm=None,
):
    """Solve a stack of LPs: inputs have a leading scenario axis.

    With a mesh, the scenario axis is sharded over 'batch' (and columns over
    'cols' when its size divides the column count).

    ``warm`` optionally carries stacked warm-start arrays
    ``dict(basis0, vstat0, art_sign0, phase0)`` (one row per scenario) —
    the slack-crash cold start and the shared-A fleet warm start are both
    expressed through this signature, exactly like the single-solve
    driver, so every entry shares ONE compiled program per shape.
    """
    arrays = [np.asarray(x, np.float64) for x in (A, b, c, lb, ub)]
    if mesh is None:
        # pin once: numpy-leaved jit args re-transfer on EVERY chunked
        # continuation call (a 256-scenario fleet's A stack is hundreds of
        # MB)
        arrays = list(jax.device_put(tuple(arrays)))
    if mesh is not None:
        n = arrays[0].shape[-1]
        cols_ok = n % mesh.shape["cols"] == 0
        col_axis = "cols" if cols_ok else None
        shardings = [
            NamedSharding(mesh, P("batch", None, col_axis)),  # A
            NamedSharding(mesh, P("batch", None)),            # b
            NamedSharding(mesh, P("batch", col_axis)),        # c
            NamedSharding(mesh, P("batch", col_axis)),        # lb
            NamedSharding(mesh, P("batch", col_axis)),        # ub
        ]
        arrays = [jax.device_put(x, s) for x, s in zip(arrays, shardings)]

    # bounded device executions with exact warm-start continuation (the
    # driver's chunking)
    from relp_tpu.simplex import status as st_codes

    chunk = max(1, int(cfg.device_chunk_iters))
    m_rows = arrays[0].shape[-2]
    batch_n = arrays[1].shape[0]
    # scale down for problem size AND batch width (per-step cost multiplies)
    scale_div = max(1.0, (m_rows / 1024.0) ** 2) * max(1.0, batch_n / 4.0)
    chunk = max(200, int(chunk / scale_div))
    n_cols = arrays[0].shape[-1]
    done = 0
    if warm is not None:
        out = _solve_batch_warm(
            *arrays,
            jnp_asarray_i32(warm["basis0"]),
            jnp_asarray_i32(warm["vstat0"]),
            np.asarray(warm["art_sign0"], np.float64),
            jnp_asarray_i32(warm["phase0"]),
            cfg=cfg,
            max_iter=min(chunk, max_iter),
        )
    else:
        out = _solve_batch(*arrays, cfg=cfg, max_iter=min(chunk, max_iter))
    done += int(np.max(np.asarray(out.it)))
    while (
        done < max_iter
        and bool(np.any(np.asarray(out.status) == st_codes.ITERATION_LIMIT))
    ):
        out = _solve_batch_warm(
            *arrays,
            jnp_asarray_i32(out.basis),
            jnp_asarray_i32(out.vstat)[:, :n_cols],
            out.art_sign,
            jnp_asarray_i32(out.phase),
            cfg=cfg,
            max_iter=min(chunk, max_iter - done),
        )
        done += int(np.max(np.asarray(out.it)))
    return out


def jnp_asarray_i32(x):
    import jax.numpy as jnp

    return jnp.asarray(x, jnp.int32)
