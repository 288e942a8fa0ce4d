"""Worker for tests/test_multihost.py: one process of a 2-process CPU
"pod".  Joins the distributed runtime, builds the global solver mesh,
and runs a sharded batched solve (scenario axis across processes)."""

import os
import sys

# running as `python tests/multihost_worker.py` puts tests/ (not the repo
# root) on sys.path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# must be set before relp_tpu imports jax (tests/conftest.py does the
# same dance for the single-process suite)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

from relp_tpu.parallel.multihost import (  # noqa: E402
    global_solver_mesh, initialize_distributed,
)


def main() -> None:
    import jax

    initialize_distributed(
        coordinator_address=os.environ["RELP_TPU_COORD"],
        num_processes=int(os.environ["RELP_TPU_NPROC"]),
        process_id=int(os.environ["RELP_TPU_PROC_ID"]),
    )
    print(
        f"devices={len(jax.devices())} processes={jax.process_count()}",
        flush=True,
    )
    mesh = global_solver_mesh()
    print(f"mesh={tuple(mesh.shape.values())}", flush=True)

    # a tiny 2-scenario fleet (one scenario per process):
    #   min -x1 - 2 x2   s.t. x1 + x2 + s = b_scen,  0 <= x <= 4, s >= 0
    # optimum: x2 = min(b, 4), x1 = max(b - 4, 0) -> obj known in closed form
    from jax.sharding import NamedSharding, PartitionSpec as P

    from relp_tpu.simplex import status as st
    from relp_tpu.simplex.core import solve_core
    from relp_tpu.utils.config import SolverConfig

    m_pad, n_pad = 8, 128
    batch = 2
    b_scen = np.array([3.0, 6.0])
    A = np.zeros((batch, m_pad, n_pad))
    b = np.zeros((batch, m_pad))
    c = np.zeros((batch, n_pad))
    lb = np.zeros((batch, n_pad))
    ub = np.zeros((batch, n_pad))
    for s in range(batch):
        A[s, 0, 0] = A[s, 0, 1] = A[s, 0, 2] = 1.0
        b[s, 0] = b_scen[s]
        c[s, :2] = [-1.0, -2.0]
        ub[s, :2] = 4.0
        ub[s, 2] = np.inf

    shard_b = NamedSharding(mesh, P("batch"))
    shard_bm = NamedSharding(mesh, P("batch", None))
    shard_bmn = NamedSharding(mesh, P("batch", None, None))

    def _global(arr, sharding):
        return jax.make_array_from_callback(
            arr.shape, sharding, lambda idx: arr[idx]
        )

    A_g = _global(A, shard_bmn)
    vecs = [_global(v, shard_bm) for v in (b, c, lb, ub)]

    import functools

    cfg = SolverConfig()

    @functools.partial(jax.jit, static_argnames=("cfg", "max_iter"))
    def fleet(A, b, c, lb, ub, cfg, max_iter):
        return jax.vmap(
            functools.partial(solve_core, cfg=cfg, max_iter=max_iter)
        )(A, b, c, lb, ub)

    # the inputs carry NamedShardings over the global mesh; GSPMD
    # partitions the vmapped solve across processes from those alone
    out = jax.block_until_ready(fleet(A_g, *vecs, cfg=cfg, max_iter=64))

    # every process can read the replicated-enough pieces of ITS scenarios
    from jax.experimental import multihost_utils

    pid = jax.process_index()
    status = np.asarray(
        multihost_utils.process_allgather(out.status, tiled=True)
    ).ravel()[:batch]
    objs = np.asarray(
        multihost_utils.process_allgather(out.obj, tiled=True)
    ).ravel()[:batch]
    expected = np.array([
        -(2.0 * min(bs, 4.0) + max(bs - 4.0, 0.0)) for bs in b_scen
    ])
    ok = bool(
        np.all(status == st.OPTIMAL)
        and np.allclose(objs, expected, atol=1e-9)
    )
    print(f"pid={pid} objs={objs.tolist()} objective_ok={ok}", flush=True)
    raise SystemExit(0 if ok else 3)


if __name__ == "__main__":
    main()
