"""Multi-host execution entry points.

Single-controller JAX: each host process calls
:func:`initialize_distributed`, after which ``jax.devices()`` spans the
pod slice and the meshes built by :func:`global_solver_mesh` place

- the **'batch' axis across hosts** (scenario fleets shard over
  per-host device groups; no cross-host traffic during a solve), and
- the **'cols' axis within a host's cards** (pricing collectives ride
  NVLink).

This is the layout SURVEY §2.8 prescribes: collectives for the pricing
argmax/ratio reductions stay within a host; the only traffic between hosts
is initial data placement and final result gathers.  Multi-host paths are
exercised by two CPU processes in tests/test_multihost.py and by
``__graft_entry__.dryrun_multichip`` on a virtual CPU mesh.
"""

from __future__ import annotations

from typing import Optional

import jax

from relp_tpu.parallel.mesh import make_solver_mesh


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join the multi-host runtime (idempotent; no-op single-process)."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_solver_mesh(batch: Optional[int] = None, cols: Optional[int] = None):
    """Mesh over all (global) devices: 'batch' across hosts, 'cols' within.

    Defaults: batch = number of processes, cols = local device count.
    """
    n_proc = jax.process_count()
    n_local = jax.local_device_count()
    if batch is None:
        batch = n_proc
    if cols is None:
        cols = (n_proc * n_local) // batch
    return make_solver_mesh(batch=batch, cols=cols)
