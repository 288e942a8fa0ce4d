"""Device mesh construction.

Meshes are 2D: ('batch', 'cols').  'cols' shards the column pool — the
pricing matvec ``d = c − πᵀA`` runs on local blocks with the argmax reduced
by XLA collectives over the cards' links (NVLink within a host); 'batch'
shards independent scenario LPs (vmap axis).  Single-chip meshes are (1, 1).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
from jax.sharding import Mesh


def make_solver_mesh(
    batch: int = 1,
    cols: Optional[int] = None,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    if cols is None:
        cols = len(devices) // batch
    if batch * cols != len(devices):
        raise ValueError(
            f"mesh {batch}x{cols} does not cover {len(devices)} devices"
        )
    # Auto axes: shardings propagate through the solve by GSPMD inference
    # (explicit sharding-in-types mode would demand per-op out_shardings).
    return jax.make_mesh(
        (batch, cols),
        ("batch", "cols"),
        devices=devices,
        axis_types=(jax.sharding.AxisType.Auto,) * 2,
    )
