"""Distributed execution: device meshes, sharded pricing, batched solves.

The reference is single-threaded/single-process (SURVEY §2.8); this package
is the *new* multi-device scaling layer:

- ``mesh.py`` — mesh construction ('batch' × 'cols' axes),
- ``sharded.py`` — the simplex solve pjit-sharded: column blocks of A
  partitioned over 'cols' (pricing = the hot matvec, reduced via XLA
  collectives), basis inverse replicated,
- ``batched.py`` — scenario batching: vmap over many same-shape LPs,
  sharded over 'batch' (the data-parallel analogue).
"""

from relp_tpu.parallel.mesh import make_solver_mesh
from relp_tpu.parallel.sharded import solve_sharded
from relp_tpu.parallel.batched import solve_batched
from relp_tpu.parallel.multihost import global_solver_mesh, initialize_distributed

__all__ = [
    "global_solver_mesh",
    "initialize_distributed",
    "make_solver_mesh",
    "solve_batched",
    "solve_sharded",
]
