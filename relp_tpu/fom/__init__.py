"""First-order LP methods (the device scale path).

The simplex engines (relp_tpu.simplex) are the exactness path: optimal
bases, duals, warm starts.  At the hyper-sparse XL tier their per-pivot
O(m²) dense-inverse work is dominated by device-memory traffic; a
primal-dual hybrid-gradient method (PDLP family, as in cuPDLP on GPUs)
needs only two SpMVs and vector ops per iteration — no inverse, no
factorization.  No reference counterpart (rust-lp is simplex-only; its
exact arithmetic cannot express iterative convergence).
"""

from relp_tpu.fom.pdhg import (  # noqa: F401
    solve_pdhg_batched,
    solve_pdhg_chunk,
)
