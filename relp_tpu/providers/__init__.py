"""Column-oracle layer.

Counterpart of the reference's matrix-provider abstraction
(``src/algorithm/two_phase/matrix_provider/``, SURVEY §2.5): the simplex
engine never needs the constraint matrix as a whole — it needs columns,
costs and the rhs.  On the device the oracle is a **column pool**: a dense
``(m, n_pool)`` array resident in device memory plus an activity mask; "lazy columns"
are masked pricing over the pool, and true on-demand generation appends
blocks between device solves (``relp_tpu.providers.column_generation``).
"""

from relp_tpu.providers.base import ColumnPool, MatrixProvider
from relp_tpu.providers.filters import remove_rows
from relp_tpu.providers.column_generation import ColumnGenerationResult, solve_with_column_generation

__all__ = [
    "ColumnGenerationResult",
    "ColumnPool",
    "MatrixProvider",
    "remove_rows",
    "solve_with_column_generation",
]
