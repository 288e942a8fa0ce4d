"""Row-filtering provider wrapper.

Counterpart of reference ``matrix_provider/filter/generic_wrapper.rs``
(``RemoveRows``: present a provider minus a sorted set of rows, remapping
indices).  Used for rank-deficiency handling: the reference rebuilds the
tableau over the filtered provider (non_artificial.rs:191), the device engine
instead keeps redundant rows masked with their artificial basic at level 0;
this host-side filter exists for composing problems and for tests.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from relp_tpu.providers.base import ColumnPool


def remove_rows(pool: ColumnPool, rows: Sequence[int]) -> ColumnPool:
    keep = np.ones(pool.nr_rows, dtype=bool)
    keep[np.asarray(list(rows), dtype=int)] = False
    return ColumnPool(
        A=pool.A[keep, :],
        b=pool.b[keep],
        c=pool.c,
        lb=pool.lb,
        ub=pool.ub,
        names=pool.names,
        active=pool.active,
    )
