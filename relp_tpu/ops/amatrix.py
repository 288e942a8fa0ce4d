"""Device representations of the constraint matrix A.

The reference's entire linear-algebra layer is sparse
(``src/data/linear_algebra/matrix.rs:23-77``, ``vector/sparse.rs:27-33``);
round 1 of this framework used a fully dense padded device matrix, which
caps the scale at a few thousand rows (O(m·n) HBM and pricing FLOPs per
iteration).  This module is the SURVEY §2.2/§7 plan — "dense-blocked
CSR/ELL/padded-COO device arrays … for SpMV/FTRAN/BTRAN" — realized as two
interchangeable pytree classes the jitted engine consumes through one small
operator interface:

- :class:`DenseMatrix` — the round-1 layout: A (f64) plus an optional f32
  copy for pricing.  Best for small/dense pools where fused matvecs
  beat gather arithmetic.
- :class:`EllMatrix` — column-major ELL: per column up to K nonzeros,
  padded with (row 0, value 0).  ``data[n, K]`` (f64), ``rows[n, K]``
  (i32).  Every engine access pattern becomes O(nnz)-ish gather/scatter
  arithmetic instead of O(m·n) dense work:

    pricing   πᵀA        → sum_k π[rows[:,k]]·data[:,k]      (n·K)
    FTRAN     B⁻¹a_q     → B⁻¹[:, rows[q]] @ data[q]          (m·K)
    devex row B⁻¹[r]·A   → sum_k B⁻¹[r][rows[:,k]]·data[:,k]  (n·K)
    SpMV      A@x        → scatter-add data·x into rows       (nnz)
    refactor  B gather   → scatter K nnz per basis column     (m·K)

  For Netlib-sparse problems (density ≪ 1%) these gathers beat dense
  matvecs by orders of magnitude and cut device memory from O(m·n) to
  O(nnz), which is what unlocks DFL001/STOCFOR3-class instances.

Both classes are registered as JAX pytrees so they pass straight through
``jax.jit``/``jax.vmap``; the engine dispatches on the Python type at trace
time (the analogue of the reference's compile-time
``MatrixProvider`` static dispatch).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


def _pin(x):
    """Materialize a gather/scatter operand before the gather consumes it.

    XLA may fuse a gather with its operand's producer and then recompute
    the producer chain PER GATHERED ELEMENT (on a PDHG step: the A·x gather
    fused with the freshly computed x, itself a K-wide gather per element).
    ``optimization_barrier`` is opaque to producer fusion; when the operand
    is already materialized (a loop carry) it costs nothing."""
    return lax.optimization_barrier(x)


@jax.tree_util.register_pytree_node_class
class DenseMatrix:
    """Dense padded A with an optional f32 shadow for pricing."""

    def __init__(self, A, A32=None):
        self.A = A
        self.A32 = A32

    def tree_flatten(self):
        return (self.A, self.A32), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def shape(self):
        return self.A.shape

    @property
    def dtype(self):
        return self.A.dtype

    def with_f32(self) -> "DenseMatrix":
        if self.A32 is not None:
            return self
        return DenseMatrix(self.A, self.A.astype(jnp.float32))

    # -- operator interface --------------------------------------------------

    def matvec(self, x):
        """A @ x.  Full input precision: at the default precision an f32
        product may run in TF32 (a 10-bit mantissa) on a GPU — PDHG
        iterations and pricing confirmations need the genuine dtype (the
        shared-A fleet's f32 GEMM iteration stalls at KKT ~1e-1 with
        truncated inputs).  f64 products are unaffected."""
        return jnp.matmul(self.A, x, precision=jax.lax.Precision.HIGHEST)

    def rmatvec(self, pi):
        """πᵀ A (full input precision — see matvec)."""
        return jnp.matmul(pi, self.A, precision=jax.lax.Precision.HIGHEST)

    def rmatvec32(self, v32):
        """v32ᵀ A in f32 (pricing path); v32 must be f32.

        Default precision (TF32 allowed) is DELIBERATE here: the simplex
        pricing scan only proposes candidates — every entering choice is
        confirmed against the f64 reduced cost before pivoting
        (simplex/core.py).  The iteration-critical f32 matmuls
        (PDHG/fleet) go through matvec/rmatvec, which request HIGHEST."""
        return v32 @ self.A32

    def rmatvec32_block(self, v32, bstart, bsize: int):
        """v32ᵀ A[:, bstart:bstart+bsize] (partial pricing; bsize static)."""
        import jax.lax as lax

        blk = lax.dynamic_slice(self.A32, (0, bstart), (self.A32.shape[0], bsize))
        return v32 @ blk  # pricing proposal — f64-confirmed (rmatvec32)

    def col(self, q):
        """Dense column a_q."""
        return jnp.take(self.A, q, axis=1)

    def ftran(self, Binv, q):
        """B⁻¹ a_q."""
        return Binv @ self.col(q)

    def col_dot(self, pi, q):
        """πᵀ a_q (scalar, f64)."""
        return pi @ self.col(q)

    def entries(self, rows_i, cols_j):
        """Elementwise A[rows_i[k], cols_j[k]]."""
        return self.A[rows_i, cols_j]

    def cols_matrix(self, idx):
        """Gather the (m, len(idx)) matrix of columns ``idx``."""
        return jnp.take(self.A, idx, axis=1)


@jax.tree_util.register_pytree_node_class
class EllMatrix:
    """Column-major ELL: ``data[n, K]`` f64 values, ``rows[n, K]`` i32 row
    indices; padding slots carry (row 0, value 0) so every op treats them
    as harmless zero contributions.  ``m`` is static aux data.

    ``rdata``/``rcols`` optionally hold the SAME matrix in row-major ELL
    (per-row nonzeros, padded with (col 0, value 0)).  When present,
    :meth:`matvec` becomes a pure gather+sum like :meth:`rmatvec`, with
    no scatter-add contention on duplicate row indices."""

    def __init__(self, data, rows, m: int, data32=None,
                 rdata=None, rcols=None):
        self.data = data
        self.rows = rows
        self.m = m
        self.data32 = data32
        self.rdata = rdata
        self.rcols = rcols

    def tree_flatten(self):
        return (self.data, self.rows, self.data32, self.rdata,
                self.rcols), (self.m,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        data, rows, data32, rdata, rcols = children
        return cls(data, rows, aux[0], data32, rdata, rcols)

    @property
    def shape(self):
        return (self.m, self.data.shape[0])

    @property
    def dtype(self):
        return self.data.dtype

    def with_f32(self) -> "EllMatrix":
        if self.data32 is not None:
            return self
        return EllMatrix(
            self.data, self.rows, self.m, self.data.astype(jnp.float32),
            self.rdata, self.rcols,
        )

    # -- operator interface --------------------------------------------------

    def matvec(self, x):
        x = _pin(x)
        if self.rdata is not None:
            return jnp.sum(self.rdata * jnp.take(x, self.rcols), axis=1)
        contrib = self.data * x[:, None]
        return jnp.zeros(self.m, self.dtype).at[self.rows].add(contrib)

    def rmatvec(self, pi):
        pi = _pin(pi)
        return jnp.sum(jnp.take(pi, self.rows) * self.data, axis=1)

    def rmatvec32(self, v32):
        v32 = _pin(v32)
        return jnp.sum(jnp.take(v32, self.rows) * self.data32, axis=1)

    def rmatvec32_block(self, v32, bstart, bsize: int):
        v32 = _pin(v32)
        K = self.rows.shape[1]
        rows_b = lax.dynamic_slice(self.rows, (bstart, 0), (bsize, K))
        data_b = lax.dynamic_slice(self.data32, (bstart, 0), (bsize, K))
        return jnp.sum(jnp.take(v32, rows_b) * data_b, axis=1)

    def col(self, q):
        rq = jnp.take(self.rows, q, axis=0)
        dq = jnp.take(self.data, q, axis=0)
        return jnp.zeros(self.m, self.dtype).at[rq].add(dq)

    def ftran(self, Binv, q):
        rq = jnp.take(self.rows, q, axis=0)
        dq = jnp.take(self.data, q, axis=0)
        return jnp.take(Binv, rq, axis=1) @ dq

    def col_dot(self, pi, q):
        rq = jnp.take(self.rows, q, axis=0)
        dq = jnp.take(self.data, q, axis=0)
        return jnp.take(pi, rq) @ dq

    def entries(self, rows_i, cols_j):
        rj = jnp.take(self.rows, cols_j, axis=0)  # (k, K)
        dj = jnp.take(self.data, cols_j, axis=0)
        return jnp.sum(jnp.where(rj == rows_i[:, None], dj, 0.0), axis=1)

    def cols_matrix(self, idx):
        m = self.m
        rows_b = jnp.take(self.rows, idx, axis=0)  # (k, K)
        data_b = jnp.take(self.data, idx, axis=0)
        cols_b = jnp.broadcast_to(
            jnp.arange(idx.shape[0])[:, None], rows_b.shape
        )
        return (
            jnp.zeros((m, idx.shape[0]), self.dtype)
            .at[rows_b, cols_b]
            .add(data_b)
        )


@jax.tree_util.register_pytree_node_class
class HybridMatrix:
    """ELL for the sparse columns + a small dense block for "spill" columns
    whose fill would blow up the ELL pad (e.g. FIT2P's three full columns,
    kmax = m: pure ELL would pad EVERY column to K ≈ m).

    ``ell`` holds all non-spill columns (spill columns are all-zero there);
    ``D`` is the (m_pad, d_pad) dense block of spill columns in slot order;
    ``spill_idx[d_pad]`` maps slot → column index (padded slots have a zero
    dense column, so their scatter contributions are 0 regardless of the
    padded index value); ``spill_pos[n_pad]`` maps column → slot or -1.

    Cost model: every op is the ELL cost plus an O(m·d) dense term (d ≪ n),
    except :meth:`ftran`, which adds one O(m²) maintained-inverse matvec —
    the same order as the engine's per-pivot rank-1 update, so the constant
    factor is bounded.  Reference frame: rust-lp stores such columns as
    plain sparse vectors and pays O(nnz) on the CPU
    (src/data/linear_algebra/matrix.rs:23-77); here the dense block keeps
    the gather shapes static.
    """

    def __init__(self, ell: EllMatrix, D, spill_idx, spill_pos, D32=None):
        self.ell = ell
        self.D = D
        self.spill_idx = spill_idx
        self.spill_pos = spill_pos
        self.D32 = D32

    def tree_flatten(self):
        return (self.ell, self.D, self.spill_idx, self.spill_pos, self.D32), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def shape(self):
        return self.ell.shape

    @property
    def dtype(self):
        return self.ell.dtype

    def with_f32(self) -> "HybridMatrix":
        if self.D32 is not None and self.ell.data32 is not None:
            return self
        return HybridMatrix(
            self.ell.with_f32(), self.D, self.spill_idx, self.spill_pos,
            self.D.astype(jnp.float32),
        )

    def _spill_col(self, q):
        """Dense part of column q (zeros when q is not a spill column)."""
        pos = jnp.take(self.spill_pos, q)
        col = jnp.take(self.D, jnp.maximum(pos, 0), axis=1)
        return jnp.where(pos >= 0, col, 0.0)

    # -- operator interface --------------------------------------------------

    def matvec(self, x):
        return self.ell.matvec(x) + jnp.matmul(
            self.D, jnp.take(x, self.spill_idx),
            precision=jax.lax.Precision.HIGHEST,
        )

    def rmatvec(self, pi):
        r = self.ell.rmatvec(pi)
        return r.at[self.spill_idx].add(
            jnp.matmul(pi, self.D, precision=jax.lax.Precision.HIGHEST)
        )

    def rmatvec32(self, v32):
        r = self.ell.rmatvec32(v32)
        return r.at[self.spill_idx].add(v32 @ self.D32)

    def rmatvec32_block(self, v32, bstart, bsize: int):
        r = self.ell.rmatvec32_block(v32, bstart, bsize)
        vals = v32 @ self.D32
        p = self.spill_idx - bstart
        ok = (p >= 0) & (p < bsize)
        return r.at[jnp.clip(p, 0, bsize - 1)].add(jnp.where(ok, vals, 0.0))

    def col(self, q):
        return self.ell.col(q) + self._spill_col(q)

    def ftran(self, Binv, q):
        return self.ell.ftran(Binv, q) + Binv @ self._spill_col(q)

    def col_dot(self, pi, q):
        return self.ell.col_dot(pi, q) + pi @ self._spill_col(q)

    def entries(self, rows_i, cols_j):
        base = self.ell.entries(rows_i, cols_j)
        pos = jnp.take(self.spill_pos, cols_j)
        dvals = self.D[rows_i, jnp.maximum(pos, 0)]
        return base + jnp.where(pos >= 0, dvals, 0.0)

    def cols_matrix(self, idx):
        base = self.ell.cols_matrix(idx)
        pos = jnp.take(self.spill_pos, idx)
        dcols = jnp.take(self.D, jnp.maximum(pos, 0), axis=1)
        return base + jnp.where(pos >= 0, dcols, 0.0)


def as_amatrix(A):
    """Wrap a raw array as :class:`DenseMatrix`; pass operator classes
    (these, or ops/bricks.BrickMatrix) through by duck type."""
    if hasattr(A, "matvec"):
        return A
    return DenseMatrix(A)


def ell_from_csc(
    csc, m_pad: int, n_pad: int, k_pad: int | None = None,
    kr_pad: int | None = None, row_layout: bool = True,
) -> EllMatrix:
    """Build padded ELL host arrays from a scipy CSC matrix.

    ``k_pad`` caps/pads the per-column nonzero count (defaults to the true
    maximum); distinct (n_pad, K) shapes compile distinct programs, so
    callers should bucket ``k_pad`` like the other padded dims.  With
    ``row_layout`` (default) the row-major twin (``rdata``/``rcols``,
    per-row pad ``kr_pad``, bucketed to a multiple of 8 by default) is
    built too, so :meth:`EllMatrix.matvec` is a gather+sum instead of a
    scatter-add.
    """
    m, n = csc.shape
    assert m <= m_pad and n <= n_pad
    counts = np.diff(csc.indptr)
    k_true = int(counts.max()) if n else 1
    K = max(1, k_pad if k_pad is not None else k_true)
    assert k_true <= K, f"column with {k_true} nnz exceeds K={K}"
    data = np.zeros((n_pad, K), dtype=np.float64)
    rows = np.zeros((n_pad, K), dtype=np.int32)
    nnz = csc.indptr[-1]
    if nnz:
        col_of = np.repeat(np.arange(n), counts)
        pos = np.arange(nnz) - np.repeat(csc.indptr[:-1], counts)
        data[col_of, pos] = csc.data
        rows[col_of, pos] = csc.indices
    rdata = rcols = None
    if row_layout:
        csr = csc.tocsr()
        rcounts = np.diff(csr.indptr)
        kr_true = int(rcounts.max()) if m else 1
        Kr = max(8, kr_pad if kr_pad is not None else ((kr_true + 7) // 8) * 8)
        assert kr_true <= Kr, f"row with {kr_true} nnz exceeds Kr={Kr}"
        rdata = np.zeros((m_pad, Kr), dtype=np.float64)
        rcols = np.zeros((m_pad, Kr), dtype=np.int32)
        if nnz:
            row_of = np.repeat(np.arange(m), rcounts)
            rpos = np.arange(nnz) - np.repeat(csr.indptr[:-1], rcounts)
            rdata[row_of, rpos] = csr.data
            rcols[row_of, rpos] = csr.indices
    return EllMatrix(data, rows, m_pad, None, rdata, rcols)


def hybrid_from_csc(
    csc, m_pad: int, n_pad: int, k_pad: int, d_pad: int
) -> HybridMatrix:
    """Build a :class:`HybridMatrix`: columns with more than ``k_pad``
    nonzeros become dense spill columns (at most ``d_pad`` of them, padded
    with zero columns); the rest go to ELL with per-column pad ``k_pad``."""
    import scipy.sparse as sp

    m, n = csc.shape
    counts = np.diff(csc.indptr)
    spill = np.flatnonzero(counts > k_pad)
    assert spill.size <= d_pad, (
        f"{spill.size} spill columns exceed d_pad={d_pad}"
    )
    csc_sparse = csc.copy()
    if spill.size:
        # zero out the spill columns in the ELL part
        keep = np.ones(n, bool)
        keep[spill] = False
        mask = sp.diags(keep.astype(csc.dtype))
        csc_sparse = (csc @ mask).tocsc()
        csc_sparse.eliminate_zeros()
    ell = ell_from_csc(csc_sparse, m_pad, n_pad, k_pad)
    D = np.zeros((m_pad, d_pad), dtype=np.float64)
    for s, j in enumerate(spill):
        D[:m, s] = csc[:, [j]].toarray().ravel()
    spill_idx = np.zeros(d_pad, dtype=np.int32)
    spill_idx[: spill.size] = spill
    spill_pos = np.full(n_pad, -1, dtype=np.int32)
    spill_pos[spill] = np.arange(spill.size, dtype=np.int32)
    return HybridMatrix(ell, D, spill_idx, spill_pos)
