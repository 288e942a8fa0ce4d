"""Tiled-brick sparse device matrix — an SpMV layout without element
gathers (``config.pdlp_matrix="bricks"``; the default is ELL).

The reference's CSC/CSR sparse vectors (src/data/linear_algebra/
matrix.rs:23-77) assume cheap random access.  This layout was built for an
accelerator whose element gathers were serial: it re-shapes the nonzeros
so every memory access is a 128-lane row gather or a streaming read
(``PERF.md`` compares it with ELL on the H100):

- nonzeros are grouped into (tr × tc) = (8 × 128) dense **bricks** on the
  (row-tile, column-block) grid;
- per row-tile, the touched column blocks' bricks sit in a padded slot
  array ``data[T, B, tr, tc]`` with block ids ``idx[T, B]`` (empty slots
  are zero bricks pointing at block 0 — harmless);
- ``A·x`` gathers x as 128-lane blocks (``take(x.reshape(-1, tc), idx,
  axis=0)``) and contracts with the bricks in exact f64:
  ``y[t, r] = Σ_{b,l} data[t,b,r,l]·x_blk[t,b,l]``;
- ``πᵀA`` uses an independently-built transposed brick set (column tiles
  of 8, row blocks of 128), same contraction shape.

Values are an exact f64 re-layout — no precision compromise anywhere.
Storage is O(bricks·1024·8B); scattered matrices (DFL001) shrink ~3× under
a bipartite reverse-Cuthill-McKee permutation (:func:`bandwidth_perm`),
which callers apply to the problem before building.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from relp_tpu.ops.amatrix import _pin

TR = 8      # rows per tile
TC = 128    # columns per block


def _slot_layout(r, c, v, n_rows_pad: int, n_cols_pad: int, b_pad=None):
    """Pack COO triplets into (data[T, B, TR, TC], idx[T, B]) numpy arrays."""
    T = n_rows_pad // TR
    NB = n_cols_pad // TC
    t = (r // TR).astype(np.int64)
    blk = (c // TC).astype(np.int64)
    key = t * NB + blk
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq, inv_s = np.unique(key_s, return_inverse=True)
    tile_of = (uniq // NB).astype(np.int64)
    starts = np.searchsorted(tile_of, np.arange(T))
    slot_of_uniq = np.arange(len(uniq)) - starts[tile_of]
    b_true = int(slot_of_uniq.max()) + 1 if len(uniq) else 1
    B = max(b_true, 1) if b_pad is None else b_pad
    assert b_true <= B, f"tile with {b_true} bricks exceeds B={B}"
    data = np.zeros((T, B, TR, TC), dtype=np.float64)
    idx = np.zeros((T, B), dtype=np.int32)
    idx[tile_of, slot_of_uniq] = (uniq % NB).astype(np.int32)
    slot = slot_of_uniq[inv_s]
    ro, co, vo = r[order], c[order], v[order]
    data[ro // TR, slot, ro % TR, co % TC] = vo
    return data, idx


@jax.tree_util.register_pytree_node_class
class BrickMatrix:
    """Brick-tiled A for streaming SpMV (see module docstring).

    ``rdata[T, Br, 8, 128]``/``ridx[T, Br]``: row-tile bricks for A·x.
    ``cdata[Tc, Bc, 8, 128]``/``cidx[Tc, Bc]``: column-tile bricks (the
    8 axis is columns, the 128 axis row-lanes) for πᵀA.
    ``m``/``n`` are the padded logical dims (static aux)."""

    def __init__(self, rdata, ridx, cdata, cidx, m: int, n: int):
        self.rdata = rdata
        self.ridx = ridx
        self.cdata = cdata
        self.cidx = cidx
        self.m = m
        self.n = n

    def tree_flatten(self):
        return (self.rdata, self.ridx, self.cdata, self.cidx), (self.m, self.n)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, aux[0], aux[1])

    @property
    def shape(self):
        return (self.m, self.n)

    @property
    def dtype(self):
        return self.rdata.dtype

    def matvec(self, x):
        """A @ x: row gather of x column-blocks + exact f64 VPU contraction."""
        tab = _pin(x).reshape(self.n // TC, TC)
        g = jnp.take(tab, self.ridx, axis=0)            # [T, Br, TC]
        y = jnp.sum(self.rdata * g[:, :, None, :], axis=(1, 3))
        return y.reshape(self.m)

    def rmatvec(self, pi):
        """πᵀ A via the transposed brick set."""
        tab = _pin(pi).reshape(self.m // TC, TC)
        g = jnp.take(tab, self.cidx, axis=0)            # [Tc, Bc, TC]
        z = jnp.sum(self.cdata * g[:, :, None, :], axis=(1, 3))
        return z.reshape(self.n)


def _group_breaks(counts: np.ndarray, max_groups: int):
    """Optimal partition of DESC-sorted per-tile brick counts into at most
    ``max_groups`` contiguous groups minimizing total padded slots
    Σ len_g·max_g.  DP over the distinct count values (few), exact."""
    uniq = np.unique(counts)[::-1]          # distinct values, descending
    ends = np.searchsorted(-counts, -uniq, side="right")  # prefix lengths
    k = len(uniq)
    INFC = float("inf")
    # dp[g][i]: min slots covering the first ends[i] tiles with g+1 groups
    dp = [[INFC] * k for _ in range(max_groups)]
    arg = [[0] * k for _ in range(max_groups)]
    for i in range(k):
        dp[0][i] = int(ends[i]) * int(uniq[0])
    for g in range(1, max_groups):
        for i in range(k):
            dp[g][i] = dp[g - 1][i]
            arg[g][i] = -1  # "fewer groups suffice"
            for j in range(i):
                cand = dp[g - 1][j] + (int(ends[i]) - int(ends[j])) * int(uniq[j + 1])
                if cand < dp[g][i]:
                    dp[g][i] = cand
                    arg[g][i] = j
    # walk back the boundaries for the full range (i = k-1)
    bounds = []
    g, i = max_groups - 1, k - 1
    while True:
        if g == 0:
            bounds.append((0, int(ends[i])))
            break
        j = arg[g][i]
        if j == -1:  # dp[g][i] == dp[g-1][i]: fewer groups suffice
            g -= 1
            continue
        bounds.append((int(ends[j]), int(ends[i])))
        i = j
        g -= 1
    bounds.reverse()
    return bounds  # [(start_tile, end_tile)] over the sorted tile order


@jax.tree_util.register_pytree_node_class
class GroupedBrickMatrix:
    """Brick operator with per-tile slot padding removed (tight packing).

    The flat [T, B] slot array of :class:`BrickMatrix` pads every row-tile
    to the heaviest tile's brick count — 2.75× wasted HBM traffic on
    DFL001.  Here tiles are SORTED by brick count and partitioned into a
    few contiguous groups, each with its own tight ``data[Tg, Bg, 8, 128]``
    (DP-optimal boundaries, ``_group_breaks``); the per-group outputs are
    concatenated and un-sorted with one [T, 8]-row gather.  Same operator
    interface and exact-f64 semantics as BrickMatrix.
    """

    def __init__(self, rgroups, rinv, cgroups, cinv, m: int, n: int):
        self.rgroups = tuple(rgroups)  # ((data, idx), ...) row-tile groups
        self.rinv = rinv               # i32[T] un-sort gather for A·x
        self.cgroups = tuple(cgroups)
        self.cinv = cinv
        self.m = m
        self.n = n

    def tree_flatten(self):
        return (self.rgroups, self.rinv, self.cgroups, self.cinv), (self.m, self.n)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, aux[0], aux[1])

    @property
    def shape(self):
        return (self.m, self.n)

    @property
    def dtype(self):
        return self.rgroups[0][0].dtype

    @staticmethod
    def _contract(groups, inv, tab):
        outs = []
        for data, idx in groups:
            g = jnp.take(tab, idx, axis=0)            # [Tg, Bg, TC]
            outs.append(jnp.sum(data * g[:, :, None, :], axis=(1, 3)))
        y = jnp.concatenate(outs, axis=0)             # [T, TR] sorted order
        return jnp.take(y, inv, axis=0)               # un-sort tiles

    def matvec(self, x):
        tab = _pin(x).reshape(self.n // TC, TC)
        return self._contract(self.rgroups, self.rinv, tab).reshape(self.m)

    def rmatvec(self, pi):
        tab = _pin(pi).reshape(self.m // TC, TC)
        return self._contract(self.cgroups, self.cinv, tab).reshape(self.n)


def _grouped_layout(r, c, v, n_rows_pad: int, n_cols_pad: int, max_groups: int):
    """Sorted-tile grouped slot layout; returns (groups, inv_perm)."""
    T = n_rows_pad // TR
    NB = n_cols_pad // TC
    key = (r // TR).astype(np.int64) * NB + (c // TC)
    uniq = np.unique(key)
    per_tile = np.bincount((uniq // NB).astype(np.int64), minlength=T)
    order = np.argsort(-per_tile, kind="stable")      # heavy tiles first
    inv = np.argsort(order).astype(np.int32)
    counts_sorted = per_tile[order]
    groups = []
    for s, e in _group_breaks(counts_sorted, max_groups):
        if e <= s:
            continue
        tiles = order[s:e]                            # original tile ids
        Bg = max(int(counts_sorted[s]), 1)
        sel = np.isin(r // TR, tiles)
        rg, cg, vg = r[sel], c[sel], v[sel]
        # relabel rows into the group's local tile space
        local = np.full(T, -1, np.int64)
        local[tiles] = np.arange(len(tiles))
        rl = local[rg // TR] * TR + (rg % TR)
        data, idx = _slot_layout(rl, cg, vg, len(tiles) * TR, n_cols_pad, Bg)
        groups.append((data, idx))
    return groups, inv


def grouped_bricks_from_csc(
    csc, m_pad: int, n_pad: int, max_groups: int = 4
) -> GroupedBrickMatrix:
    """Build the tight-packed grouped brick operator (both orientations)."""
    assert m_pad % TC == 0 and n_pad % TC == 0, (m_pad, n_pad)
    coo = csc.tocoo()
    coo.sum_duplicates()
    r = coo.row.astype(np.int64)
    c = coo.col.astype(np.int64)
    v = coo.data.astype(np.float64)
    rgroups, rinv = _grouped_layout(r, c, v, m_pad, n_pad, max_groups)
    cgroups, cinv = _grouped_layout(c, r, v, n_pad, m_pad, max_groups)
    return GroupedBrickMatrix(rgroups, rinv, cgroups, cinv, m_pad, n_pad)


def bricks_from_csc(
    csc, m_pad: int, n_pad: int, br_pad=None, bc_pad=None, bucket=None
) -> BrickMatrix:
    """Build both brick orientations from a scipy CSC matrix.

    ``m_pad``/``n_pad`` must be multiples of 128 (the driver's shape
    buckets above 256 all are).  ``br_pad``/``bc_pad`` optionally pad the
    per-tile brick-slot counts; ``bucket`` (a callable on the true max
    count) derives them instead — bucket like the other padded dims so
    problems share compiled programs."""
    assert m_pad % TC == 0 and n_pad % TC == 0, (m_pad, n_pad)
    coo = csc.tocoo()
    coo.sum_duplicates()
    r = coo.row.astype(np.int64)
    c = coo.col.astype(np.int64)
    v = coo.data.astype(np.float64)
    if bucket is not None:
        br_pad = bucket(_slot_count(r, c, m_pad, n_pad))
        bc_pad = bucket(_slot_count(c, r, n_pad, m_pad))
    rdata, ridx = _slot_layout(r, c, v, m_pad, n_pad, br_pad)
    cdata, cidx = _slot_layout(c, r, v, n_pad, m_pad, bc_pad)
    return BrickMatrix(rdata, ridx, cdata, cidx, m_pad, n_pad)


def _slot_count(r, c, n_rows_pad: int, n_cols_pad: int) -> int:
    """Max bricks in any row-tile (the true B before padding)."""
    if len(r) == 0:
        return 1
    NB = n_cols_pad // TC
    key = (r // TR).astype(np.int64) * NB + (c // TC)
    uniq = np.unique(key)
    per_tile = np.bincount(uniq // NB, minlength=n_rows_pad // TR)
    return int(per_tile.max())


def bandwidth_perm(csc):
    """Bipartite reverse-Cuthill-McKee row/column orders for A.

    Returns ``(row_perm, col_perm)`` such that ``A[row_perm][:, col_perm]``
    clusters nonzeros near the diagonal — on DFL001 this shrinks the brick
    count 2.9× (25522 → 8929) and the max bricks-per-tile 78 → 28.  Cheap:
    one BFS over the bipartite adjacency (O(nnz))."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    m, n = csc.shape
    B = sp.bmat([[None, csc], [csc.T, None]], format="csr")
    perm = np.asarray(reverse_cuthill_mckee(B, symmetric_mode=True))
    row_perm = perm[perm < m]
    col_perm = perm[perm >= m] - m
    # isolated rows/columns (empty in A) may be missing from the BFS order
    if row_perm.size < m:
        seen = np.zeros(m, bool)
        seen[row_perm] = True
        row_perm = np.concatenate([row_perm, np.flatnonzero(~seen)])
    if col_perm.size < n:
        seen = np.zeros(n, bool)
        seen[col_perm] = True
        col_perm = np.concatenate([col_perm, np.flatnonzero(~seen)])
    return row_perm.astype(np.int64), col_perm.astype(np.int64)
