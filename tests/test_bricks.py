"""BrickMatrix (ops/bricks.py): the tiled-brick SpMV layout.

Reference frame: rust-lp's sparse L1 (src/data/linear_algebra/matrix.rs)
assumes cheap random access; bricks trade element gathers for dense
(8, 128) tiles gathered as rows (module docstring).
"""
import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

from relp_tpu.ops.bricks import BrickMatrix, bandwidth_perm, bricks_from_csc


@pytest.mark.parametrize(
    "m,n,mp,np_",
    [(5, 7, 128, 128), (200, 300, 256, 384), (129, 500, 256, 512)],
)
def test_brick_matvec_rmatvec_match_dense(m, n, mp, np_):
    rng = np.random.default_rng(42)
    A = sp.random(m, n, density=0.05, random_state=rng, format="csc")
    full = np.zeros((mp, np_))
    full[:m, :n] = A.toarray()
    B = bricks_from_csc(sp.csc_matrix(full), mp, np_)
    x = rng.uniform(size=np_)
    pi = rng.uniform(size=mp)
    np.testing.assert_allclose(
        np.asarray(B.matvec(jnp.asarray(x))), full @ x, atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(B.rmatvec(jnp.asarray(pi))), pi @ full, atol=1e-12
    )


def test_brick_values_exact_f64():
    # the layout is a pure re-layout: awkward f64 values survive exactly
    vals = np.array([1e-300, 1.0 + 2**-52, -1e300, 3.141592653589793])
    A = sp.csc_matrix(
        (vals, ([0, 3, 130, 7], [0, 129, 2, 255])), shape=(256, 256)
    )
    B = bricks_from_csc(A, 256, 256)
    x = np.zeros(256)
    for v, i, j in zip(vals, [0, 3, 130, 7], [0, 129, 2, 255]):
        x[:] = 0.0
        x[j] = 1.0
        col = np.asarray(B.matvec(jnp.asarray(x)))
        assert col[i] == v  # bitwise-exact


def test_bucketed_slot_pad():
    rng = np.random.default_rng(0)
    A = sp.random(100, 200, density=0.1, random_state=rng, format="csc")
    full = np.zeros((128, 256))
    full[:100, :200] = A.toarray()
    B = bricks_from_csc(
        sp.csc_matrix(full), 128, 256, bucket=lambda b: ((b + 7) // 8) * 8
    )
    assert B.rdata.shape[1] % 8 == 0 and B.cdata.shape[1] % 8 == 0
    x = rng.uniform(size=256)
    np.testing.assert_allclose(
        np.asarray(B.matvec(jnp.asarray(x))), full @ x, atol=1e-12
    )


def test_bandwidth_perm_is_permutation_and_shrinks_bricks():
    rng = np.random.default_rng(1)
    # block-diagonal structure hidden by a random shuffle: RCM should
    # recover locality
    blocks = [sp.random(64, 64, density=0.2, random_state=rng) for _ in range(4)]
    A = sp.block_diag(blocks).tocsc()
    m, n = A.shape
    shuf_r = rng.permutation(m)
    shuf_c = rng.permutation(n)
    A_shuf = A[shuf_r][:, shuf_c].tocsc()
    rp, cp = bandwidth_perm(A_shuf)
    assert sorted(rp) == list(range(m)) and sorted(cp) == list(range(n))

    def brick_count(M):
        C = M.tocoo()
        return len(set(zip(C.row // 8, C.col // 128)))

    A_rcm = A_shuf[rp][:, cp]
    assert brick_count(A_rcm) < brick_count(A_shuf)


def test_pdlp_bricks_end_to_end():
    from relp_tpu.api import solve
    from relp_tpu.utils.config import SolverConfig

    cfg = SolverConfig(
        algorithm="pdlp", pdlp_matrix="bricks", pdlp_crossover=False
    )
    r = solve(
        "/root/reference/tests/netlib/problem_files/AFIRO.SIF", cfg
    )
    assert r.solution is not None
    assert r.solution.objective_value == pytest.approx(-464.753142, rel=1e-6)


def test_grouped_bricks_match_flat_and_scipy():
    """GroupedBrickMatrix (tight packing): same operator semantics as the
    flat layout, strictly fewer padded slots on skewed tile fills."""
    from relp_tpu.ops.bricks import grouped_bricks_from_csc

    rng = np.random.default_rng(7)
    m, n = 512, 768
    A = sp.random(m, n, density=0.01, random_state=3, format="lil")
    A[:8, :] = sp.random(8, n, density=0.4, random_state=4).toarray()
    A = sp.csc_matrix(A)
    flat = bricks_from_csc(A, m, n)
    grp = grouped_bricks_from_csc(A, m, n)
    x = rng.standard_normal(n)
    y = rng.standard_normal(m)
    np.testing.assert_allclose(
        np.asarray(grp.matvec(jnp.asarray(x))), A @ x, atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(grp.rmatvec(jnp.asarray(y))), A.T @ y, atol=1e-12
    )
    flat_slots = flat.rdata.size
    grp_slots = sum(d.size for d, _ in grp.rgroups)
    assert grp_slots <= flat_slots


def test_grouped_bricks_empty_and_uniform():
    """Degenerate groupings: empty matrix and perfectly uniform fill."""
    from relp_tpu.ops.bricks import grouped_bricks_from_csc

    Z = sp.csc_matrix((256, 256))
    G = grouped_bricks_from_csc(Z, 256, 256)
    assert np.all(np.asarray(G.matvec(jnp.ones(256))) == 0.0)
    E = sp.identity(256, format="csc")
    G2 = grouped_bricks_from_csc(E, 256, 256)
    v = np.arange(256.0)
    np.testing.assert_array_equal(np.asarray(G2.matvec(jnp.asarray(v))), v)
    np.testing.assert_array_equal(np.asarray(G2.rmatvec(jnp.asarray(v))), v)
