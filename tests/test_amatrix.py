"""Device matrix representations (ops/amatrix.py): ELL vs dense equivalence.

The reference's linear-algebra layer is sparse end-to-end
(src/data/linear_algebra/matrix.rs:23-77, vector/sparse.rs:27-33); this
framework offers dense and column-major-ELL device layouts behind one
operator interface.  These tests pin every operator to the dense ground
truth and run the full engine on the ELL path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

import relp_tpu  # noqa: F401
from relp_tpu.api import solve
from relp_tpu.model.elements import LinearProgramType
from relp_tpu.ops.amatrix import DenseMatrix, EllMatrix, as_amatrix, ell_from_csc
from relp_tpu.utils.config import SolverConfig
from tests.conftest import reference_problem


def _random_sparse(m, n, density, seed):
    rng = np.random.default_rng(seed)
    M = sp.random(m, n, density=density, random_state=rng, format="csc")
    M.data = rng.standard_normal(M.nnz)
    return M


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shape,density", [((13, 29), 0.2), ((32, 17), 0.05)])
def test_ell_ops_match_dense(shape, density, seed):
    m, n = shape
    csc = _random_sparse(m, n, density, seed)
    m_pad, n_pad = m + 3, n + 5
    ell = ell_from_csc(csc, m_pad, n_pad).with_f32()
    Ad = np.zeros((m_pad, n_pad))
    Ad[:m, :n] = csc.toarray()
    dense = DenseMatrix(jnp.asarray(Ad)).with_f32()

    rng = np.random.default_rng(100 + seed)
    x = rng.standard_normal(n_pad)
    pi = rng.standard_normal(m_pad)
    Binv = rng.standard_normal((m_pad, m_pad))

    assert ell.shape == dense.shape == (m_pad, n_pad)
    np.testing.assert_allclose(ell.matvec(x), dense.matvec(x), atol=1e-12)
    np.testing.assert_allclose(ell.rmatvec(pi), dense.rmatvec(pi), atol=1e-12)
    np.testing.assert_allclose(
        ell.rmatvec32(pi.astype(np.float32)),
        dense.rmatvec32(pi.astype(np.float32)),
        rtol=2e-5,
        atol=2e-5,
    )
    for q in [0, 3, n - 1, n_pad - 1]:
        np.testing.assert_allclose(ell.col(q), dense.col(q), atol=1e-12)
        np.testing.assert_allclose(
            ell.ftran(Binv, q), dense.ftran(Binv, q), atol=1e-10
        )
        np.testing.assert_allclose(
            ell.col_dot(pi, q), dense.col_dot(pi, q), atol=1e-10
        )
    rows_i = np.arange(m_pad)
    cols_j = np.asarray((np.arange(m_pad) * 7) % n_pad)
    np.testing.assert_allclose(
        ell.entries(rows_i, cols_j), dense.entries(rows_i, cols_j), atol=1e-12
    )
    idx = jnp.asarray((np.arange(m_pad) * 3) % n_pad)
    np.testing.assert_allclose(
        ell.cols_matrix(idx), dense.cols_matrix(idx), atol=1e-12
    )


def test_ell_k_padding_and_bucketing():
    csc = _random_sparse(40, 20, 0.3, 7)
    k_true = int(np.diff(csc.indptr).max())
    ell = ell_from_csc(csc, 40, 24, k_pad=k_true + 5)
    assert ell.data.shape == (24, k_true + 5)
    # K below the true max must be rejected, not silently truncated
    with pytest.raises(AssertionError):
        ell_from_csc(csc, 40, 24, k_pad=max(k_true - 1, 1))


def test_as_amatrix_passthrough():
    a = jnp.zeros((3, 4))
    wrapped = as_amatrix(a)
    assert isinstance(wrapped, DenseMatrix)
    assert as_amatrix(wrapped) is wrapped
    ell = EllMatrix(jnp.zeros((4, 2)), jnp.zeros((4, 2), jnp.int32), 3)
    assert as_amatrix(ell) is ell


@pytest.mark.netlib
@pytest.mark.parametrize(
    "name,expected,tol",
    [
        ("AFIRO", -464.75314, 1e-3),
        ("SC105", -5.220206121e01, 1e-3),
        ("SHARE2B", -4.157322407e02, 1e-3),
        ("BOEING2", -3.1501872801520287870462195913263e2, 1e-3),
    ],
)
def test_ell_end_to_end_netlib(name, expected, tol):
    """Whole engine on the ELL path must match the reference objectives
    (reference tests/netlib/test.rs) on instances the dense path covers."""
    cfg = SolverConfig(matrix_format="ell")
    res = solve(reference_problem("netlib", f"{name}.SIF"), config=cfg)
    assert res.kind is LinearProgramType.FINITE_OPTIMUM
    assert res.solution.objective_value == pytest.approx(expected, abs=tol)


def test_hybrid_ops_match_dense():
    """HybridMatrix (ELL + dense spill block) must agree with the dense
    ground truth on the whole operator interface, including columns that
    live in the spill block (FIT2P-class full columns)."""
    from relp_tpu.ops.amatrix import hybrid_from_csc

    m, n = 24, 15
    csc = _random_sparse(m, n, 0.15, 3).tolil()
    csc[:, 4] = np.arange(1.0, m + 1.0).reshape(-1, 1)  # full column
    csc[:, 11] = 2.0  # another dense column
    csc = csc.tocsc()
    m_pad, n_pad = m + 8, n + 9
    counts = np.diff(csc.indptr)
    k_pad = int(counts[[j for j in range(n) if j not in (4, 11)]].max())
    hyb = hybrid_from_csc(csc, m_pad, n_pad, k_pad=k_pad, d_pad=8).with_f32()
    Ad = np.zeros((m_pad, n_pad))
    Ad[:m, :n] = csc.toarray()
    dense = DenseMatrix(jnp.asarray(Ad)).with_f32()

    rng = np.random.default_rng(7)
    x = rng.standard_normal(n_pad)
    pi = rng.standard_normal(m_pad)
    Binv = rng.standard_normal((m_pad, m_pad))

    assert hyb.shape == dense.shape == (m_pad, n_pad)
    np.testing.assert_allclose(hyb.matvec(x), dense.matvec(x), atol=1e-12)
    np.testing.assert_allclose(hyb.rmatvec(pi), dense.rmatvec(pi), atol=1e-12)
    np.testing.assert_allclose(
        hyb.rmatvec32(pi.astype(np.float32)),
        dense.rmatvec32(pi.astype(np.float32)),
        rtol=2e-5, atol=2e-5,
    )
    for bstart, bsize in [(0, 8), (4, 8), (8, n_pad - 8)]:
        np.testing.assert_allclose(
            hyb.rmatvec32_block(pi.astype(np.float32), bstart, bsize),
            dense.rmatvec32_block(pi.astype(np.float32), bstart, bsize),
            rtol=2e-5, atol=2e-5,
        )
    for q in [0, 4, 11, n - 1, n_pad - 1]:
        np.testing.assert_allclose(hyb.col(q), dense.col(q), atol=1e-12)
        np.testing.assert_allclose(
            hyb.ftran(Binv, q), dense.ftran(Binv, q), atol=1e-10
        )
        np.testing.assert_allclose(
            float(hyb.col_dot(pi, q)), float(dense.col_dot(pi, q)), atol=1e-10
        )
    rows_i = np.array([0, 5, m - 1, 2], np.int32)
    cols_j = np.array([4, 11, 0, n - 1], np.int32)
    np.testing.assert_allclose(
        hyb.entries(rows_i, cols_j), dense.entries(rows_i, cols_j), atol=1e-12
    )
    idx = np.array([4, 0, 11, n_pad - 1], np.int32)
    np.testing.assert_allclose(
        hyb.cols_matrix(idx), dense.cols_matrix(idx), atol=1e-12
    )


def test_hybrid_spill_overflow_rejected():
    from relp_tpu.ops.amatrix import hybrid_from_csc

    csc = sp.csc_matrix(np.ones((6, 4)))
    with pytest.raises(AssertionError):
        hybrid_from_csc(csc, 8, 8, k_pad=2, d_pad=2)


@pytest.mark.netlib
def test_hybrid_end_to_end_netlib():
    """Whole engine on the hybrid path: FIT1P has the same full-column
    structure as FIT2P (reference tests/netlib/test.rs fit1p)."""
    cfg = SolverConfig(matrix_format="hybrid")
    res = solve(reference_problem("netlib", "FIT1P.SIF"), config=cfg)
    assert res.kind is LinearProgramType.FINITE_OPTIMUM
    assert res.solution.objective_value == pytest.approx(9.1463780924e3, abs=1e-2)
    assert res.simplex.metrics.matrix_format == "hybrid"
