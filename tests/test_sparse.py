"""Sparse COO kernel differential tests vs the dense path."""

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp

import ccfindr_tpu as cf
from ccfindr_tpu.ops import sparse as sk
from ccfindr_tpu.ops import vb as vb_ops
from ccfindr_tpu.ops.vb import Hyper, VBState


def _sparse_problem(n=40, m=60, r=4, density=0.2, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.random((n, m)) < density) * rng.poisson(3.0, (n, m))
    x = x.astype(np.float64)
    x[x.sum(axis=1) == 0, 0] += 1
    x[0, x.sum(axis=0) == 0] += 1
    lw = rng.gamma(1.0, 1.0, size=(n, r))
    lh = rng.gamma(1.0, 1.0, size=(r, m))
    return x, lw, lh


def test_from_scipy_roundtrip():
    x, _, _ = _sparse_problem()
    sc = sk.from_scipy(sp.csr_matrix(x), dtype=jnp.float64, chunk=64)
    assert sc.row.shape[0] % 64 == 0
    dense = np.zeros((sc.n + 1, sc.m + 1))
    np.add.at(dense, (np.asarray(sc.row), np.asarray(sc.col)),
              np.asarray(sc.val))
    np.testing.assert_allclose(dense[:sc.n, :sc.m], x)


def test_suffstats_coo_matches_dense():
    x, lw, lh = _sparse_problem()
    sc = sk.from_dense(x, dtype=jnp.float64, chunk=128)
    sw_d, sh_d = vb_ops.suffstats_dense(jnp.asarray(x), jnp.asarray(lw),
                                        jnp.asarray(lh))
    sw_s, sh_s = sk.suffstats_coo(sc, jnp.asarray(lw), jnp.asarray(lh),
                                  chunk=128)
    np.testing.assert_allclose(np.asarray(sw_s), np.asarray(sw_d),
                               rtol=1e-10)
    np.testing.assert_allclose(np.asarray(sh_s), np.asarray(sh_d),
                               rtol=1e-10)


def test_elbo_data_coo_matches_dense():
    x, lw, lh = _sparse_problem(seed=1)
    sc = sk.from_dense(x, dtype=jnp.float64, chunk=128)
    ref = vb_ops.elbo_data_term(jnp.asarray(x), jnp.asarray(lw),
                                jnp.asarray(lh))
    out = sk.elbo_data_coo(sc, jnp.asarray(lw), jnp.asarray(lh),
                           chunk=128)
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-10)


def test_lgamma_term_matches_dense():
    x, _, _ = _sparse_problem(seed=2)
    sc = sk.from_dense(x, dtype=jnp.float64)
    ref = float(jnp.sum(jax.scipy.special.gammaln(jnp.asarray(x) + 1.0)))
    np.testing.assert_allclose(float(sk.lgamma_term(sc)), ref,
                               rtol=1e-12)


def test_vb_run_sparse_backend_matches_dense():
    x, lw, lh = _sparse_problem(n=30, m=45, r=3, seed=3)
    st = VBState(ew=jnp.asarray(lw), eh=jnp.asarray(lh),
                 lw=jnp.asarray(lw), lh=jnp.asarray(lh),
                 dw=jnp.zeros((30, 3)), dh=jnp.zeros((3, 45)),
                 lkh=jnp.asarray(-np.inf))
    hyper = Hyper(*(jnp.asarray(v) for v in (1.0, 1.0, 1.0, 1.0)))

    dense = vb_ops.vb_run(jnp.asarray(x), st, hyper, itmax=50,
                          hyper_mask=(True,) * 4)
    sc = sk.from_dense(x, dtype=jnp.float64, chunk=256)
    ss, dt = sk.make_sparse_backend(chunk=256)
    sparse = vb_ops.vb_run(sc, st, hyper, itmax=50,
                           hyper_mask=(True,) * 4,
                           suffstats=ss, data_term=dt)
    assert int(dense.n_iter) == int(sparse.n_iter)
    np.testing.assert_allclose(float(sparse.lml), float(dense.lml),
                               rtol=1e-9)
    np.testing.assert_allclose(np.asarray(sparse.state.ew),
                               np.asarray(dense.state.ew), rtol=1e-7)


def test_vb_factorize_sparse_backend():
    sim = cf.simulate_whx(nrow=25, ncol=40, rank=3, seed=5)
    s = cf.SCSet(count=sim["x"])
    a = cf.vb_factorize(s, ranks=3, nrun=2, verbose=0, Itmax=300,
                        seed=11)
    b = cf.vb_factorize(s, ranks=3, nrun=2, verbose=0, Itmax=300,
                        seed=11, backend="sparse")
    np.testing.assert_allclose(a.measure["lml"], b.measure["lml"],
                               rtol=1e-8)


def test_vb_factorize_pallas_backend(pallas_interpret):
    sim = cf.simulate_whx(nrow=25, ncol=40, rank=3, seed=6)
    s = cf.SCSet(count=sim["x"])
    a = cf.vb_factorize(s, ranks=3, nrun=2, verbose=0, Itmax=300,
                        seed=12)
    b = cf.vb_factorize(s, ranks=3, nrun=2, verbose=0, Itmax=300,
                        seed=12, backend="pallas")
    np.testing.assert_allclose(a.measure["lml"], b.measure["lml"],
                               rtol=1e-8)


def test_fused_coo_matches_twopass():
    import jax.numpy as jnp
    from ccfindr_tpu.ops import sparse as sk
    from ccfindr_tpu.ops import vb as vb_ops

    n, m, r = 30, 44, 4
    rng = np.random.default_rng(9)
    x = rng.poisson(0.6, (n, m)).astype(np.float64)
    lw = jnp.asarray(rng.gamma(1.0, 1.0, (n, r)))
    lh = jnp.asarray(rng.gamma(1.0, 1.0, (r, m)))
    sc = sk.from_dense(x, dtype=jnp.float64, chunk=64)
    swn, shn, dt = sk.fused_coo(sc, lw, lh, chunk=64)
    sw2, sh2 = sk.suffstats_coo(sc, lw, lh, chunk=64)
    d2 = sk.elbo_data_coo(sc, lw, lh, chunk=64)
    np.testing.assert_allclose(np.asarray(lw * swn), np.asarray(sw2),
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray(lh * shn), np.asarray(sh2),
                               rtol=1e-12)
    np.testing.assert_allclose(float(dt), float(d2), rtol=1e-12)
    # and against the dense fused backend
    swn_d, shn_d, dt_d = vb_ops.fused_dense(jnp.asarray(x), lw, lh)
    np.testing.assert_allclose(np.asarray(swn), np.asarray(swn_d),
                               rtol=1e-9)
    np.testing.assert_allclose(np.asarray(shn), np.asarray(shn_d),
                               rtol=1e-9)
    np.testing.assert_allclose(float(dt), float(dt_d), rtol=1e-9)


def test_vb_factorize_sparse_never_densifies(monkeypatch):
    """backend='sparse' must not materialize a dense X anywhere in the
    driver (a 20k x 1M atlas must not allocate 80 GB on the host
    before the sparse path starts)."""
    sim = cf.simulate_whx(nrow=25, ncol=40, rank=3, seed=21)
    s = cf.SCSet(count=sp.csr_matrix(sim["x"]))

    def boom(*a, **k):
        raise AssertionError("dense materialization in sparse path")

    monkeypatch.setattr(cf.SCSet, "counts_dense", boom)
    monkeypatch.setattr(sp.csr_matrix, "toarray", boom)
    monkeypatch.setattr(sp.csr_matrix, "todense", boom)
    out = cf.vb_factorize(s, ranks=[2, 3], nrun=2, verbose=0,
                          Itmax=300, seed=3, backend="sparse")
    assert out.ranks == [2, 3]
    assert np.isfinite(out.measure["lml"]).all()


def test_vb_factorize_sparse_mesh_matches_single():
    """sparse x mesh: cell-sharded COO + psum collectives reproduces
    the single-device sparse run.  Cell count divisible by the mesh
    axis -> identical init streams, so lml agrees at float-reorder
    tolerance and hard assignments agree exactly."""
    import jax

    assert len(jax.devices()) == 8
    mesh = cf.make_mesh(runs=2, cells=4)
    sim = cf.simulate_whx(nrow=20, ncol=40, rank=3, aw=1.0, ah=1.0,
                          bw=2.0, bh=2.0, seed=45)
    x = sim["x"][:, :32]
    x = x[x.sum(axis=1) > 0]
    s = cf.SCSet(count=sp.csr_matrix(x))
    assert s.n_cells == 32
    a = cf.vb_factorize(s, ranks=[2, 3], nrun=2, verbose=0, Itmax=300,
                        seed=9, backend="sparse")
    b = cf.vb_factorize(s, ranks=[2, 3], nrun=2, verbose=0, Itmax=300,
                        seed=9, backend="sparse", mesh=mesh)
    np.testing.assert_allclose(a.measure["lml"], b.measure["lml"],
                               rtol=1e-3)
    for k in range(2):
        assert b.coeff[k].shape == a.coeff[k].shape
        cid_a = np.argmax(a.coeff[k], axis=0)
        cid_b = np.argmax(b.coeff[k], axis=0)
        np.testing.assert_array_equal(cid_a, cid_b)


def test_vb_factorize_sparse_mesh_cell_padding():
    """sparse x mesh with a non-divisible cell count: the padded cells
    are masked out (no dense X, padded coeff columns sliced off) and
    the planted structure is still recovered."""
    import jax

    assert len(jax.devices()) == 8
    mesh = cf.make_mesh(runs=2, cells=4)
    sim = cf.simulate_whx(nrow=20, ncol=33, rank=3, seed=45)
    s = cf.SCSet(count=sp.csr_matrix(sim["x"]))
    b = cf.vb_factorize(s, ranks=3, nrun=2, verbose=0, Itmax=300,
                        seed=9, backend="sparse", mesh=mesh)
    assert b.coeff[0].shape == (3, s.n_cells)
    assert np.isfinite(b.measure["lml"]).all()
    # full-rank solution is non-degenerate
    assert b.measure["nunif"].iloc[0] == 0


def test_from_scipy_sharded_layout():
    rng = np.random.default_rng(8)
    mat = sp.random(12, 21, density=0.3, random_state=1,
                    data_rvs=lambda k: rng.integers(1, 9, k)).tocsr()
    sc = sk.from_scipy_sharded(mat, 4, chunk=16)
    assert sc.row.shape[0] == 4
    assert sc.m == 6        # ceil(21/4 shards)*4 = 24 -> 6 local
    # reassemble and compare
    dense = np.zeros((12, 24))
    for s_ in range(4):
        for r, c, v in zip(np.asarray(sc.row[s_]),
                           np.asarray(sc.col[s_]),
                           np.asarray(sc.val[s_])):
            if r < 12 and c < 6:
                dense[r, s_ * 6 + c] += v
    np.testing.assert_array_equal(dense[:, :21], mat.toarray())
    np.testing.assert_array_equal(dense[:, 21:], 0)
