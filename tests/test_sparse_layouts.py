"""The sparse backend's layouts: sparse_layout='auto' resolves to the
dual gather-only ELL layout (ops/ell.py) on one device and on a mesh,
checked against the dense math and the COO peer; the combinations
only the removed tile layout supported raise clear errors."""

import numpy as np
import pytest
import scipy.sparse as sp

import jax
import jax.numpy as jnp

import ccfindr_tpu as cf
from ccfindr_tpu.ops import ell as ek
from ccfindr_tpu.ops import sparse as sk


def _problem(n=80, m=120, r=5, density=0.15, seed=0, hot_rows=3):
    """Sparse problem with a few dense 'housekeeping' rows to force
    overflow tails at a low ELL quantile."""
    rng = np.random.default_rng(seed)
    x = (rng.random((n, m)) < density) * rng.poisson(3.0, (n, m))
    x = x.astype(np.float64)
    x[:hot_rows] = rng.poisson(2.0, (hot_rows, m))
    x[x.sum(axis=1) == 0, 0] += 1
    x[0, x.sum(axis=0) == 0] += 1
    lw = jnp.asarray(rng.gamma(1.0, 1.0, size=(n, r)))
    lh = jnp.asarray(rng.gamma(1.0, 1.0, size=(r, m)))
    return x, lw, lh


def _counts(n, m, density, seed):
    rng = np.random.default_rng(seed)
    x = (rng.random((n, m)) < density) * rng.poisson(3.0, (n, m))
    x = x.astype(np.float64)
    x[x.sum(axis=1) == 0, 0] += 1
    x[0, x.sum(axis=0) == 0] += 1
    return x


@pytest.mark.parametrize("quantile", [1.0, 0.8])
def test_fused_ell_matches_coo(quantile):
    """Peer check of the two sparse fused backends (gather-only ELL vs
    the scatter-based COO scan), with and without overflow tails."""
    x, lw, lh = _problem(seed=4)
    ec = ek.from_scipy_ell(sp.csr_matrix(x), dtype=jnp.float64,
                           quantile=quantile, lane=8)
    sc = sk.from_scipy(sp.csr_matrix(x), dtype=jnp.float64)
    for a, b in zip(ek.fused_ell(ec, lw, lh), sk.fused_coo(sc, lw, lh)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-10)


def test_vb_factorize_sparse_auto_matches_dense():
    """sparse_layout='auto' is the ELL layout, and matches dense."""
    x = _counts(30, 45, 0.3, seed=11)
    kw = dict(ranks=[3], nrun=2, Itmax=60, verbose=0, seed=7,
              dtype=jnp.float64)
    res_d = cf.vb_factorize(x, backend="dense", **kw)
    res_a = cf.vb_factorize(sp.csr_matrix(x), backend="sparse", **kw)
    res_e = cf.vb_factorize(sp.csr_matrix(x), backend="sparse",
                            sparse_layout="ell", **kw)
    np.testing.assert_array_equal(res_a.measure["lml"].to_numpy(),
                                  res_e.measure["lml"].to_numpy())
    np.testing.assert_allclose(
        res_a.measure["lml"].to_numpy(),
        res_d.measure["lml"].to_numpy(), rtol=1e-8)
    np.testing.assert_allclose(np.asarray(res_a.basis[0]),
                               np.asarray(res_d.basis[0]), rtol=1e-6)


def test_fused_ell_sharded_matches_coo():
    """Cell-sharded dual ELL under shard_map == the unsharded COO
    scan."""
    from ccfindr_tpu.parallel.mesh import make_mesh
    from ccfindr_tpu.parallel.sharded import make_ell_fused_sharded

    x, lw, lh = _problem(n=24, m=64, r=3, seed=5)
    mesh = make_mesh(cells=4, devices=jax.devices()[:4])
    ec_s = ek.from_scipy_ell_sharded(sp.csr_matrix(x), 4,
                                     dtype=jnp.float64, quantile=0.5,
                                     lane=8)
    got = jax.jit(make_ell_fused_sharded(mesh))(ec_s, lw, lh)
    sc = sk.from_scipy(sp.csr_matrix(x), dtype=jnp.float64)
    for a, b in zip(got, sk.fused_coo(sc, lw, lh)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-10)


def test_vb_factorize_sparse_auto_mesh_matches_single_device():
    from ccfindr_tpu.parallel.mesh import make_mesh

    x = _counts(20, 30, 0.4, seed=3)
    kw = dict(ranks=[3], nrun=2, Itmax=50, verbose=0, seed=4,
              dtype=jnp.float64, backend="sparse")
    mesh = make_mesh(cells=4, devices=jax.devices()[:4])
    res_m = cf.vb_factorize(sp.csr_matrix(x), mesh=mesh, **kw)
    res_1 = cf.vb_factorize(sp.csr_matrix(x), **kw)
    np.testing.assert_allclose(
        res_m.measure["lml"].to_numpy(),
        res_1.measure["lml"].to_numpy(), rtol=1e-9)
    np.testing.assert_allclose(np.asarray(res_m.coeff[0]),
                               np.asarray(res_1.coeff[0]), rtol=1e-7)


def test_ell_ml_phases_match_reference_math():
    x, w, h = _problem(seed=7)
    ec = ek.from_scipy_ell(sp.csr_matrix(x), dtype=jnp.float64,
                           quantile=0.5, lane=8)
    wh = np.asarray(w) @ np.asarray(h)
    xn = np.asarray(x)
    hn, xlg = ek.ell_ml_h(ec, w, h)
    hn_ref = np.asarray(w).T @ np.where(xn > 0, xn / wh, 0.0)
    xlg_ref = np.sum(np.where(xn > 0, xn * np.log(wh), 0.0))
    np.testing.assert_allclose(np.asarray(hn), hn_ref, rtol=1e-10)
    np.testing.assert_allclose(float(xlg), xlg_ref, rtol=1e-10)
    wn = ek.ell_ml_w(ec, w, h)
    wn_ref = np.where(xn > 0, xn / wh, 0.0) @ np.asarray(h).T
    np.testing.assert_allclose(np.asarray(wn), wn_ref, rtol=1e-10)


def test_factorize_sparse_auto_matches_dense():
    x = _counts(40, 60, 0.4, seed=2)
    kw = dict(ranks=[3], nrun=2, Itmax=100, verbose=0, seed=3,
              dtype=jnp.float64)
    rd = cf.factorize(x, backend="dense_fused", **kw)
    rs = cf.factorize(sp.csr_matrix(x), backend="sparse", **kw)
    np.testing.assert_allclose(
        rs.measure["likelihood"].to_numpy(),
        rd.measure["likelihood"].to_numpy(), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(rs.basis[0]),
                               np.asarray(rd.basis[0]), rtol=1e-8)


def test_factorize_sparse_mesh_and_randomize_raise():
    """ML sparse with a mesh and ML sparse with randomize were tile-only
    and are removed: both raise a ValueError naming the way out."""
    from ccfindr_tpu.parallel.mesh import make_mesh

    csr = sp.csr_matrix(_counts(20, 30, 0.4, seed=1))
    kw = dict(ranks=[2], nrun=1, Itmax=5, verbose=0, backend="sparse")
    with pytest.raises(ValueError, match="dense backend with a mesh"):
        cf.factorize(csr, mesh=make_mesh(cells=4,
                                         devices=jax.devices()[:4]),
                     **kw)
    with pytest.raises(ValueError, match="randomize"):
        cf.factorize(csr, randomize=True, nsmpl=2, **kw)


def test_sparse_removed_options_raise():
    """The tile layout and its opt-in levers are gone from the sparse
    backend: each raises instead of silently changing paths."""
    csr = sp.csr_matrix(_counts(20, 30, 0.4, seed=6))
    kw = dict(ranks=[2], nrun=1, Itmax=5, verbose=0, backend="sparse")
    with pytest.raises(ValueError, match="sparse_layout"):
        cf.vb_factorize(csr, sparse_layout="tile", **kw)
    with pytest.raises(ValueError, match="sparse_layout"):
        cf.factorize(csr, sparse_layout="tile", **kw)
    with pytest.raises(ValueError, match="elbo_every"):
        cf.vb_factorize(csr, elbo_every=5, **kw)
    with pytest.raises(ValueError, match="precision"):
        cf.vb_factorize(csr, precision="bf16", **kw)
