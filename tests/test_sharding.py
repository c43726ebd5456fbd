"""Multi-device sharding tests on the virtual 8-CPU mesh.

Validates the SPMD design (cell-sharded X/H, replicated W, runs-sharded
restarts): sharded execution must match single-device results.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import ccfindr_tpu as cf
from ccfindr_tpu.ops import vb as vb_ops
from ccfindr_tpu.ops.vb import Hyper


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) == 8, "conftest must provide 8 devices"
    return cf.make_mesh(runs=2, cells=4)


def test_make_mesh_shapes(mesh8):
    assert mesh8.axis_names == ("runs", "genes", "cells")
    assert mesh8.devices.shape == (2, 1, 4)


def test_vb_sweep_sharded_matches_single(mesh8):
    sim = cf.simulate_whx(nrow=24, ncol=64, rank=3, seed=42)
    xfull = sim["x"]
    mtrim = (xfull.shape[1] // 4) * 4   # divisible by the cells axis
    x = jnp.asarray(xfull[:, :mtrim])
    key = jax.random.PRNGKey(0)
    hyper = Hyper(*(jnp.asarray(v) for v in (1.0, 1.0, 1.0, 1.0)))
    st = vb_ops.vb_init_random(key, x.shape[0], x.shape[1], 3, hyper,
                               dtype=jnp.float64)
    eps = np.finfo(np.float64).eps
    lgx = jnp.sum(jax.scipy.special.gammaln(x + 1.0))

    ref_out = vb_ops.vb_sweep(x, st, hyper, eps, lgx)

    xs = jax.device_put(x, NamedSharding(mesh8, P(None, "cells")))
    sts = type(st)(
        ew=jax.device_put(st.ew, NamedSharding(mesh8, P(None, None))),
        eh=jax.device_put(st.eh, NamedSharding(mesh8, P(None, "cells"))),
        lw=jax.device_put(st.lw, NamedSharding(mesh8, P(None, None))),
        lh=jax.device_put(st.lh, NamedSharding(mesh8, P(None, "cells"))),
        dw=st.dw, dh=st.dh, lkh=st.lkh)
    shard_out = jax.jit(vb_ops.vb_sweep, static_argnames=())(
        xs, sts, hyper, eps, lgx)

    np.testing.assert_allclose(np.asarray(shard_out.ew),
                               np.asarray(ref_out.ew), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(shard_out.eh),
                               np.asarray(ref_out.eh), rtol=1e-12)
    np.testing.assert_allclose(float(shard_out.lkh),
                               float(ref_out.lkh), rtol=1e-12)


def test_vb_factorize_sharded_matches_unsharded(mesh8):
    """Sharded (cell-padded+masked) vs single-device factorization.

    Sharded reductions reorder float ops, which can shift the sweep at
    which the rel-tol 1e-5 stopping rule fires — so lml agrees at the
    tolerance scale, and hard cluster assignments agree exactly.
    """
    sim = cf.simulate_whx(nrow=20, ncol=33, rank=2, seed=43)
    s = cf.SCSet(count=sim["x"])
    if s.n_cells % 4 == 0:      # ensure the mask-padding path is hit
        s = s[np.arange(s.n_genes), np.arange(s.n_cells - 1)]
    a = cf.vb_factorize(s, ranks=2, nrun=2, verbose=0, Itmax=300,
                        seed=9)
    b = cf.vb_factorize(s, ranks=2, nrun=2, verbose=0, Itmax=300,
                        seed=9, mesh=mesh8)
    np.testing.assert_allclose(a.measure["lml"], b.measure["lml"],
                               rtol=1e-3)
    assert b.coeff[0].shape == a.coeff[0].shape  # padding sliced off
    cid_a = np.argmax(a.coeff[0], axis=0)
    cid_b = np.argmax(b.coeff[0], axis=0)
    np.testing.assert_array_equal(cid_a, cid_b)


def test_ml_factorize_on_mesh_smoke(mesh8):
    """ML driver over the mesh (GSPMD path); equivalence with the
    single-device run is covered in test_ml.py."""
    x = cf.simulate_data(nfeatures=8, nsamples=[10, 12], seed=44)
    s = cf.SCSet(count=x)
    out = cf.factorize(s, ranks=2, nrun=2, verbose=0, Itmax=100,
                       mesh=mesh8)
    assert out.ranks == [2]


def test_fused_sharded_matches_dense(mesh8):
    """shard_map fused kernel (per-shard pallas + explicit psum) ==
    single-device fused_dense."""
    from ccfindr_tpu.parallel.sharded import make_fused_sharded
    from jax.sharding import NamedSharding

    n, m, r = 16, 32, 3
    rng = np.random.default_rng(17)
    x = jnp.asarray(rng.poisson(2.0, (n, m)).astype(np.float64))
    lw = jnp.asarray(rng.gamma(1.0, 1.0, (n, r)))
    lh = jnp.asarray(rng.gamma(1.0, 1.0, (r, m)))
    ref = vb_ops.fused_dense(x, lw, lh)

    from ccfindr_tpu.ops.pallas.xpass import VBXPass
    fused = make_fused_sharded(mesh8, fused_local=VBXPass(interpret=True))
    xs = jax.device_put(x, NamedSharding(mesh8, P(None, "cells")))
    lhs = jax.device_put(lh, NamedSharding(mesh8, P(None, "cells")))
    out = jax.jit(fused)(xs, lw, lhs)
    for a, b, name in zip(out, ref, ("swn", "shn", "dterm")):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-9, err_msg=name)


def test_vb_factorize_mesh_pallas_backend(mesh8, pallas_interpret):
    """Driver mesh path with the sharded fused pallas backend: same
    science as the single-device fused run."""
    # planted rank 3 so both fitted ranks are well-posed (an overfit
    # rank is degenerate and sensitive to the restart init stream,
    # which differs between padded and unpadded cell axes)
    sim = cf.simulate_whx(nrow=20, ncol=33, rank=3, seed=44)
    s = cf.SCSet(count=sim["x"])
    a = cf.vb_factorize(s, ranks=[2, 3], nrun=2, verbose=0, Itmax=300,
                        seed=9, backend="pallas")
    b = cf.vb_factorize(s, ranks=[2, 3], nrun=2, verbose=0, Itmax=300,
                        seed=9, backend="pallas", mesh=mesh8)
    np.testing.assert_allclose(a.measure["lml"], b.measure["lml"],
                               rtol=1e-3)
    for k in range(2):
        cid_a = np.argmax(a.coeff[k], axis=0)
        cid_b = np.argmax(b.coeff[k], axis=0)
        # NMF factors are permutation-symmetric: map each a-label to
        # its majority b-label and compare partitions
        r = k + 2
        remap = {ca: np.bincount(cid_b[cid_a == ca], minlength=r
                                 ).argmax() for ca in range(r)}
        concord = np.mean([remap[ca] == cb
                           for ca, cb in zip(cid_a, cid_b)])
        assert concord > 0.97, (k, concord)


def test_vb_factorize_gene_sharded_matches_single(pallas_interpret):
    """Gene-axis (TP) sharding: make_mesh(genes=2, cells=4) with X
    sharded P('genes','cells'), W row-sharded, shn/dterm psum'd over
    'genes' (the dual of the swn-over-'cells' psum) reproduces the
    single-device run — non-divisible gene count (row padding + mask)
    included.  SURVEY §2.3 TP row."""
    sim = cf.simulate_whx(nrow=27, ncol=36, rank=3, seed=21)
    s = cf.SCSet(count=sim["x"])  # 27 rows: not divisible by genes=2
    kw = dict(ranks=[2, 3], nrun=2, verbose=0, Itmax=150, seed=4,
              backend="pallas")
    ref = cf.vb_factorize(s, **kw)
    mesh = cf.make_mesh(runs=1, genes=2, cells=4)
    got = cf.vb_factorize(s, mesh=mesh, **kw)
    assert got.ranks == ref.ranks
    np.testing.assert_allclose(got.measure["lml"], ref.measure["lml"],
                               rtol=1e-6)
    for k in range(len(ref.ranks)):
        np.testing.assert_allclose(got.basis[k], ref.basis[k],
                                   rtol=1e-5)
        np.testing.assert_allclose(got.coeff[k], ref.coeff[k],
                                   rtol=1e-5)


def test_vb_factorize_gene_and_cell_sharded_dense():
    """2-D sharding (genes x cells) on the dense GSPMD backend."""
    sim = cf.simulate_whx(nrow=20, ncol=30, rank=2, seed=22)
    s = cf.SCSet(count=sim["x"])
    # Tol=0 fixes the sweep count and hyper updates are disabled, so
    # GSPMD reduction-order noise can neither shift the convergence
    # sweep nor flip the hyper Newton's early exit between the runs
    kw = dict(ranks=2, nrun=2, verbose=0, Itmax=60, Tol=0.0, seed=5,
              hyper_update=(False,) * 4, backend="dense_fused")
    ref = cf.vb_factorize(s, **kw)
    mesh = cf.make_mesh(runs=2, genes=2, cells=2)
    got = cf.vb_factorize(s, mesh=mesh, **kw)
    np.testing.assert_allclose(got.measure["lml"], ref.measure["lml"],
                               rtol=1e-8)
    np.testing.assert_allclose(got.basis[0], ref.basis[0], rtol=1e-6)


def test_mesh_bf16_precision_runs(pallas_interpret):
    """precision='bf16' on the cell-sharded mesh path (the opt-in
    reaches mesh users of the fused kernel): runs, and tracks
    the f32 mesh result loosely (on the f64 CPU test mesh the bf16
    operand cast is a real truncation)."""
    import jax
    import numpy as np

    import ccfindr_tpu as cf
    from ccfindr_tpu.parallel.mesh import make_mesh

    sim = cf.simulate_whx(nrow=24, ncol=40, rank=3, seed=21)
    s = cf.SCSet(count=sim["x"])
    mesh = make_mesh(cells=4, devices=jax.devices()[:4])
    kw = dict(ranks=3, nrun=2, verbose=0, Itmax=200, seed=5,
              backend="pallas", mesh=mesh)
    a = cf.vb_factorize(s, **kw)
    b = cf.vb_factorize(s, precision="bf16", **kw)
    assert np.isfinite(b.measure["lml"]).all()
    np.testing.assert_allclose(b.measure["lml"], a.measure["lml"],
                               rtol=0.05)
