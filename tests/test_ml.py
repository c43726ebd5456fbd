"""ML (Lee–Seung) kernel tests vs the NumPy oracle + consensus stats."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import ccfindr_tpu as cf
from ccfindr_tpu.ops import ml as ml_ops
from ccfindr_tpu.ops import consensus as cons
from ccfindr_tpu.ops import reference_impl as ref


def _problem(n=20, m=16, r=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.poisson(2.0, size=(n, m)).astype(np.float64) + \
        (rng.random((n, m)) < 0.05)
    x[x.sum(axis=1) == 0, 0] += 1
    x[0, x.sum(axis=0) == 0] += 1
    w = rng.random((n, r))
    h = rng.random((r, m))
    return x, w, h


def test_ml_sweep_matches_oracle():
    x, w, h = _problem()
    eps = np.finfo(np.float64).eps
    wj, hj = ml_ops.ml_sweep(jnp.asarray(x), jnp.asarray(w),
                             jnp.asarray(h), eps)
    wn, hn = ref.ml_sweep_np(x, w.copy(), h.copy())
    np.testing.assert_allclose(np.asarray(wj), wn, rtol=1e-10)
    np.testing.assert_allclose(np.asarray(hj), hn, rtol=1e-10)


def test_likelihood_matches_oracle():
    x, w, h = _problem(seed=1)
    lg = ml_ops.likelihood_const(jnp.asarray(x))
    lj = ml_ops.likelihood(jnp.asarray(x), jnp.asarray(w),
                           jnp.asarray(h), lg)
    ln = ref.likelihood_np(x, w, h)
    np.testing.assert_allclose(float(lj), ln, rtol=1e-10)


def test_likelihood_increases():
    x, w, h = _problem(seed=2)
    eps = np.finfo(np.float64).eps
    prev = -np.inf
    for _ in range(30):
        w, h = ref.ml_sweep_np(x, w, h)
        lk = ref.likelihood_np(x, w, h)
        assert lk >= prev - 1e-12
        prev = lk


def test_ml_run_converges():
    x, w, h = _problem(n=30, m=25, r=3, seed=3)
    res = ml_ops.ml_run(jnp.asarray(x), jnp.asarray(w), jnp.asarray(h),
                        itmax=2000, tol=1e-6)
    assert int(res.n_iter) < 2000
    assert np.isfinite(float(res.lkh))


def test_ml_run_connectivity_criterion():
    x, w, h = _problem(n=30, m=25, r=3, seed=4)
    res = ml_ops.ml_run(jnp.asarray(x), jnp.asarray(w), jnp.asarray(h),
                        itmax=2000, criterion="connectivity",
                        ncnn_step=20)
    assert int(res.n_iter) < 2000


def test_partitions_equal():
    r = 4
    a = jnp.asarray([0, 0, 1, 2, 2])
    b = jnp.asarray([3, 3, 0, 1, 1])  # same partition, relabeled
    c = jnp.asarray([0, 1, 1, 2, 2])  # different partition
    assert bool(ml_ops.partitions_equal(a, b, r))
    assert bool(ml_ops.partitions_equal(a, a, r))
    assert not bool(ml_ops.partitions_equal(a, c, r))


def test_connectivity_matches_reference_ordering():
    h = np.array([[0.9, 0.1, 0.2, 0.8],
                  [0.1, 0.9, 0.8, 0.2]])
    cnn = cons.connectivity(h=h)
    # cid = [1, 2, 2, 1]; pairs (1,2),(1,3),(1,4),(2,3),(2,4),(3,4)
    np.testing.assert_allclose(cnn, [0, 0, 1, 1, 0, 0])


def test_dispersion_bounds():
    nc = 10
    cnn_perfect = np.ones(nc * (nc - 1) // 2)
    assert abs(cons.dispersion(cnn_perfect, nc) - (1 / nc + 8 * (
        nc * (nc - 1) / 2 * 0.25) / nc ** 2)) < 1e-12
    cnn_mixed = np.full(nc * (nc - 1) // 2, 0.5)
    assert cons.dispersion(cnn_mixed, nc) == 1 / nc


def test_cophenet_on_clean_clusters():
    cid = np.array([0] * 5 + [1] * 5 + [2] * 5)
    cnn = cons.connectivity(cid=cid)
    coph = cons.cophenet(cnn, 15)
    assert coph > 0.99


def test_factorize_driver_smoke():
    x = cf.simulate_data(nfeatures=10, nsamples=[20, 20, 30], seed=5)
    s = cf.SCSet(count=x)
    s = cf.factorize(s, ranks=[2, 3], nrun=3, verbose=0, Itmax=500)
    assert s.ranks == [2, 3]
    assert list(s.measure.columns) == ["rank", "likelihood",
                                       "dispersion", "cophenetic"]
    assert s.basis[0].shape[1] == 2
    assert s.coeff[1].shape[0] == 3
    assert np.isfinite(s.measure["likelihood"]).all()


def test_factorize_randomize_se_columns():
    x = cf.simulate_data(nfeatures=8, nsamples=[10, 15], seed=6)
    s = cf.SCSet(count=x)
    s = cf.factorize(s, ranks=2, nrun=2, randomize=True, nsmpl=2,
                     verbose=0, Itmax=200)
    assert {"r_se", "d_se", "c_se"} <= set(s.measure.columns)


def test_ml_run_fused_matches_eager():
    """Deferred-likelihood fused loop == eager loop exactly (same
    GEMMs): n_iter, lkh, final factors, both stopping criteria."""
    import jax
    import jax.numpy as jnp
    from ccfindr_tpu.ops import ml as ml_ops

    n, m, r = 30, 48, 3
    rng = np.random.default_rng(13)
    x = jnp.asarray(rng.poisson(
        rng.gamma(2.0, 1.0, (n, r)) @ rng.gamma(2.0, 1.0, (r, m))),
        jnp.float64)
    key = jax.random.PRNGKey(2)
    w0, h0 = ml_ops.ml_init(key, n, m, r, jnp.float64)
    for crit, kw in [("likelihood", dict(itmax=400, tol=1e-6)),
                     ("likelihood", dict(itmax=9, tol=1e-12)),
                     ("connectivity", dict(itmax=300, ncnn_step=20))]:
        eager = ml_ops.ml_run(x, w0, h0, criterion=crit, **kw)
        fused = ml_ops.ml_run(x, w0, h0, criterion=crit,
                              fused_h=ml_ops.ml_h_dense,
                              fused_w=ml_ops.ml_w_dense, **kw)
        assert int(eager.n_iter) == int(fused.n_iter), crit
        np.testing.assert_allclose(float(fused.lkh), float(eager.lkh),
                                   rtol=1e-12)
        np.testing.assert_array_equal(np.asarray(eager.w),
                                      np.asarray(fused.w))
        np.testing.assert_array_equal(np.asarray(eager.cid),
                                      np.asarray(fused.cid))


def test_ml_pallas_kernels_match_dense():
    """The X-pass kernel's ML phases (interpret mode) == the XLA
    ml_*_dense pair."""
    import jax.numpy as jnp
    from ccfindr_tpu.ops import ml as ml_ops
    from ccfindr_tpu.ops.pallas import xpass

    n, m, r = 24, 40, 4
    rng = np.random.default_rng(14)
    x = jnp.asarray(rng.poisson(2.0, (n, m)), jnp.float64)
    w = jnp.asarray(rng.gamma(1.0, 1.0, (n, r)))
    h = jnp.asarray(rng.gamma(1.0, 1.0, (r, m)))
    ml = xpass.MLXPass(interpret=True)
    hn_d, xlw_d = ml_ops.ml_h_dense(x, w, h)
    hn_p, xlw_p = ml.h(x, w, h)
    np.testing.assert_allclose(np.asarray(hn_p), np.asarray(hn_d),
                               rtol=1e-9)
    np.testing.assert_allclose(float(xlw_p), float(xlw_d), rtol=1e-9)
    wn_d = ml_ops.ml_w_dense(x, w, h)
    wn_p = ml.w(x, w, h)
    np.testing.assert_allclose(np.asarray(wn_p), np.asarray(wn_d),
                               rtol=1e-9)


def test_factorize_backends_agree(pallas_interpret):
    rng = np.random.default_rng(15)
    x = rng.poisson(
        rng.gamma(2.0, 1.0, (20, 3)) @ rng.gamma(2.0, 1.0, (3, 30)))
    x = x + (x.sum(0) == 0)  # no empty columns
    outs = {b: cf.factorize(x, ranks=3, nrun=2, verbose=0, Itmax=200,
                            seed=7, backend=b)
            for b in ("dense", "dense_fused", "pallas")}
    lk = {b: float(o.measure["likelihood"][0]) for b, o in outs.items()}
    # -sum(wh) is reduced in rank space in the fused path: equal math,
    # different summation order
    np.testing.assert_allclose(lk["dense_fused"], lk["dense"],
                               rtol=1e-12)
    np.testing.assert_allclose(lk["pallas"], lk["dense"], rtol=1e-6)


def test_consensus_accumulator_exact(rng):
    """Streaming dispersion == direct dispersion(conav/R, m)."""
    from ccfindr_tpu.ops import consensus as cons

    m = 37
    acc = cons.ConsensusAccumulator(m)
    conav = np.zeros(m * (m - 1) // 2)
    for t in range(5):
        cid = rng.integers(0, 4, m)
        acc.add(cid)
        conav += cons.connectivity(cid=cid)
        want = cons.dispersion(conav / (t + 1), m)
        assert acc.dispersion() == pytest.approx(want, rel=1e-12)
    np.testing.assert_allclose(acc.conav(), conav / 5)


def test_ml_batch_ranks_single_rank_exact():
    """With one rank (no padding), the batched path IS the sequential
    path: identical key stream, identical results."""
    sim = cf.simulate_whx(nrow=20, ncol=30, rank=3, aw=1.0, ah=1.0,
                          seed=3)
    s = cf.SCSet(count=sim["x"])
    kw = dict(ranks=[3], nrun=3, verbose=0, Itmax=200, seed=7)
    a = cf.factorize(s, batch_ranks=False, **kw)
    b = cf.factorize(s, batch_ranks=True, **kw)
    np.testing.assert_array_equal(a.measure["likelihood"],
                                  b.measure["likelihood"])
    np.testing.assert_array_equal(a.basis[0], b.basis[0])


def test_ml_rank_mask_matches_unpadded():
    """A rank-2 problem run inside a rank-3 padded instance with a
    rank mask reproduces the unpadded rank-2 run (padded components
    pinned at eps contribute ~eps^2 to W@H — below resolution)."""
    rng2 = np.random.default_rng(12)
    n, m = 18, 26
    x = jnp.asarray(rng2.poisson(
        rng2.gamma(1.0, 1.0, (n, 2)) @ rng2.gamma(1.0, 1.0, (2, m))
        + 0.5).astype(np.float64))
    w0 = rng2.uniform(size=(n, 2))
    h0 = rng2.uniform(size=(2, m))
    a = ml_ops.ml_run(x, jnp.asarray(w0), jnp.asarray(h0), itmax=150)

    eps = np.finfo(np.float64).eps
    w0p = np.full((n, 3), eps)
    h0p = np.full((3, m), eps)
    w0p[:, :2] = w0
    h0p[:2] = h0
    mask = jnp.asarray(np.array([1.0, 1.0, 0.0]))
    b = ml_ops.ml_run(x, jnp.asarray(w0p), jnp.asarray(h0p),
                      itmax=150, rank_mask=mask)
    assert int(a.n_iter) == int(b.n_iter)
    np.testing.assert_allclose(float(a.lkh), float(b.lkh), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(a.w),
                               np.asarray(b.w[:, :2]), rtol=1e-10)
    np.testing.assert_array_equal(np.asarray(b.w[:, 2]), eps)
    # batched multi-rank sweep recovers the same science
    sim = cf.simulate_whx(nrow=20, ncol=30, rank=3, aw=1.0, ah=1.0,
                          seed=3)
    s = cf.SCSet(count=sim["x"])
    out = cf.factorize(s, ranks=[2, 3, 4], nrun=3, verbose=0,
                       Itmax=200, seed=7, batch_ranks=True)
    assert out.ranks == [2, 3, 4]
    assert np.isfinite(out.measure["likelihood"]).all()
    assert out.basis[1].shape == (s.n_genes, 3)


def test_ml_prior_map_terms():
    """prior=True applies the gamma-prior MAP terms the reference
    documents but never enables (R/factorize.R:9-22): a strong prior
    pulls the factors toward gamma_b and changes the fit."""
    sim = cf.simulate_whx(nrow=15, ncol=25, rank=2, aw=1.0, ah=1.0,
                          seed=5)
    s = cf.SCSet(count=sim["x"])
    a = cf.factorize(s, ranks=2, nrun=2, verbose=0, Itmax=150, seed=1)
    b = cf.factorize(s, ranks=2, nrun=2, verbose=0, Itmax=150, seed=1,
                     prior=True, gamma_a=5.0, gamma_b=1.0)
    assert not np.allclose(a.basis[0], b.basis[0])
    # MAP with a flat prior (a=1, b->inf limit ~ a/b -> 0) == ML
    c = cf.factorize(s, ranks=2, nrun=2, verbose=0, Itmax=150, seed=1,
                     prior=True, gamma_a=1.0, gamma_b=1e12)
    np.testing.assert_allclose(a.measure["likelihood"],
                               c.measure["likelihood"], rtol=1e-8)


def test_ml_cophenetic_gate():
    """Above cophenetic_max_cells the cophenetic switches to the
    subsampled estimator (finite, with SEs in metadata, not NaN);
    dispersion stays exact via the streaming
    identity."""
    sim = cf.simulate_whx(nrow=15, ncol=30, rank=2, aw=1.0, ah=1.0,
                          seed=6)
    s = cf.SCSet(count=sim["x"])
    a = cf.factorize(s, ranks=2, nrun=2, verbose=0, Itmax=100, seed=1,
                     cophenetic_max_cells=5)
    b = cf.factorize(s, ranks=2, nrun=2, verbose=0, Itmax=100, seed=1)
    assert np.isfinite(a.measure["cophenetic"]).all()
    assert "cophenetic_se" in a.metadata
    assert np.isfinite(b.measure["cophenetic"]).all()
    assert "cophenetic_se" not in b.metadata
    np.testing.assert_allclose(a.measure["dispersion"],
                               b.measure["dispersion"])


def test_ml_factorize_mesh_matches_single(pallas_interpret):
    """ML mesh path (GSPMD dense + shard_map pallas): same science as
    the single-device run, non-divisible cell count included."""
    import jax

    assert len(jax.devices()) == 8
    mesh = cf.make_mesh(runs=2, cells=4)
    sim = cf.simulate_whx(nrow=16, ncol=33, rank=2, aw=1.0, ah=1.0,
                          seed=8)
    s = cf.SCSet(count=sim["x"])
    kw = dict(ranks=2, nrun=2, verbose=0, Itmax=200, seed=4)
    a = cf.factorize(s, **kw)
    b = cf.factorize(s, mesh=mesh, **kw)
    np.testing.assert_allclose(a.measure["likelihood"],
                               b.measure["likelihood"], rtol=1e-4)
    assert b.coeff[0].shape == a.coeff[0].shape
    c = cf.factorize(s, mesh=mesh, backend="pallas", **kw)
    np.testing.assert_allclose(a.measure["likelihood"],
                               c.measure["likelihood"], rtol=1e-3)
    assert c.coeff[0].shape == a.coeff[0].shape


def test_cophenetic_subsampled_matches_exact():
    """Above cophenetic_max_cells, factorize reports a finite
    subsampled cophenetic; the estimator agrees with the exact value
    on moderate m (the reference computes the full
    consensus unconditionally, R/factorize.R:69-78)."""
    from ccfindr_tpu.ops import consensus as cons

    rng = np.random.default_rng(3)
    m = 600
    acc = cons.ConsensusAccumulator(m)
    base = rng.integers(0, 4, m)
    for _ in range(6):
        lab = base.copy()
        flip = rng.random(m) < 0.15
        lab[flip] = rng.integers(0, 4, int(flip.sum()))
        acc.add(lab)
    exact = cons.cophenet(acc.conav(), m)
    est, se = cons.cophenet_subsampled(acc, max_cells=300, nsub=5,
                                       seed=0)
    assert np.isfinite(est) and np.isfinite(se)
    assert abs(est - exact) < 0.05, (est, exact)


def test_factorize_subsampled_cophenetic_finite():
    sim = cf.simulate_data(nfeatures=20, nsamples=[15, 15, 15], seed=4)
    s = cf.SCSet(count=np.asarray(sim))
    out = cf.factorize(s, ranks=3, nrun=3, verbose=0, Itmax=100,
                       seed=1, cophenetic_max_cells=20,
                       cophenetic_nsub=3)
    coph = float(out.measure["cophenetic"][0])
    assert np.isfinite(coph) and 0 <= coph <= 1
    assert "cophenetic_se" in out.metadata


def test_ell_ml_kernels_match_dense():
    """ELL ML phases == dense fused phases (ops.ell.ell_ml_h/ell_ml_w
    vs ops.ml.ml_h_dense/ml_w_dense), incl. overflow tails."""
    import scipy.sparse as sp

    from ccfindr_tpu.ops import ell as ek
    from ccfindr_tpu.ops import ml as ml_ops

    rng = np.random.default_rng(11)
    n, m, r = 30, 40, 4
    x = rng.poisson(0.8, (n, m)) * (rng.random((n, m)) < 0.4)
    x[:, 0] += 1
    x[0, :] += 1
    w = jnp.asarray(rng.gamma(1.0, 1.0, (n, r)))
    h = jnp.asarray(rng.gamma(1.0, 1.0, (r, m)))
    xj = jnp.asarray(x, jnp.float64)
    # lane=8 forces overflow tails on this tiny matrix
    ec = ek.from_scipy_ell(sp.csr_matrix(x), dtype=jnp.float64,
                           quantile=0.7, lane=8)

    hn_d, xl_d = ml_ops.ml_h_dense(xj, w, h)
    hn_e, xl_e = ek.ell_ml_h(ec, w, h)
    np.testing.assert_allclose(np.asarray(hn_e), np.asarray(hn_d),
                               rtol=1e-10)
    np.testing.assert_allclose(float(xl_e), float(xl_d), rtol=1e-10)

    wn_d = ml_ops.ml_w_dense(xj, w, h)
    wn_e = ek.ell_ml_w(ec, w, h)
    np.testing.assert_allclose(np.asarray(wn_e), np.asarray(wn_d),
                               rtol=1e-10)


def test_factorize_sparse_matches_dense():
    """factorize(backend='sparse') == dense_fused factorize: same
    measures and factors (ML/VB driver parity; the reference treats
    the paths symmetrically, R/factorize.R:139-276)."""
    sim = cf.simulate_whx(nrow=25, ncol=35, rank=3, seed=9)
    s = cf.SCSet(count=sim["x"])
    kw = dict(ranks=[2, 3], nrun=3, verbose=0, Itmax=200, seed=2)
    a = cf.factorize(s, backend="dense_fused", **kw)
    b = cf.factorize(s, backend="sparse", **kw)
    np.testing.assert_allclose(b.measure["likelihood"],
                               a.measure["likelihood"], rtol=1e-8)
    np.testing.assert_allclose(b.measure["dispersion"],
                               a.measure["dispersion"], rtol=1e-8)
    for k in range(2):
        np.testing.assert_allclose(b.basis[k], a.basis[k], rtol=1e-6)
        np.testing.assert_allclose(b.coeff[k], a.coeff[k], rtol=1e-6)


def test_factorize_storage_dtype_matches_float():
    """int16 X storage gives identical ML results (exact math, kernels
    upcast; mirrors vb_factorize storage_dtype)."""
    sim = cf.simulate_whx(nrow=20, ncol=30, rank=2, seed=10)
    s = cf.SCSet(count=sim["x"])
    kw = dict(ranks=2, nrun=2, verbose=0, Itmax=150, seed=3)
    a = cf.factorize(s, backend="dense_fused", **kw)
    b = cf.factorize(s, backend="dense_fused", storage_dtype="int16",
                     **kw)
    np.testing.assert_allclose(b.measure["likelihood"],
                               a.measure["likelihood"], rtol=1e-12)
    np.testing.assert_array_equal(b.basis[0], a.basis[0])


def test_ml_checkpoint_every_matches_uninterrupted(tmp_path):
    """Chunked ML sweep execution (checkpoint_every) gives bit-identical
    results to one uninterrupted run, including after a simulated
    crash + resume — the factorize twin of the VB driver's
    test_checkpoint_every_matches_uninterrupted (reference treats the
    drivers symmetrically, R/factorize.R:139-276 vs
    R/bayesian.R:229-390)."""
    import pytest

    sim = cf.simulate_whx(nrow=25, ncol=40, rank=3, seed=31)
    s = cf.SCSet(count=sim["x"])
    kw = dict(ranks=[2, 3], nrun=2, verbose=0, Itmax=400, seed=4)
    a = cf.factorize(s, **kw)
    b = cf.factorize(s, checkpoint_dir=str(tmp_path / "ck1"),
                     checkpoint_every=30, **kw)
    np.testing.assert_array_equal(a.measure["likelihood"],
                                  b.measure["likelihood"])
    np.testing.assert_array_equal(a.measure["dispersion"],
                                  b.measure["dispersion"])
    for k in range(2):
        np.testing.assert_array_equal(a.basis[k], b.basis[k])
        np.testing.assert_array_equal(a.coeff[k], b.coeff[k])

    # simulated crash after the first chunk, then resume
    from ccfindr_tpu.drivers import ml_driver as md

    orig = md._chunked_ml
    calls = {"n": 0}

    def boom(call, *args, **kwargs):
        def wrapped(*a, **k):
            calls["n"] += 1
            if calls["n"] == 2:
                raise KeyboardInterrupt
            return call(*a, **k)
        return orig(wrapped, *args, **kwargs)

    md._chunked_ml = boom
    try:
        with pytest.raises(KeyboardInterrupt):
            cf.factorize(s, checkpoint_dir=str(tmp_path / "ck2"),
                         checkpoint_every=30, **kw)
    finally:
        md._chunked_ml = orig
    import os
    assert any("ml_sweeps" in f for f in os.listdir(tmp_path / "ck2"))
    c = cf.factorize(s, checkpoint_dir=str(tmp_path / "ck2"),
                     checkpoint_every=30, **kw)
    np.testing.assert_array_equal(a.measure["likelihood"],
                                  c.measure["likelihood"])
    for k in range(2):
        np.testing.assert_array_equal(a.basis[k], c.basis[k])


def test_ml_checkpoint_connectivity_criterion(tmp_path):
    """The connectivity stopping criterion's resume carry (cid streak)
    survives chunking bit-exactly."""
    sim = cf.simulate_whx(nrow=20, ncol=30, rank=3, seed=7)
    s = cf.SCSet(count=sim["x"])
    kw = dict(ranks=[3], nrun=2, verbose=0, Itmax=200, seed=5,
              criterion="connectivity", ncnn_step=10)
    a = cf.factorize(s, **kw)
    b = cf.factorize(s, checkpoint_dir=str(tmp_path),
                     checkpoint_every=13, **kw)
    np.testing.assert_array_equal(a.measure["likelihood"],
                                  b.measure["likelihood"])
    np.testing.assert_array_equal(a.basis[0], b.basis[0])


def test_ml_sample_progress_restore(tmp_path):
    """checkpoint_dir alone persists completed samples of a
    randomized scan; a rerun restores them and matches exactly."""
    sim = cf.simulate_whx(nrow=20, ncol=30, rank=2, seed=8)
    s = cf.SCSet(count=sim["x"])
    kw = dict(ranks=[2, 3], nrun=2, verbose=0, Itmax=100, seed=9,
              randomize=True, nsmpl=2)
    a = cf.factorize(s, **kw)
    ck = str(tmp_path / "prog")
    b = cf.factorize(s, checkpoint_dir=ck, **kw)
    np.testing.assert_array_equal(a.measure["likelihood"],
                                  b.measure["likelihood"])

    # crash right after sample 0's progress save, then rerun: the
    # finished sample restores from the store and the final result is
    # identical
    import numpy as _np

    calls = {"n": 0}
    orig_np_savez = _np.savez

    def crash_after_first(file, **kwargs):
        orig_np_savez(file, **kwargs)
        if "ml_progress" in str(file):
            calls["n"] += 1
            if calls["n"] == 1:
                raise KeyboardInterrupt

    _np.savez = crash_after_first
    try:
        with pytest.raises(KeyboardInterrupt):
            cf.factorize(s, checkpoint_dir=ck, **kw)
    finally:
        _np.savez = orig_np_savez
    c = cf.factorize(s, checkpoint_dir=ck, **kw)
    np.testing.assert_array_equal(a.measure["likelihood"],
                                  c.measure["likelihood"])
    np.testing.assert_array_equal(a.measure["r_se"],
                                  c.measure["r_se"])


def test_ml_compact_every_bit_exact():
    """ML converged-lane compaction == unchunked run, bit-exact."""
    sim = cf.simulate_whx(nrow=30, ncol=50, rank=3, seed=2)
    s = cf.SCSet(count=sim["x"])
    kw = dict(ranks=[2, 3, 4], nrun=3, verbose=0, Itmax=400, seed=4)
    a = cf.factorize(s, **kw)
    b = cf.factorize(s, compact_every=40, **kw)
    np.testing.assert_array_equal(a.measure["likelihood"],
                                  b.measure["likelihood"])
    for k in range(len(a.ranks)):
        np.testing.assert_array_equal(a.basis[k], b.basis[k])
