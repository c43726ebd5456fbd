"""VB driver tests: end-to-end factorization, oracle recovery,
measure-table contract, degeneracy handling."""

import numpy as np
import pytest

import ccfindr_tpu as cf


def test_vb_factorize_fills_slots():
    sim = cf.simulate_whx(nrow=30, ncol=50, rank=3, seed=11)
    s = cf.SCSet(count=sim["x"])
    s = cf.vb_factorize(s, ranks=[2, 3], nrun=2, verbose=0, Itmax=500)
    assert s.ranks == [2, 3]
    assert list(s.measure.columns) == ["rank", "lml", "aw", "bw", "ah",
                                       "bh", "nunif"]
    assert s.basis[0].shape == (s.n_genes, 2)
    assert s.coeff[1].shape == (3, s.n_cells)
    assert s.dbasis[0].shape == (s.n_genes, 2)
    assert (s.dbasis[0] >= 0).all()
    assert np.isfinite(s.measure["lml"]).all()


def test_vb_factorize_empty_guards():
    x = np.array([[1, 2, 0], [0, 0, 0], [2, 1, 0]])
    with pytest.raises(ValueError, match="empty"):
        cf.vb_factorize(cf.SCSet(count=x, remove_zeros=False), ranks=2,
                        verbose=0)


def test_vb_factorize_rank_capped_to_ncol():
    sim = cf.simulate_whx(nrow=40, ncol=6, rank=2, seed=12)
    s = cf.SCSet(count=sim["x"])
    m = s.n_cells
    s = cf.vb_factorize(s, ranks=[2, m + 5], nrun=1, verbose=0,
                        Itmax=200)
    assert s.ranks == [2]


def test_vb_svd_initializers():
    sim = cf.simulate_whx(nrow=25, ncol=30, rank=3, seed=13)
    s = cf.SCSet(count=sim["x"])
    for init in ("svd", "svd2"):
        out = cf.vb_factorize(s, ranks=3, nrun=1, verbose=0,
                              initializer=init, Itmax=300)
        assert out.ranks == [3]
        assert np.isfinite(out.measure["lml"]).all()
    # nrun > 1 with a deterministic init collapses to one restart
    # (identical restarts tie; reference R/bayesian.R:334-335)
    one = cf.vb_factorize(s, ranks=3, nrun=1, verbose=0,
                          initializer="svd2", Itmax=300)
    two = cf.vb_factorize(s, ranks=3, nrun=2, verbose=0,
                          initializer="svd2", Itmax=300)
    np.testing.assert_array_equal(one.measure["lml"],
                                  two.measure["lml"])


def test_planted_rank_recovery():
    """simulate_whx data generated at rank 5 -> evidence peaks at 5.

    The statistical oracle from the reference's vignette workflow
    (vignettes/ccfindR.Rmd:414-423).
    """
    sim = cf.simulate_whx(nrow=60, ncol=120, rank=5, aw=0.5, bw=1.0,
                          ah=0.5, bh=1.0, seed=1)
    s = cf.SCSet(count=sim["x"])
    s = cf.vb_factorize(s, ranks=list(range(2, 9)), nrun=3, verbose=0,
                        Itmax=2000, seed=3)
    opt = cf.optimal_rank(s)
    assert opt["ropt"] in (4, 5, 6), f"got {opt}"


def test_cluster_recovery_concordance():
    """Planted hard clusters recovered by argmax-H assignment."""
    x = cf.simulate_data(nfeatures=20, nsamples=[30, 30, 40],
                         generate_factors=True, seed=21)
    true = np.argmax(x["h"], axis=0)
    # only all-zero genes can occur; cells always have counts
    s = cf.SCSet(count=x["x"], remove_zeros=True)
    assert s.n_cells == len(true)
    s = cf.vb_factorize(s, ranks=3, nrun=3, verbose=0, Itmax=1000,
                        seed=5)
    cid = cf.cluster_id(s, rank=3).to_numpy() - 1
    # concordance up to label permutation via contingency argmax
    tab = np.zeros((3, 3))
    for a, b in zip(true, cid):
        tab[a, b] += 1
    acc = sum(tab.max(axis=0)) / len(cid)
    assert acc > 0.95, f"cluster concordance {acc}"


def test_vb_reproducible_with_seed():
    sim = cf.simulate_whx(nrow=20, ncol=25, rank=2, seed=31)
    s = cf.SCSet(count=sim["x"])
    a = cf.vb_factorize(s, ranks=2, nrun=2, verbose=0, Itmax=200, seed=7)
    b = cf.vb_factorize(s, ranks=2, nrun=2, verbose=0, Itmax=200, seed=7)
    np.testing.assert_allclose(a.basis[0], b.basis[0])
    np.testing.assert_allclose(a.measure["lml"], b.measure["lml"])


def test_batch_ranks_single_rank_matches_sequential():
    """With one rank == rmax, the batched path draws identical inits
    and must match the sequential path exactly."""
    sim = cf.simulate_whx(nrow=25, ncol=30, rank=3, seed=41)
    s = cf.SCSet(count=sim["x"])
    a = cf.vb_factorize(s, ranks=3, nrun=2, verbose=0, Itmax=300,
                        seed=17)
    b = cf.vb_factorize(s, ranks=3, nrun=2, verbose=0, Itmax=300,
                        seed=17, batch_ranks=True)
    np.testing.assert_allclose(a.measure["lml"], b.measure["lml"],
                               rtol=1e-12)
    np.testing.assert_allclose(a.basis[0], b.basis[0], rtol=1e-10)


def test_batch_ranks_sweep_recovers_planted_rank():
    sim = cf.simulate_whx(nrow=60, ncol=120, rank=5, aw=0.5, bw=1.0,
                          ah=0.5, bh=1.0, seed=1)
    s = cf.SCSet(count=sim["x"])
    f = cf.vb_factorize(s, ranks=list(range(2, 9)), nrun=3, verbose=0,
                        Itmax=2000, seed=3, batch_ranks=True)
    # over-specified ranks may collapse (uniform column) and drop out
    # of the scan, mirroring the reference's unif.stop behavior
    assert f.ranks[:4] == [2, 3, 4, 5]
    assert f.basis[0].shape[1] == 2          # sliced to true rank
    assert f.coeff[-1].shape[0] == f.ranks[-1]
    opt = cf.optimal_rank(f)
    assert opt["ropt"] in (4, 5, 6), f"got {opt}"


def test_batch_ranks_svd_init_runs():
    # batch_ranks with a deterministic init is supported; parity vs the sequential path is pinned by
    # test_svd_init_batched_matches_sequential
    sim = cf.simulate_whx(nrow=20, ncol=25, rank=2, seed=42)
    s = cf.SCSet(count=sim["x"])
    out = cf.vb_factorize(s, ranks=2, initializer="svd2", verbose=0,
                          Itmax=100, batch_ranks=True)
    assert np.isfinite(out.measure["lml"]).all()


def test_checkpoint_resume(tmp_path):
    sim = cf.simulate_whx(nrow=20, ncol=25, rank=2, seed=51)
    s = cf.SCSet(count=sim["x"])
    ck = str(tmp_path / "ck")
    a = cf.vb_factorize(s, ranks=[2, 3], nrun=2, verbose=0, Itmax=200,
                        seed=3, checkpoint_dir=ck)
    # resume: both ranks restore from checkpoint, results identical
    b = cf.vb_factorize(s, ranks=[2, 3], nrun=2, verbose=0, Itmax=200,
                        seed=3, checkpoint_dir=ck)
    np.testing.assert_allclose(a.measure["lml"], b.measure["lml"])
    np.testing.assert_allclose(a.basis[0], b.basis[0])
    # partial resume: rank 2 restored, rank 4 computed fresh
    c = cf.vb_factorize(s, ranks=[2, 4], nrun=2, verbose=0, Itmax=200,
                        seed=3, checkpoint_dir=ck)
    np.testing.assert_allclose(c.measure["lml"].iloc[0],
                               a.measure["lml"].iloc[0])


def test_schedule_partition():
    from ccfindr_tpu.parallel import (partition_items, rank_run_grid,
                                      gather_results)
    grid = rank_run_grid([2, 3, 4], 5)
    assert len(grid) == 15
    seen = np.concatenate([partition_items(15, 4, p) for p in range(4)])
    assert sorted(seen.tolist()) == list(range(15))
    vals = np.arange(15, dtype=float)
    mine = partition_items(15, 4, 1)
    out = gather_results(vals[mine], mine, 15)
    np.testing.assert_allclose(out[mine], vals[mine])


def test_vb_backends_agree(pallas_interpret):
    """dense / dense_fused / pallas (the fused X-pass kernel) backends
    give the same factorization: dense vs dense_fused exactly, pallas
    within float tolerance; the removed 'pallas2pass' is refused."""
    sim = cf.simulate_whx(nrow=24, ncol=40, rank=3, seed=21)
    s = cf.SCSet(count=sim["x"])
    outs = {b: cf.vb_factorize(s, ranks=3, nrun=2, verbose=0,
                               Itmax=300, backend=b, seed=5)
            for b in ("dense", "dense_fused", "pallas")}
    lml = {b: float(o.measure["lml"][0]) for b, o in outs.items()}
    assert lml["dense"] == lml["dense_fused"]
    np.testing.assert_allclose(lml["pallas"], lml["dense"], rtol=1e-6)
    with pytest.raises(ValueError, match="unknown backend"):
        cf.vb_factorize(s, ranks=3, verbose=0, backend="pallas2pass")
    np.testing.assert_array_equal(outs["dense"].basis[0],
                                  outs["dense_fused"].basis[0])
    np.testing.assert_allclose(outs["pallas"].basis[0],
                               outs["dense"].basis[0], rtol=1e-4)


def test_checkpoint_every_matches_uninterrupted(tmp_path):
    """Chunked sweep execution (checkpoint_every) gives bit-identical
    results to one uninterrupted run, including after a simulated
    crash + resume."""
    sim = cf.simulate_whx(nrow=25, ncol=40, rank=3, seed=31)
    s = cf.SCSet(count=sim["x"])
    kw = dict(ranks=[2, 3], nrun=2, verbose=0, Itmax=400, seed=4)
    a = cf.vb_factorize(s, **kw)
    b = cf.vb_factorize(s, checkpoint_dir=str(tmp_path / "ck1"),
                        checkpoint_every=30, **kw)
    np.testing.assert_array_equal(a.measure["lml"], b.measure["lml"])
    for k in range(2):
        np.testing.assert_array_equal(a.basis[k], b.basis[k])
        np.testing.assert_array_equal(a.coeff[k], b.coeff[k])

    # simulated crash after the first chunk, then resume
    from ccfindr_tpu.drivers import vb_driver as vd

    orig = vd._chunked_vb
    calls = {"n": 0}

    def boom(call, *args, **kwargs):
        def wrapped(*a, **k):
            calls["n"] += 1
            if calls["n"] == 2:
                raise KeyboardInterrupt
            return call(*a, **k)
        return orig(wrapped, *args, **kwargs)

    vd._chunked_vb = boom
    try:
        with pytest.raises(KeyboardInterrupt):
            cf.vb_factorize(s, checkpoint_dir=str(tmp_path / "ck2"),
                            checkpoint_every=30, **kw)
    finally:
        vd._chunked_vb = orig
    import os
    assert any("vb_sweeps" in f for f in os.listdir(tmp_path / "ck2"))
    c = cf.vb_factorize(s, checkpoint_dir=str(tmp_path / "ck2"),
                        checkpoint_every=30, **kw)
    np.testing.assert_array_equal(a.measure["lml"], c.measure["lml"])
    for k in range(2):
        np.testing.assert_array_equal(a.basis[k], c.basis[k])


def test_f32_f64_rank_selection_concordant():
    """SURVEY §7.1 validation item: float32 (the GPU production dtype)
    and float64 evidence profiles select the same optimal rank on
    oracle data."""
    import jax.numpy as jnp

    sim = cf.simulate_whx(nrow=60, ncol=120, rank=4, seed=12)
    s = cf.SCSet(count=sim["x"])
    kw = dict(ranks=[2, 3, 4, 5, 6], nrun=2, verbose=0, Itmax=1500,
              seed=3)
    r64 = cf.optimal_rank(cf.vb_factorize(s, dtype=jnp.float64, **kw))
    r32 = cf.optimal_rank(cf.vb_factorize(s, dtype=jnp.float32, **kw))
    assert r64["ropt"] == 4
    assert r32["ropt"] == r64["ropt"]


def test_connectivity_running_mean_dispersion(capsys):
    """connectivity=True reports dispersion of the ACROSS-RUN running
    mean connectivity (the reference's intended semantics,
    R/bayesian.R:353-357 — its own conav is re-zeroed per worker).

    The printed dispersions are checked EXACTLY: a spy captures each
    run's H matrix as the driver hands it to connectivity(), and the
    expected values are recomputed as dispersion(mean of the first k
    connectivity vectors) with the real consensus functions.
    """
    from ccfindr_tpu.drivers import vb_driver as vd
    from ccfindr_tpu.ops import consensus as cons

    captured = []
    orig_connectivity = cons.connectivity

    def spy(h=None, **kw):
        captured.append(np.asarray(h))
        return orig_connectivity(h=h, **kw)

    sim = cf.simulate_whx(nrow=25, ncol=40, rank=3, seed=4)
    vd.cons.connectivity = spy
    try:
        out = cf.vb_factorize(cf.SCSet(count=sim["x"]), ranks=[3],
                              nrun=3, verbose=2, Itmax=300,
                              connectivity=True, seed=1)
    finally:
        vd.cons.connectivity = orig_connectivity
    outlines = [ln for ln in capsys.readouterr().out.splitlines()
                if "dispersion" in ln]
    assert len(outlines) == 3
    assert len(captured) == 3
    vals = [float(ln.rsplit("=", 1)[1]) for ln in outlines]

    m = captured[0].shape[1]
    cnns = [orig_connectivity(h=h) for h in captured]
    acc = 0.0
    for k, v in enumerate(vals):
        acc = acc + cnns[k]
        expect = cons.dispersion(acc / (k + 1), m)
        assert v == pytest.approx(float(expect), rel=1e-5)
    # first run's dispersion of a single 0/1 connectivity vector is 1
    assert vals[0] == pytest.approx(1.0)
    # the spied H matrices are the REAL per-restart coefficients, not
    # driver-internal scratch: the best restart's equals the returned
    # coeff matrix bit-for-bit, and the restarts are distinct
    assert any(np.array_equal(h, np.asarray(out.coeff[0]))
               for h in captured)
    assert not np.array_equal(captured[0], captured[1])


def test_multihost_partitions_svd_init():
    # deterministic initializers now partition over ranks across
    # processes; a 2-process grid with one rank per process runs
    # (single-process emulation: process 0 of 2 owns rank index 0)
    sim = cf.simulate_whx(nrow=20, ncol=30, rank=2, seed=1)
    s = cf.SCSet(count=sim["x"])
    out = cf.vb_factorize(s, ranks=[2, 3], initializer="svd2",
                          verbose=0, Itmax=50, _process_count=1,
                          _process_id=0)
    assert out.ranks == [2, 3]


def test_storage_dtype_integer_exact(pallas_interpret):
    """Compressed int16/uint8 X storage is EXACT: counts are integers,
    kernels upcast in registers — results match the float-stored run
    bit-for-bit (dense) / at float tolerance (pallas)."""
    sim = cf.simulate_whx(nrow=24, ncol=30, rank=3, seed=13)
    s = cf.SCSet(count=sim["x"])
    kw = dict(ranks=[2, 3], nrun=2, verbose=0, Itmax=300, seed=2)
    a = cf.vb_factorize(s, **kw)
    b = cf.vb_factorize(s, storage_dtype="int16", **kw)
    np.testing.assert_array_equal(a.measure["lml"], b.measure["lml"])
    for k in range(2):
        np.testing.assert_array_equal(a.basis[k], b.basis[k])
    c = cf.vb_factorize(s, storage_dtype="uint8", backend="pallas",
                        **kw)
    np.testing.assert_allclose(a.measure["lml"], c.measure["lml"],
                               rtol=1e-6)

    with pytest.raises(ValueError, match="integer counts"):
        cf.vb_factorize(cf.SCSet(count=sim["x"] + 0.5), ranks=2,
                        verbose=0, storage_dtype="int16")
    with pytest.raises(ValueError, match="overflow"):
        big = sim["x"].copy()
        big[0, 0] = 300.0
        cf.vb_factorize(cf.SCSet(count=big), ranks=2, verbose=0,
                        storage_dtype="uint8")


def test_storage_dtype_auto_default():
    """storage_dtype='auto' (the driver default):
    integer counts get the compressed layout with results identical
    to the uncompressed run (exact upcast); floats / overflow fall
    back to the full-precision stream instead of erroring."""
    from ccfindr_tpu.utils import auto_storage_dtype

    # dtype-selection unit cases
    assert auto_storage_dtype(np.full((3, 4), 5.0)) == np.int8
    a = np.full((3, 4), 5.0)
    a[0, 0] = 300.0
    assert auto_storage_dtype(a) == np.int16
    a[0, 0] = 40000.0
    assert auto_storage_dtype(a) is None          # beyond int16
    a[0, 0] = 0.5
    assert auto_storage_dtype(a) is None          # not integral
    a[0, 0] = -1.0
    assert auto_storage_dtype(a) is None          # negative

    sim = cf.simulate_whx(nrow=24, ncol=30, rank=3, seed=13)
    s = cf.SCSet(count=sim["x"])
    kw = dict(ranks=[2], nrun=2, verbose=0, Itmax=200, seed=2)
    d = cf.vb_factorize(s, **kw)                  # default: auto
    e = cf.vb_factorize(s, storage_dtype=None, **kw)
    np.testing.assert_array_equal(d.measure["lml"], e.measure["lml"])
    np.testing.assert_array_equal(d.basis[0], e.basis[0])

    # normalized (float) matrix: auto silently keeps f32
    sn = cf.normalize_count(s)
    out = cf.vb_factorize(sn, ranks=[2], nrun=1, verbose=0, Itmax=50)
    assert out.ranks == [2]

    # ML driver shares the default
    f = cf.factorize(s, ranks=[2], nrun=2, verbose=0, Itmax=100,
                     seed=3)
    g = cf.factorize(s, ranks=[2], nrun=2, verbose=0, Itmax=100,
                     seed=3, storage_dtype=None)
    np.testing.assert_array_equal(
        f.measure["likelihood"], g.measure["likelihood"])


def test_svd_init_batched_matches_sequential():
    """Deterministic initializers run under batch_ranks: the batched padded-rank path equals the sequential
    per-rank path, and nrun > 1 collapses to one restart with
    identical results (reference computes nrun identical inits,
    R/bayesian.R:334-335)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    x = (rng.random((40, 60)) < 0.5) * rng.poisson(3.0, (40, 60))
    x = x.astype(np.float64)
    x[x.sum(axis=1) == 0, 0] += 1
    x[0, x.sum(axis=0) == 0] += 1
    for init in ("svd2", "svd"):
        kw = dict(ranks=[2, 3, 4], verbose=0, Itmax=80,
                  dtype=jnp.float64, initializer=init)
        seq = cf.vb_factorize(x, batch_ranks=False, nrun=1, **kw)
        bat = cf.vb_factorize(x, batch_ranks=True, nrun=1, **kw)
        np.testing.assert_allclose(
            bat.measure["lml"].to_numpy(),
            seq.measure["lml"].to_numpy(), rtol=1e-12)
        # nrun > 1 no longer raises; bit-equal to a single restart
        multi = cf.vb_factorize(x, batch_ranks=True, nrun=5, **kw)
        np.testing.assert_array_equal(multi.measure["lml"],
                                      bat.measure["lml"])


def test_svd_init_mesh_batched():
    """svd2 under batch_ranks on a cell-sharded mesh equals the
    single-device batched run."""
    import jax
    import jax.numpy as jnp

    from ccfindr_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(1)
    x = (rng.random((40, 60)) < 0.5) * rng.poisson(3.0, (40, 60))
    x = x.astype(np.float64)
    x[x.sum(axis=1) == 0, 0] += 1
    x[0, x.sum(axis=0) == 0] += 1
    kw = dict(ranks=[2, 3], verbose=0, Itmax=60, dtype=jnp.float64,
              initializer="svd2", batch_ranks=True)
    a = cf.vb_factorize(x, **kw)
    mesh = make_mesh(cells=4, devices=jax.devices()[:4])
    b = cf.vb_factorize(x, mesh=mesh, **kw)
    np.testing.assert_allclose(b.measure["lml"].to_numpy(),
                               a.measure["lml"].to_numpy(),
                               rtol=1e-12)


def test_compact_every_matches_unchunked():
    """Converged-lane compaction (compact_every) re-packs live lanes
    into smaller batches at chunk boundaries.
    The fast on-device path runs the identical math in a different
    XLA fusion context, so recorded evidences may move at roundoff;
    everything must agree to float precision, and the checkpointed
    (host round-trip) variant stays BIT-identical."""
    sim = cf.simulate_whx(nrow=40, ncol=80, rank=4, seed=2)
    s = cf.SCSet(count=sim["x"])
    kw = dict(ranks=[2, 3, 4, 5, 6], nrun=3, verbose=0, Itmax=800,
              seed=4)
    a = cf.vb_factorize(s, **kw)
    b = cf.vb_factorize(s, compact_every=50, **kw)
    np.testing.assert_allclose(b.measure["lml"], a.measure["lml"],
                               rtol=1e-12)
    for k in range(len(a.ranks)):
        np.testing.assert_allclose(b.basis[k], a.basis[k], rtol=1e-10)
        np.testing.assert_allclose(b.coeff[k], a.coeff[k], rtol=1e-10)
    # bit-exact variant: checkpointed chunking (host-carry path),
    # which ALSO compacts
    import tempfile
    c = cf.vb_factorize(s, checkpoint_dir=tempfile.mkdtemp(),
                        checkpoint_every=50, **kw)
    np.testing.assert_array_equal(a.measure["lml"], c.measure["lml"])
    for k in range(len(a.ranks)):
        np.testing.assert_array_equal(a.basis[k], c.basis[k])


def test_f32_f64_stopping_decision_larger_shape():
    """SURVEY §7.3: at a larger (many-partial)
    shape, the f32 production arithmetic must make the same stopping
    decision (within one sweep) and the same rank selection as f64 —
    the precision budget that the compensated ELBO accumulators
    protect at atlas scale."""
    import jax.numpy as jnp

    sim = cf.simulate_whx(nrow=256, ncol=2048, rank=4, aw=0.5,
                          bw=1.0, ah=0.5, bh=1.0, seed=8)
    s = cf.SCSet(count=sim["x"])
    kw = dict(ranks=[3, 4, 5], nrun=1, verbose=0, Itmax=1200, seed=2)
    r64 = cf.vb_factorize(s, dtype=jnp.float64, **kw)
    r32 = cf.vb_factorize(s, dtype=jnp.float32, **kw)
    assert cf.optimal_rank(r64)["ropt"] == 4
    assert cf.optimal_rank(r32)["ropt"] == 4
    # evidences agree to ~1e-2: f32 and f64 runs legitimately stop at
    # slightly different sweeps of a nonconvex iteration (trajectory
    # divergence), which dwarfs pure summation error; the decision
    # outputs (ropt, and the evidence ORDERING across ranks) must
    # still concord
    np.testing.assert_allclose(r32.measure["lml"], r64.measure["lml"],
                               rtol=1e-2)
    assert (np.argsort(r32.measure["lml"].to_numpy()).tolist()
            == np.argsort(r64.measure["lml"].to_numpy()).tolist())
