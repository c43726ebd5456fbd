"""The deferred-ELBO convergence loop (ops.vb.vb_run(fused=...)) over
the fused X-pass kernel, in the Pallas interpreter, against the same
loop over XLA's fused_dense — backend='pallas' against
backend='dense_fused'.

In float64 the only expected differences are the summation orders of
the kernel's partial buffers — ~1e-12 relative per sweep.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ccfindr_tpu.ops import vb as vb_ops
from ccfindr_tpu.ops.pallas import xpass as xk
from ccfindr_tpu.ops.vb import Hyper, VBState

KERNEL = xk.VBXPass(interpret=True)


def _planted(n, m, r, seed=0):
    rng = np.random.default_rng(seed)
    wf = rng.gamma(0.8, 1.0, (n, r))
    hf = rng.gamma(0.8, 1.0, (r, m))
    x = rng.poisson(wf @ hf * (2.0 * n * m / (wf @ hf).sum()))
    return x.astype(np.float64)


def _init(n, m, r, seed=1):
    rng = np.random.default_rng(seed)
    w = jnp.asarray(rng.gamma(1.0, 1.0, (n, r)))
    h = jnp.asarray(rng.gamma(1.0, 1.0, (r, m)))
    return VBState(ew=w, eh=h, lw=w, lh=h, dw=jnp.zeros_like(w),
                   dh=jnp.zeros_like(h), lkh=jnp.asarray(-jnp.inf,
                                                         w.dtype))


HY = Hyper(*(jnp.asarray(1.0, jnp.float64),) * 4)


def _run_pair(x, st, **kw):
    out_d = vb_ops.vb_run(x, st, HY, fused=vb_ops.fused_dense, **kw)
    out_k = vb_ops.vb_run(xk.pad_matrix(x), st, HY, fused=KERNEL, **kw)
    return out_d, out_k


def _assert_close(out_d, out_k, rtol=1e-9):
    assert int(out_d.n_iter) == int(out_k.n_iter)
    np.testing.assert_allclose(float(out_k.lml), float(out_d.lml),
                               rtol=rtol)
    for f in ("ew", "eh", "lw", "lh", "dw", "dh"):
        np.testing.assert_allclose(
            np.asarray(getattr(out_k.state, f)),
            np.asarray(getattr(out_d.state, f)), rtol=1e-7,
            err_msg=f)
    for f in ("aw", "bw", "ah", "bh"):
        np.testing.assert_allclose(
            float(getattr(out_k.hyper, f)),
            float(getattr(out_d.hyper, f)), rtol=1e-8, err_msg=f)


def test_single_sweep_matches_reference_math():
    """One kernel sweep's posterior and ELBO against the float64
    reference sweep (ops/reference_impl.py)."""
    from ccfindr_tpu.ops import reference_impl as ref

    n, m, r = 24, 256, 5
    x = jnp.asarray(_planted(n, m, r))
    st = _init(n, m, r)
    fudge = jnp.asarray(np.finfo(np.float64).eps)
    lgx = jnp.sum(jax.scipy.special.gammaln(x + 1.0))
    swn, shn, _ = KERNEL(x, st.lw, st.lh)
    new, pending = vb_ops.posterior_update(st.lw * swn, st.lh * shn,
                                           st, HY, fudge, lgx)
    _, _, dterm = KERNEL(x, new.lw, new.lh)
    want = ref.vb_sweep_np(np.asarray(x), np.asarray(st.lw),
                           np.asarray(st.lh), np.asarray(st.ew),
                           np.asarray(st.eh), 1.0, 1.0, 1.0, 1.0)
    for f in ("ew", "eh", "lw", "lh", "dw", "dh"):
        np.testing.assert_allclose(np.asarray(getattr(new, f)), want[f],
                                   rtol=1e-10, err_msg=f)
    np.testing.assert_allclose(float((pending + dterm) / (n * m)),
                               want["lkh"], rtol=1e-10)


@pytest.mark.parametrize("itmax", [3, 60])
def test_vb_run_matches_dense_fused(itmax):
    x = jnp.asarray(_planted(24, 256, 4))
    _assert_close(*_run_pair(x, _init(24, 256, 4), itmax=itmax,
                             tol=1e-6))


def test_vb_run_converges_same_sweep():
    """Full convergence on a planted problem: same stopping sweep and
    the same evidence as the XLA loop."""
    x = jnp.asarray(_planted(32, 384, 3, seed=3))
    out_d, out_k = _run_pair(x, _init(32, 384, 3), itmax=500, tol=1e-6)
    assert int(out_k.n_iter) < 500
    _assert_close(out_d, out_k)


def test_vb_run_rank_mask():
    """Batched-rank prefix masks: a padded instance equals the XLA
    loop's."""
    n, m, r_pad, r_true = 24, 256, 6, 4
    x = jnp.asarray(_planted(n, m, r_true, seed=5))
    rmask = jnp.asarray((np.arange(r_pad) < r_true).astype(np.float64))
    _assert_close(*_run_pair(x, _init(n, m, r_pad, seed=2), itmax=40,
                             tol=1e-6, rank_mask=rmask,
                             r_true=jnp.asarray(float(r_true))))


def test_vb_run_cell_padding():
    """Mesh cell padding (m_true < array extent) matches the XLA
    loop."""
    n, m_true, m_pad, r = 24, 200, 256, 3
    x = jnp.asarray(_planted(n, m_true, r, seed=7))
    x_arr = jnp.pad(x, ((0, 0), (0, m_pad - m_true)))
    cmask = jnp.asarray((np.arange(m_pad) < m_true
                         ).astype(np.float64))[None, :]
    _assert_close(*_run_pair(x_arr, _init(n, m_pad, r, seed=4),
                             itmax=40, tol=1e-6, cell_mask=cmask,
                             m_true=m_true))


def test_vb_run_resume_bit_exact():
    """it0/lk0_init chunked resume reproduces the uninterrupted run
    exactly (the checkpointing contract of the chunked driver): the
    kernel's cross-block sums run in a fixed order."""
    n, m, r = 24, 256, 3
    xp = xk.pad_matrix(jnp.asarray(_planted(n, m, r, seed=9)))
    st = _init(n, m, r, seed=5)
    kw = dict(tol=0.0, fused=KERNEL)
    full = vb_ops.vb_run(xp, st, HY, itmax=30, **kw)
    part = vb_ops.vb_run(xp, st, HY, itmax=12, **kw)
    resumed = vb_ops.vb_run(xp, part.state, part.hyper, itmax=30,
                            it0=13, lk0_init=part.lml, **kw)
    assert int(full.n_iter) == 30
    for f in ("ew", "eh", "lw", "lh"):
        np.testing.assert_array_equal(
            np.asarray(getattr(resumed.state, f)),
            np.asarray(getattr(full.state, f)), err_msg=f)
    np.testing.assert_array_equal(float(resumed.lml), float(full.lml))


def test_vb_run_vmap():
    """vmapped instances equal per-instance runs (batched driver)."""
    n, m, r = 16, 256, 3
    xp = xk.pad_matrix(jnp.asarray(_planted(n, m, r, seed=11)))
    sts = [_init(n, m, r, seed=s) for s in (1, 2)]
    batch_st = jax.tree.map(lambda *a: jnp.stack(a), *sts)
    batch_hy = Hyper(*(jnp.full((2,), 1.0, jnp.float64),) * 4)
    outs = jax.vmap(lambda s, h: vb_ops.vb_run(
        xp, s, h, itmax=20, tol=1e-6, fused=KERNEL))(batch_st, batch_hy)
    for b, st in enumerate(sts):
        solo = vb_ops.vb_run(xp, st, HY, itmax=20, tol=1e-6,
                             fused=KERNEL)
        np.testing.assert_allclose(float(outs.lml[b]),
                                   float(solo.lml), rtol=1e-12)
        np.testing.assert_allclose(np.asarray(outs.state.ew[b]),
                                   np.asarray(solo.state.ew),
                                   rtol=1e-12)


def test_vb_run_int_storage():
    """Integer X storage: same results as float X (values equal)."""
    n, m, r = 16, 256, 3
    x = _planted(n, m, r, seed=13)
    st = _init(n, m, r, seed=6)
    of = vb_ops.vb_run(jnp.asarray(x), st, HY, itmax=15, tol=1e-6,
                       fused=KERNEL)
    oi = vb_ops.vb_run(jnp.asarray(x.astype(np.int16)), st, HY,
                       itmax=15, tol=1e-6, fused=KERNEL)
    np.testing.assert_allclose(float(oi.lml), float(of.lml),
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray(oi.state.ew),
                               np.asarray(of.state.ew), rtol=1e-12)


def test_vb_run_elbo_every():
    """elbo_every=k: conservative stopping (never earlier), final
    evidence within the convergence tolerance of the per-sweep rule."""
    n, m, r = 32, 384, 3
    xp = xk.pad_matrix(jnp.asarray(_planted(n, m, r, seed=21)))
    st = _init(n, m, r, seed=8)
    kw = dict(itmax=800, tol=1e-6, fused=KERNEL)
    o1 = vb_ops.vb_run(xp, st, HY, **kw)
    o4 = vb_ops.vb_run(xp, st, HY, elbo_every=4, **kw)
    assert int(o1.n_iter) < 800 and int(o4.n_iter) < 800
    assert int(o4.n_iter) >= int(o1.n_iter)
    # the cadence run stops later, so its ELBO is >= (monotone) and
    # within a few tolerances of the per-sweep rule
    assert float(o4.lml) >= float(o1.lml) - 1e-12
    np.testing.assert_allclose(float(o4.lml), float(o1.lml), rtol=5e-5)
    # k=1 stays bit-identical to the default
    o1b = vb_ops.vb_run(xp, st, HY, elbo_every=1, **kw)
    np.testing.assert_array_equal(np.asarray(o1b.state.ew),
                                  np.asarray(o1.state.ew))


def test_driver_elbo_every(pallas_interpret):
    """vb_factorize(elbo_every=...) runs on the pallas backend and
    rejects other backends."""
    import ccfindr_tpu as cf

    sim = cf.simulate_whx(nrow=25, ncol=40, rank=3, seed=31)
    s = cf.SCSet(count=sim["x"])
    a = cf.vb_factorize(s, ranks=[3], nrun=2, verbose=0, Itmax=400,
                        seed=4, backend="pallas")
    b = cf.vb_factorize(s, ranks=[3], nrun=2, verbose=0, Itmax=400,
                        seed=4, backend="pallas", elbo_every=5)
    assert b.measure["lml"][0] >= a.measure["lml"][0] - 1e-12
    np.testing.assert_allclose(b.measure["lml"][0],
                               a.measure["lml"][0], rtol=1e-3)
    with pytest.raises(ValueError, match="elbo_every"):
        cf.vb_factorize(s, ranks=[3], nrun=1, verbose=0,
                        backend="dense", elbo_every=5)


def test_vb_run_precision_bf16():
    """precision='bf16' (bf16 GEMM operands, f32 accumulation) stays
    within ~1e-3 relative of the full-precision fixed point and yields
    the same hard clustering."""
    n, m, r = 24, 40, 3
    xp = xk.pad_matrix(jnp.asarray(_planted(n, m, r)))
    st = _init(n, m, r)
    kw = dict(itmax=30, tol=1e-6)
    out = vb_ops.vb_run(xp, st, HY, fused=KERNEL, **kw)
    out_b = vb_ops.vb_run(xp, st, HY, **kw,
                          fused=xk.VBXPass("bf16", interpret=True))
    np.testing.assert_allclose(float(out_b.lml), float(out.lml),
                               rtol=5e-3)
    np.testing.assert_allclose(np.asarray(out_b.state.eh),
                               np.asarray(out.state.eh),
                               rtol=0.25, atol=1e-2)
    assert (np.argmax(np.asarray(out_b.state.eh), axis=0)
            == np.argmax(np.asarray(out.state.eh), axis=0)).all()


def test_driver_precision_bf16(pallas_interpret):
    """vb_factorize(precision='bf16') runs on the pallas backend,
    matches f32 rank selection, and rejects other backends."""
    import ccfindr_tpu as cf

    sim = cf.simulate_whx(nrow=25, ncol=40, rank=3, seed=31)
    s = cf.SCSet(count=sim["x"])
    a = cf.vb_factorize(s, ranks=[3], nrun=2, verbose=0, Itmax=300,
                        seed=4, backend="pallas")
    b = cf.vb_factorize(s, ranks=[3], nrun=2, verbose=0, Itmax=300,
                        seed=4, backend="pallas", precision="bf16")
    # convergence-point (not per-sweep) comparison, and best-of-nrun
    # selection may pick a different restart under the bf16
    # perturbation — tolerance is necessarily loose
    np.testing.assert_allclose(b.measure["lml"][0],
                               a.measure["lml"][0], rtol=5e-2)
    with pytest.raises(ValueError, match="precision"):
        cf.vb_factorize(s, ranks=[3], nrun=1, verbose=0,
                        backend="dense", precision="bf16")


def test_driver_pallas_matches_dense_fused(pallas_interpret):
    """The driver's 'pallas' backend (kernel in the interpreter) and
    'dense_fused' select the same rank with matching evidences."""
    import ccfindr_tpu as cf

    sim = cf.simulate_whx(nrow=30, ncol=45, rank=3, seed=12)
    s = cf.SCSet(count=sim["x"])
    kw = dict(ranks=[2, 3, 4], nrun=2, verbose=0, Itmax=300, seed=2)
    a = cf.vb_factorize(s, backend="pallas", **kw)
    b = cf.vb_factorize(s, backend="dense_fused", **kw)
    np.testing.assert_allclose(a.measure["lml"], b.measure["lml"],
                               rtol=1e-8)
    assert cf.optimal_rank(a)["ropt"] == cf.optimal_rank(b)["ropt"]
