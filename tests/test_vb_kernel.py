"""Golden tests: JAX VB kernel vs the NumPy float64 reference oracle,
plus statistical oracle properties (ELBO monotonicity, gauge behavior).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ccfindr_tpu.ops import reference_impl as ref
from ccfindr_tpu.ops import vb as vb_ops
from ccfindr_tpu.ops.vb import Hyper, VBState
from ccfindr_tpu.simulate import simulate_whx


def _random_problem(n=23, m=17, r=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.poisson(2.0, size=(n, m)).astype(np.float64)
    x[x.sum(axis=1) == 0, 0] += 1  # no empty rows
    x[0, x.sum(axis=0) == 0] += 1
    lw = rng.gamma(1.0, 1.0, size=(n, r))
    lh = rng.gamma(1.0, 1.0, size=(r, m))
    return x, lw, lh


def _state(lw, lh):
    return VBState(ew=jnp.asarray(lw), eh=jnp.asarray(lh),
                   lw=jnp.asarray(lw), lh=jnp.asarray(lh),
                   dw=jnp.zeros_like(jnp.asarray(lw)),
                   dh=jnp.zeros_like(jnp.asarray(lh)),
                   lkh=jnp.asarray(-np.inf))


def test_vb_sweep_matches_oracle():
    x, lw, lh = _random_problem()
    hyper = Hyper(aw=jnp.asarray(1.0), bw=jnp.asarray(1.0),
                  ah=jnp.asarray(1.0), bh=jnp.asarray(1.0))
    eps = np.finfo(np.float64).eps
    lgx = jnp.sum(jax.scipy.special.gammaln(jnp.asarray(x) + 1.0))

    out = vb_ops.vb_sweep(jnp.asarray(x), _state(lw, lh), hyper,
                          eps, lgx)
    exp = ref.vb_sweep_np(x, lw.copy(), lh.copy(), lw.copy(), lh.copy(),
                          1.0, 1.0, 1.0, 1.0)
    for name in ("ew", "eh", "lw", "lh", "dw", "dh"):
        np.testing.assert_allclose(np.asarray(getattr(out, name)),
                                   exp[name], rtol=1e-10,
                                   err_msg=name)
    np.testing.assert_allclose(float(out.lkh), exp["lkh"], rtol=1e-10)


def test_vb_sweep_multiple_steps_match():
    x, lw, lh = _random_problem(n=31, m=29, r=3, seed=1)
    hyper = Hyper(aw=jnp.asarray(0.7), bw=jnp.asarray(1.3),
                  ah=jnp.asarray(0.9), bh=jnp.asarray(0.8))
    eps = np.finfo(np.float64).eps
    lgx = jnp.sum(jax.scipy.special.gammaln(jnp.asarray(x) + 1.0))

    st = _state(lw, lh)
    np_st = dict(lw=lw.copy(), lh=lh.copy(), ew=lw.copy(), eh=lh.copy())
    for _ in range(10):
        st = vb_ops.vb_sweep(jnp.asarray(x), st, hyper, eps, lgx)
        np_out = ref.vb_sweep_np(x, np_st["lw"], np_st["lh"],
                                 np_st["ew"], np_st["eh"],
                                 0.7, 1.3, 0.9, 0.8)
        np_st = {k: np_out[k] for k in ("lw", "lh", "ew", "eh")}
    np.testing.assert_allclose(np.asarray(st.ew), np_st["ew"], rtol=1e-8)
    np.testing.assert_allclose(float(st.lkh), np_out["lkh"], rtol=1e-9)


def test_hyper_update_matches_oracle():
    x, lw, lh = _random_problem(seed=3)
    # run a few sweeps to get a realistic state
    st = _state(lw, lh)
    hyper = Hyper(*(jnp.asarray(v) for v in (1.0, 1.0, 1.0, 1.0)))
    eps = np.finfo(np.float64).eps
    lgx = jnp.sum(jax.scipy.special.gammaln(jnp.asarray(x) + 1.0))
    for _ in range(5):
        st = vb_ops.vb_sweep(jnp.asarray(x), st, hyper, eps, lgx)

    new, failed = vb_ops.hyper_update((True,) * 4, st, hyper)
    exp = ref.hyper_update_np(
        (True,) * 4, np.asarray(st.lw), np.asarray(st.lh),
        np.asarray(st.ew), np.asarray(st.eh), 1.0, 1.0, 1.0, 1.0)
    assert not bool(failed)
    np.testing.assert_allclose(
        [float(new.aw), float(new.bw), float(new.ah), float(new.bh)],
        exp, rtol=1e-7)


@pytest.mark.parametrize("mask", [(True, True, True, True),
                                  (False, True, False, True),
                                  (True, False, True, False),
                                  (False, False, False, False)])
def test_hyper_update_mask(mask):
    x, lw, lh = _random_problem(seed=4)
    st = _state(lw, lh)
    hyper = Hyper(*(jnp.asarray(v) for v in (1.1, 0.9, 1.2, 0.8)))
    eps = np.finfo(np.float64).eps
    lgx = jnp.sum(jax.scipy.special.gammaln(jnp.asarray(x) + 1.0))
    st = vb_ops.vb_sweep(jnp.asarray(x), st, hyper, eps, lgx)

    new, _ = vb_ops.hyper_update(mask, st, hyper)
    exp = ref.hyper_update_np(mask, np.asarray(st.lw), np.asarray(st.lh),
                              np.asarray(st.ew), np.asarray(st.eh),
                              1.1, 0.9, 1.2, 0.8)
    np.testing.assert_allclose(
        [float(new.aw), float(new.bw), float(new.ah), float(new.bh)],
        exp, rtol=1e-7)


def test_elbo_increases_over_sweeps():
    sim = simulate_whx(40, 60, 3, seed=5)
    x = jnp.asarray(sim["x"])
    key = jax.random.PRNGKey(0)
    hyper = Hyper(*(jnp.asarray(v) for v in (1.0, 1.0, 1.0, 1.0)))
    st = vb_ops.vb_init_random(key, x.shape[0], x.shape[1], 3, hyper,
                               dtype=jnp.float64)
    eps = np.finfo(np.float64).eps
    lgx = jnp.sum(jax.scipy.special.gammaln(x + 1.0))
    prev = -np.inf
    for i in range(50):
        st = vb_ops.vb_sweep(x, st, hyper, eps, lgx)
        cur = float(st.lkh)
        if i > 2:
            assert cur >= prev - 1e-9, f"ELBO decreased at sweep {i}"
        prev = cur


def test_vb_run_converges_and_matches_loop():
    """vb_run (while_loop) == manual python loop with same cadence."""
    sim = simulate_whx(30, 40, 3, seed=7)
    x = jnp.asarray(sim["x"])
    key = jax.random.PRNGKey(1)
    h0 = Hyper(*(jnp.asarray(v) for v in (1.0, 1.0, 1.0, 1.0)))
    st0 = vb_ops.vb_init_random(key, x.shape[0], x.shape[1], 3, h0,
                                dtype=jnp.float64)
    res = vb_ops.vb_run(x, st0, h0, itmax=500, tol=1e-5,
                        hyper_mask=(True,) * 4, n0=10, dn=1)
    assert int(res.n_iter) < 500, "did not converge"

    # manual replication
    eps = np.finfo(np.float64).eps
    lgx = jnp.sum(jax.scipy.special.gammaln(x + 1.0))
    st, hyper, lk0 = st0, h0, 0.0
    for it in range(1, 501):
        st = vb_ops.vb_sweep(x, st, hyper, eps, lgx)
        if it > 10 and it % 1 == 0:
            hyper, _ = vb_ops.hyper_update((True,) * 4, st, hyper)
        lkh = float(st.lkh)
        if it > 1 and it > 10 and lkh >= lk0 and abs(1 - lkh / lk0) < 1e-5:
            break
        lk0 = lkh
    assert it == int(res.n_iter)
    np.testing.assert_allclose(float(res.lml), lk0, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(res.state.ew),
                               np.asarray(st.ew), rtol=1e-9)


def test_vb_run_vmap_batches_independently():
    sim = simulate_whx(25, 35, 3, seed=9)
    x = jnp.asarray(sim["x"])
    keys = jax.random.split(jax.random.PRNGKey(2), 3)
    h0 = Hyper(*(jnp.asarray(v) for v in (1.0, 1.0, 1.0, 1.0)))
    states = jax.vmap(lambda k: vb_ops.vb_init_random(
        k, x.shape[0], x.shape[1], 3, h0, dtype=jnp.float64))(keys)
    hypers = Hyper(*(jnp.full((3,), v, jnp.float64)
                     for v in (1.0, 1.0, 1.0, 1.0)))
    batched = jax.vmap(lambda s, h: vb_ops.vb_run(
        x, s, h, itmax=300, tol=1e-5, hyper_mask=(True,) * 4))
    out = batched(states, hypers)

    for i in range(3):
        st_i = jax.tree.map(lambda a: a[i], states)
        hy_i = Hyper(*(a[i] for a in hypers))
        solo = vb_ops.vb_run(x, st_i, hy_i, itmax=300, tol=1e-5,
                             hyper_mask=(True,) * 4)
        assert int(solo.n_iter) == int(out.n_iter[i])
        np.testing.assert_allclose(float(solo.lml), float(out.lml[i]),
                                   rtol=1e-10)


def test_trigamma_matches_polygamma():
    # trigamma replaces jax polygamma(1,.) (Hurwitz-zeta based) inside
    # hyper_update's Newton chain; must agree to near machine epsilon
    from jax.scipy.special import polygamma

    x = jnp.asarray(np.concatenate([
        np.logspace(-3, 6, 500), np.linspace(0.3, 30, 500)]))
    ref = np.asarray(polygamma(1, x))
    got = np.asarray(vb_ops.trigamma(x))
    np.testing.assert_allclose(got, ref, rtol=2e-14)
    got32 = np.asarray(vb_ops.trigamma(x.astype(jnp.float32)),
                       np.float64)
    np.testing.assert_allclose(got32, ref, rtol=5e-7)


def test_positive_step_closed_form_bit_exact():
    # the closed-form halving must equal the reference's iterated
    # while-halving (R/bayesian.R:28-35) bit-for-bit
    rng = np.random.default_rng(5)
    a0 = jnp.asarray(rng.gamma(1.0, 2.0, 20000) + 1e-6)
    d = jnp.asarray(rng.standard_normal(20000)
                    * np.exp(rng.uniform(-10, 500, 20000)))

    def reference_halving(a0v, dv):
        out = np.asarray(dv).copy()
        a = np.asarray(a0v)
        for i in range(len(out)):
            while a[i] - out[i] <= 0:
                out[i] /= 2.0
        return out

    def closed_form(a0, d):
        k = jnp.maximum(jnp.floor(jnp.log2(d / a0)) + 1.0, 0.0)
        k = jnp.where((d > 0) & jnp.isfinite(d), k, 0.0)
        ki = jnp.clip(k, 0.0, 2100.0).astype(jnp.int32)
        d2 = jnp.ldexp(d, -ki)
        d2 = jnp.where(a0 - d2 <= 0, d2 * 0.5, d2)
        over = (ki >= 1) & (d > 0) & (a0 - d2 * 2.0 > 0)
        return jnp.where(over, d2 * 2.0, d2)

    ref = reference_halving(a0, d)
    got = np.asarray(closed_form(a0, d))
    assert (ref == got).all()
