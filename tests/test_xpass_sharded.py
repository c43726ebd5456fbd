"""The cell-sharded 'pallas' mesh path: the fused X-pass kernel per
shard under shard_map (parallel.sharded.make_fused_sharded), in the
Pallas interpreter on the 8-device CPU mesh.  Parity targets: one
shard is BIT-identical to the single-device kernel loop (identical
reduction orders); four shards agree at float-reduction tolerance.
"""

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import ccfindr_tpu as cf
from ccfindr_tpu.ops import vb as vb_ops
from ccfindr_tpu.ops.pallas import xpass as xk
from ccfindr_tpu.ops.vb import Hyper
from ccfindr_tpu.parallel.sharded import make_fused_sharded

import pytest

KERNEL = xk.VBXPass(interpret=True)


@pytest.fixture(scope="module")
def problem():
    sim = cf.simulate_whx(nrow=24, ncol=512, rank=3, seed=1)
    x = np.asarray(sim["x"], np.float32)
    x = x[:, :x.shape[1] // 8 * 8]          # divisible by the shards
    n, m = x.shape
    key = jax.random.PRNGKey(0)
    hyper = Hyper(*(jnp.asarray(v, jnp.float32) for v in (1.0,) * 4))
    st = vb_ops.vb_init_random(key, n, m, 3, hyper,
                               dtype=jnp.float32)
    return x, st, hyper


def test_cells1_bit_parity_with_single_device(problem):
    """A 1-shard 'cells' mesh runs every reduction in the identical
    order as the single-device kernel: results must be bit-equal."""
    x, st, hyper = problem
    xj = jnp.asarray(x)
    ref = vb_ops.vb_run(xj, st, hyper, itmax=25, tol=1e-6,
                        fused=KERNEL)
    mesh = cf.make_mesh(runs=8, cells=1)
    got = vb_ops.vb_run(xj, st, hyper, itmax=25, tol=1e-6,
                        fused=make_fused_sharded(mesh,
                                                 fused_local=KERNEL))
    assert float(ref.lml) == float(got.lml)
    assert int(ref.n_iter) == int(got.n_iter)
    for f in ("ew", "eh", "lw", "lh", "dw", "dh"):
        np.testing.assert_array_equal(
            np.asarray(getattr(ref.state, f)),
            np.asarray(getattr(got.state, f)), err_msg=f)
    for a, b in zip(ref.hyper, got.hyper):
        assert float(a) == float(b)


def test_four_shards_match_single_device(problem):
    """4 cell shards (psum'd swn and ELBO partials) track the
    single-device run over 30 sweeps.  In float64, so the check sees
    the algebra and not float32 roundoff, which the iteration
    amplifies to ~3e-5 in the evidence by sweep 30."""
    x, _, _ = problem
    n, m = x.shape
    hyper = Hyper(*(jnp.asarray(1.0, jnp.float64),) * 4)
    st = vb_ops.vb_init_random(jax.random.PRNGKey(0), n, m, 3, hyper,
                               dtype=jnp.float64)
    xj = jnp.asarray(x, jnp.float64)
    ref = vb_ops.vb_run(xj, st, hyper, itmax=30, tol=1e-6,
                        fused=KERNEL)
    mesh = cf.make_mesh(runs=2, cells=4)
    xs = jax.device_put(xj, NamedSharding(mesh, P(None, "cells")))
    got = vb_ops.vb_run(xs, st, hyper, itmax=30, tol=1e-6,
                        fused=make_fused_sharded(mesh,
                                                 fused_local=KERNEL))
    assert int(got.n_iter) == int(ref.n_iter)
    np.testing.assert_allclose(float(got.lml), float(ref.lml),
                               rtol=1e-12)
    for f in ("ew", "eh", "lw", "lh", "dw", "dh"):
        np.testing.assert_allclose(
            np.asarray(getattr(got.state, f)),
            np.asarray(getattr(ref.state, f)), rtol=1e-9, atol=1e-12,
            err_msg=f)
    for a, b in zip(got.hyper, ref.hyper):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-10)


def test_vmapped_rank_masks_lane_matches_unbatched(problem):
    """The batched rank sweep's shape: vmap over instances with
    per-instance prefix rank masks — each lane equals its unbatched
    run exactly."""
    x, _, hyper = problem
    n, m = x.shape
    st4 = vb_ops.vb_init_random(jax.random.PRNGKey(3), n, m, 4, hyper,
                                dtype=jnp.float32)
    mesh = cf.make_mesh(runs=2, cells=4)
    xs = jax.device_put(jnp.asarray(x),
                        NamedSharding(mesh, P(None, "cells")))
    fused = make_fused_sharded(mesh, fused_local=KERNEL)
    rmask = jnp.asarray([[1., 1., 1., 0.], [1., 1., 1., 1.]],
                        jnp.float32)
    rtrue = jnp.asarray([3., 4.], jnp.float32)
    sts = jax.tree.map(lambda a: jnp.stack([a, a]), st4)
    outb = jax.vmap(lambda s, rm, rt: vb_ops.vb_run(
        xs, s, hyper, itmax=20, tol=1e-6, rank_mask=rm, r_true=rt,
        fused=fused))(sts, rmask, rtrue)
    for lane in range(2):
        single = vb_ops.vb_run(xs, st4, hyper, itmax=20, tol=1e-6,
                               rank_mask=rmask[lane],
                               r_true=rtrue[lane], fused=fused)
        assert float(single.lml) == float(outb.lml[lane]), lane
        np.testing.assert_array_equal(
            np.asarray(outb.state.ew[lane]),
            np.asarray(single.state.ew))


def test_driver_mesh_elbo_every_and_bf16(pallas_interpret):
    """elbo_every and precision='bf16' reach the cell-sharded mesh
    path: conservative stopping, evidences tracking the per-sweep run,
    and the mesh run matching one device."""
    sim = cf.simulate_whx(nrow=20, ncol=33, rank=3, seed=44)
    s = cf.SCSet(count=sim["x"])
    mesh = cf.make_mesh(runs=2, cells=4)
    kw = dict(ranks=[2, 3], nrun=2, verbose=0, Itmax=300, seed=9,
              backend="pallas")
    a = cf.vb_factorize(s, mesh=mesh, **kw)
    one = cf.vb_factorize(s, **kw)
    np.testing.assert_allclose(a.measure["lml"], one.measure["lml"],
                               rtol=1e-6)
    b = cf.vb_factorize(s, mesh=mesh, elbo_every=5, **kw)
    np.testing.assert_allclose(a.measure["lml"], b.measure["lml"],
                               rtol=1e-3)
    c = cf.vb_factorize(s, mesh=mesh, precision="bf16", elbo_every=5,
                        **kw)
    assert np.isfinite(c.measure["lml"]).all()
    np.testing.assert_allclose(c.measure["lml"], a.measure["lml"],
                               rtol=0.05)
