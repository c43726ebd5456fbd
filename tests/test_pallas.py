"""The fused X-pass GPU kernel (ops/pallas/xpass.py) against the
float64 reference math, run in the Pallas interpreter on the CPU —
the rebuild's analog of the reference's useC=TRUE/FALSE pair — plus
the deferred-ELBO loop it plugs into.  The compiled kernel's own
checks are the ``gpu``-marked tests (and chip_smoke.py)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ccfindr_tpu.ops import reference_impl as ref
from ccfindr_tpu.ops import vb as vb_ops
from ccfindr_tpu.ops.pallas import xpass as xk

SHAPES = [(100, 300, 3), (257, 1000, 16), (64, 129, 20)]
X_DTYPES = [np.int8, np.int16, np.float32]
# f32: float32 accumulation over up to 1000 terms, no TF32;
# bf16: operands rounded to 8 mantissa bits (relative 2^-9 each)
TOL = {"f32": 2e-5, "bf16": 1e-2}


def _problem(n, m, r, seed=0, x_dtype=np.float64, f_dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.poisson(2.0, size=(n, m)).astype(x_dtype)
    lw = rng.gamma(1.0, 1.0, size=(n, r)).astype(f_dtype)
    lh = rng.gamma(1.0, 1.0, size=(r, m)).astype(f_dtype)
    return x, lw, lh


def _rel(got, want):
    got = np.asarray(got, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("x_dtype", X_DTYPES,
                         ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_xpass_matches_reference(shape, x_dtype, precision):
    """swn, shn and sum x*log(wth) on ragged shapes, every X storage
    dtype and both precisions, against the float64 oracle."""
    n, m, r = shape
    x, lw, lh = _problem(n, m, r, seed=n + m, x_dtype=x_dtype)
    swn, shn, xlog = xk.xpass(jnp.asarray(x), jnp.asarray(lw),
                              jnp.asarray(lh), precision=precision,
                              interpret=True)
    assert swn.shape == (n, r) and shn.shape == (r, m)
    want = ref.xpass_np(x, lw, lh, block_rows=64)
    tol = TOL[precision]
    assert _rel(swn, want[0]) < tol
    assert _rel(shn, want[1]) < tol
    assert abs(float(xlog) - want[2]) / abs(want[2]) < tol


def test_xpass_float64_matches_fused_dense():
    """float64 factors (interpret mode only) agree with the XLA fused
    backend to float64 roundoff, dterm fold included."""
    x, lw, lh = _problem(40, 70, 5, seed=5, f_dtype=np.float64)
    args = (jnp.asarray(x), jnp.asarray(lw), jnp.asarray(lh))
    got = xk.VBXPass(interpret=True)(*args)
    want = vb_ops.fused_dense(*args)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-12)


def test_xpass_padding_invariance():
    """Pre-padded X (zeros beyond the true extent, any amount) gives
    identical results — the driver pads X once per factorization."""
    n, m, r = 20, 40, 4
    x, lw, lh = _problem(n, m, r, seed=1, f_dtype=np.float64)
    xj, lwj, lhj = jnp.asarray(x), jnp.asarray(lw), jnp.asarray(lh)
    out1 = xk.xpass(xj, lwj, lhj, interpret=True)
    for xp in (xk.pad_matrix(xj), jnp.pad(xj, ((0, 13), (0, 300)))):
        out2 = xk.xpass(xp, lwj, lhj, interpret=True)
        for a, b in zip(out1, out2):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-13)


def test_xpass_vmapped_rank_masks():
    """The batched rank sweep's shape: vmapped lanes padded to rmax,
    the padded components pinned at fudge (as vb_run's rank mask
    does), equal each lane's unpadded kernel call."""
    n, m, rmax = 48, 200, 6
    ranks = [2, 4, 6]
    x, _, _ = _problem(n, m, 1, seed=2)
    rng = np.random.default_rng(3)
    fudge = np.finfo(np.float64).eps
    lws, lhs = [], []
    for r in ranks:
        lw = np.full((n, rmax), fudge)
        lh = np.full((rmax, m), fudge)
        lw[:, :r] = rng.gamma(1.0, 1.0, (n, r))
        lh[:r] = rng.gamma(1.0, 1.0, (r, m))
        lws.append(lw)
        lhs.append(lh)
    xj = jnp.asarray(x)
    outs = jax.vmap(lambda a, b: xk.xpass(xj, a, b, interpret=True))(
        jnp.asarray(np.stack(lws)), jnp.asarray(np.stack(lhs)))
    for lane, r in enumerate(ranks):
        swn, shn, xlog = xk.xpass(xj, jnp.asarray(lws[lane][:, :r]),
                                  jnp.asarray(lhs[lane][:r]),
                                  interpret=True)
        np.testing.assert_allclose(np.asarray(outs[0][lane][:, :r]),
                                   np.asarray(swn), rtol=1e-12)
        np.testing.assert_allclose(np.asarray(outs[1][lane][:r]),
                                   np.asarray(shn), rtol=1e-12)
        np.testing.assert_allclose(float(outs[2][lane]), float(xlog),
                                   rtol=1e-12)


def test_xpass_elbo_flag_and_output_subsets():
    """do_elbo=0 skips the log term (xlog = 0) without touching the
    suffstats; the ML phases' output subsets equal the full call."""
    x, lw, lh = _problem(30, 50, 3, seed=4, f_dtype=np.float64)
    args = (jnp.asarray(x), jnp.asarray(lw), jnp.asarray(lh))
    full = xk.xpass(*args, interpret=True)
    off = xk.xpass(*args, do_elbo=0.0, interpret=True)
    on = xk.xpass(*args, do_elbo=1.0, interpret=True)
    assert float(off[2]) == 0.0
    assert float(on[2]) == float(full[2])
    for a, b in zip(off[:2], full[:2]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    ml = xk.MLXPass(interpret=True)
    hn, xlw = ml.h(*args)
    np.testing.assert_array_equal(np.asarray(hn), np.asarray(full[1]))
    assert float(xlw) == float(full[2])
    np.testing.assert_array_equal(np.asarray(ml.w(*args)),
                                  np.asarray(full[0]))


def test_xpass_compensated_log_sum(monkeypatch):
    """The log term accumulates in float32 across many gene tiles of
    one block (one chunk): it must track the float64 sum at float32
    roundoff level."""
    monkeypatch.setattr(xk, "_MIN_BLOCKS", 1)   # one block, 256 tiles
    n, m, r = 2048, 256, 4
    rng = np.random.default_rng(0)
    x = rng.poisson(20.0, size=(n, m)).astype(np.float32)
    lw = rng.gamma(4.0, 1.0, size=(n, r)).astype(np.float32)
    lh = rng.gamma(4.0, 1.0, size=(r, m)).astype(np.float32)
    _, _, xlog = xk.xpass(jnp.asarray(x), jnp.asarray(lw),
                          jnp.asarray(lh), want_swn=False,
                          want_shn=False, interpret=True)
    want = ref.xpass_np(x, lw, lh)[2]
    assert abs(float(xlog) - want) / abs(want) < 3e-7


@pytest.mark.parametrize("r,rp", [(1, 16), (3, 16), (16, 16), (17, 32),
                                  (20, 32), (33, 64)])
def test_rank_pad(r, rp):
    """Ranks pad to a power of two, at least the tensor cores' 16."""
    assert xk.rank_pad(r) == rp


@pytest.mark.parametrize("n_tiles,n_ct,rp,want", [
    (128, 128, 16, (32, 16)),     # 4096 x 8192, r=16
    (640, 1568, 32, (28, 10)),    # the 20480 x 100352 atlas, r=20
    (9, 2, 16, (2, 9)),           # too small to fill: one block a tile
    (7, 40, 16, (40, 7)),         # prime gene-tile count
])
def test_grid(n_tiles, n_ct, rp, want):
    """Groups and chunks divide the tile counts evenly (one static trip
    count per block), give enough blocks to fill the card, and among
    those keep the partial buffers smallest."""
    g, c = xk._grid(n_tiles, n_ct, rp, xk.BN, xk.BM)
    assert (g, c) == want
    assert n_ct % g == 0 and n_tiles % c == 0
    assert g * c >= min(xk._MIN_BLOCKS, n_ct * n_tiles)


def test_xpass_refuses_other_platforms():
    """Without interpret mode the kernel runs on a GPU only: on the CPU
    it raises, naming the platform, and so does backend='pallas'."""
    import ccfindr_tpu as cf

    x, lw, lh = _problem(16, 20, 2, seed=6)
    with pytest.raises(RuntimeError, match="'cpu'"):
        xk.xpass(jnp.asarray(x), jnp.asarray(lw), jnp.asarray(lh))
    sim = cf.simulate_whx(nrow=12, ncol=15, rank=2, seed=1)
    for call in (cf.vb_factorize, cf.factorize):
        with pytest.raises(RuntimeError, match="GPU"):
            call(cf.SCSet(count=sim["x"]), ranks=[2], nrun=1,
                 verbose=0, Itmax=5, backend="pallas")


def test_xpass_refuses_float64_on_gpu(monkeypatch):
    """float64 factors are an interpret-mode (test) feature: on the GPU
    the wrapper raises instead of silently switching paths."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    x, lw, lh = _problem(16, 20, 2, seed=7, f_dtype=np.float64)
    with pytest.raises(TypeError, match="float64"):
        xk.xpass(jnp.asarray(x), jnp.asarray(lw), jnp.asarray(lh))


@pytest.mark.gpu
def test_xpass_compiled_on_gpu(gpu):
    """The compiled kernel at a real width (4096 x 8192, r=16, int8 X)
    against the float64 oracle."""
    n, m, r = 4096, 8192, 16
    x, lw, lh = _problem(n, m, r, seed=8, x_dtype=np.int8)
    swn, shn, xlog = xk.xpass(jnp.asarray(x), jnp.asarray(lw),
                              jnp.asarray(lh))
    want = ref.xpass_np(x, lw, lh)
    assert _rel(swn, want[0]) < 1e-4
    assert _rel(shn, want[1]) < 1e-4
    assert abs(float(xlog) - want[2]) / abs(want[2]) < 1e-5


def test_vb_run_fused_matches_eager_exactly():
    """The deferred-ELBO loop reproduces the eager two-pass loop
    bit-for-bit when both use the same (dense, HIGHEST) GEMMs:
    same n_iter, lml, hyper, and final state."""
    from ccfindr_tpu.ops.vb import Hyper

    n, m, r = 40, 60, 4
    rng = np.random.default_rng(7)
    w0 = rng.gamma(2.0, 1.0, (n, r))
    h0 = rng.gamma(2.0, 1.0, (r, m))
    x = jnp.asarray(rng.poisson(w0 @ h0), jnp.float64)
    key = jax.random.PRNGKey(0)
    h1 = Hyper(aw=1.0, bw=1.0, ah=1.0, bh=1.0)
    st = vb_ops.vb_init_random(key, n, m, r, h1, jnp.float64)
    hy = Hyper(*(jnp.asarray(v, jnp.float64)
                 for v in (1.0, 1.0, 1.0, 1.0)))
    for kw in (dict(itmax=300, tol=1e-6, hyper_mask=(True,) * 4,
                    n0=10, dn=1),
               # itmax-exhaustion path
               dict(itmax=7, tol=1e-12, hyper_mask=(True,) * 4,
                    n0=3, dn=2)):
        eager = vb_ops.vb_run(x, st, hy, **kw)
        fused = vb_ops.vb_run(x, st, hy, fused=vb_ops.fused_dense, **kw)
        assert int(eager.n_iter) == int(fused.n_iter)
        assert float(eager.lml) == float(fused.lml)
        assert float(eager.state.lkh) == float(fused.state.lkh)
        for a, b in zip(eager.hyper, fused.hyper):
            assert float(a) == float(b)
        np.testing.assert_array_equal(np.asarray(eager.state.ew),
                                      np.asarray(fused.state.ew))
        np.testing.assert_array_equal(np.asarray(eager.state.eh),
                                      np.asarray(fused.state.eh))


def test_vb_run_fused_rank_and_cell_masks():
    """Fused loop under rank/cell padding masks == eager loop."""
    from ccfindr_tpu.ops.vb import Hyper

    n, m, r, rpad, mpad = 24, 30, 3, 5, 36
    rng = np.random.default_rng(8)
    w0 = rng.gamma(2.0, 1.0, (n, r))
    h0 = rng.gamma(2.0, 1.0, (r, m))
    x = np.asarray(rng.poisson(w0 @ h0), np.float64)
    xpad = jnp.asarray(np.pad(x, ((0, 0), (0, mpad - m))))
    cell_mask = jnp.asarray((np.arange(mpad) < m).astype(np.float64))
    rank_mask = jnp.asarray((np.arange(rpad) < r).astype(np.float64))
    key = jax.random.PRNGKey(1)
    h1 = Hyper(aw=1.0, bw=1.0, ah=1.0, bh=1.0)
    st = vb_ops.vb_init_random(key, n, mpad, rpad, h1, jnp.float64)
    hy = Hyper(*(jnp.asarray(v, jnp.float64)
                 for v in (1.0, 1.0, 1.0, 1.0)))
    kw = dict(itmax=150, tol=1e-6, hyper_mask=(True,) * 4, n0=10, dn=1,
              cell_mask=cell_mask, m_true=m, rank_mask=rank_mask,
              r_true=float(r))
    eager = vb_ops.vb_run(xpad, st, hy, **kw)
    fused = vb_ops.vb_run(xpad, st, hy, fused=vb_ops.fused_dense, **kw)
    assert int(eager.n_iter) == int(fused.n_iter)
    assert float(eager.lml) == float(fused.lml)
    np.testing.assert_array_equal(np.asarray(eager.state.ew),
                                  np.asarray(fused.state.ew))
