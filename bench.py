"""Benchmark: VB-NMF sweep throughput on one GPU, across backends.

Metric (BASELINE.json): VB sweeps/sec on a 10x-scale count matrix.  The
reference publishes no numbers, so the baseline denominator is the
measured throughput of the reference's own math — dense float64
NumPy/BLAS sweeps on the host CPU (the computational twin of the
Eigen/GSL kernel src/vbnmf_update.cpp) — giving vs_baseline = GPU
sweeps/sec / CPU reference sweeps/sec for the same problem.

Prints one JSON line per config, in priority order under a wall-clock
budget (BENCH_BUDGET_S, default 1200 s): the headline line (the fused
X-pass kernel, n=4096 m=8192 r=16, with vs_baseline) first, the
bundled-dataset correctness gate second, and every optional leg is
skipped with a JSON note when the remaining budget cannot cover its
estimated cost.  The headline is re-emitted at the end so the LAST line
is always the headline.  Timing method: k-sweep device loops at two
lengths, differenced — cancels the fixed dispatch and sync cost.
Every line names the device it ran on; without a GPU the script exits
non-zero and prints no result.

Usage: python bench.py [--quick]   (--quick: headline config only)
"""

import json
import sys
import time

import numpy as np


def _problem(n, m, r, dtype, density=None, seed=0, tile_cells=None):
    """Planted-rank-r Poisson counts at mean 2.0.

    Unstructured Poisson noise has no NMF structure, so the
    empirical-Bayes Newton update would never converge and run all 99
    iterations every sweep; planted factors give the convergence
    behavior of real data.  ``tile_cells=K`` generates an (n, m/K) base
    block and tiles it K times along cells (bounded host generation
    time for identical per-sweep work).
    """
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    mb = m // tile_cells if tile_cells else m
    wf = rng.gamma(0.5, 1.0, (n, r)).astype(np.float32)
    hf = rng.gamma(0.5, 1.0, (r, mb)).astype(np.float32)
    scale = 2.0 * n * mb / float(wf.sum(axis=0) @ hf.sum(axis=1))
    # blockwise generation + int16 storage bound host memory
    x = np.empty((n, mb), np.int16)
    for i0 in range(0, n, 2048):
        mu = (wf[i0:i0 + 2048] @ hf) * scale
        blk = np.minimum(rng.poisson(mu), 127)   # int8-safe counts
        if density is not None:
            blk = blk * (rng.random(mu.shape) < density)
        x[i0:i0 + 2048] = blk
    if tile_cells:
        x = np.tile(x, (1, tile_cells))
    w = jnp.asarray(rng.gamma(1.0, 1.0, size=(n, r)), dtype)
    h = jnp.asarray(rng.gamma(1.0, 1.0, size=(r, m)), dtype)
    return x, w, h


def _sweep_rate(body, x, state, k1=64, k2=576, reps=5):
    """body(x, carry) -> carry; sweeps/s from k-sweep device loops at
    two lengths, differenced.  X is a jit ARGUMENT (as in the driver):
    closing over it would bake a multi-GB constant into the program.
    The carry chains through every call and each timed leg ends with
    a small value fetch, so the timing covers executed work."""
    import functools

    import jax

    @functools.partial(jax.jit, static_argnames=("k",))
    def sweep_k(x, state, k):
        return jax.lax.fori_loop(0, k, lambda i, st: body(x, st),
                                 state)

    def _sync(st):
        jax.block_until_ready(st)
        _ = np.asarray(jax.device_get(jax.tree.leaves(st)[0]))
        return st

    st = _sync(sweep_k(x, state, k1))                # compile + warm
    st = _sync(sweep_k(x, st, k2))
    b1 = b2 = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        st = _sync(sweep_k(x, st, k1))
        t1 = time.perf_counter()
        st = _sync(sweep_k(x, st, k2))
        t2 = time.perf_counter()
        b1 = min(b1, t1 - t0)
        b2 = min(b2, t2 - t1)
    if b2 - b1 <= 0.05 * b2:
        # differenced denominator inside timing noise: the k2 leg's
        # absolute rate can only underestimate throughput
        return k2 / b2
    return (k2 - k1) / (b2 - b1)


def bench_vb(n=4096, m=8192, r=16, backend="pallas", x_dtype="int8",
             precision="f32", density=None, k=(64, 576),
             tile_cells=None):
    """Device-side VB sweeps/sec of the full production sweep (fused
    X-pass + posterior update + empirical-Bayes hyper update, exactly
    vb_run's body) for one backend/config."""
    import jax.numpy as jnp
    from ccfindr_tpu.ops import vb as vb_ops
    from ccfindr_tpu.ops.vb import Hyper, VBState

    dtype = jnp.float32
    x_np, w, h = _problem(n, m, r, dtype, density=density,
                          tile_cells=tile_cells)
    state = VBState(ew=w, eh=h, lw=w, lh=h, dw=jnp.zeros_like(w),
                    dh=jnp.zeros_like(h),
                    lkh=jnp.asarray(-jnp.inf, dtype))
    hyper = Hyper(*(jnp.asarray(v, dtype) for v in (1.0,) * 4))
    fudge = jnp.asarray(np.finfo(np.float32).eps, dtype)
    # hoisted sum(lgamma(x+1)) via a value histogram — counts are
    # small ints, so no n x m float array is needed for the constant
    from scipy.special import gammaln as _gammaln
    cnt = np.bincount(x_np.ravel(), minlength=2)
    lgx = jnp.asarray(
        float(cnt @ _gammaln(np.arange(len(cnt)) + 1.0)), dtype)

    sd = {"int8": jnp.int8, "int16": jnp.int16, "f32": dtype}[x_dtype]
    if backend == "pallas":
        from ccfindr_tpu.ops.pallas import xpass
        x = xpass.pad_matrix(jnp.asarray(x_np, sd))
        fused = xpass.make_vb_backend(precision)
    elif backend == "dense_fused":
        x = jnp.asarray(x_np, sd)
        fused = vb_ops.fused_dense
    elif backend == "sparse_coo":
        from ccfindr_tpu.ops import sparse as sk
        x = sk.from_dense(x_np, dtype=dtype)
        fused = sk.make_sparse_fused()
    elif backend == "sparse_ell":
        import scipy.sparse as sp

        from ccfindr_tpu.ops import ell as ek
        x = ek.from_scipy_ell(sp.csr_matrix(x_np), dtype=dtype)
        fused = ek.make_ell_fused()
    else:
        raise ValueError(backend)

    def body(x, carry):
        st, hy = carry
        swn, shn, dterm = fused(x, st.lw, st.lh)
        new, pending = vb_ops.posterior_update(
            st.lw * swn, st.lh * shn, st, hy, fudge, lgx)
        hy2, _ = vb_ops.hyper_update((True,) * 4, new, hy)
        return (new._replace(lkh=(pending + dterm)
                     / (float(n) * float(m))), hy2)

    return _sweep_rate(body, x, (state, hyper), k1=k[0], k2=k[1])


def bench_ml(n=4096, m=8192, r=16, backend="pallas", k=(32, 160)):
    """ML (Lee-Seung) path: fused H/W phases + likelihood rate."""
    import jax.numpy as jnp
    from ccfindr_tpu.ops import ml as ml_ops
    from ccfindr_tpu.ops.pallas import xpass

    dtype = jnp.float32
    x_np, w, h = _problem(n, m, r, dtype)
    if backend == "pallas":
        x = xpass.pad_matrix(jnp.asarray(x_np, jnp.int8))
        fused_h, fused_w = xpass.make_ml_backend()
    else:
        x = jnp.asarray(x_np, jnp.int8)
        fused_h, fused_w = ml_ops.ml_h_dense, ml_ops.ml_w_dense
    eps = jnp.asarray(np.finfo(np.float32).eps, dtype)

    def body(x, carry):
        w_, h_ = carry
        hn, xlogwh = fused_h(x, w_, h_)
        h2 = jnp.maximum(h_ * hn / jnp.sum(w_, axis=0)[:, None], eps)
        wn = fused_w(x, w_, h2)
        w2 = jnp.maximum(w_ * wn / jnp.sum(h2, axis=1)[None, :], eps)
        return (w2 * (1.0 + 1e-12 * xlogwh), h2)

    return _sweep_rate(body, x, (w, h), k1=k[0], k2=k[1])


def bench_convergence(n=4096, m=8192, r=16, backend="pallas"):
    """Time-to-converged-ELBO: one restart of vb_run on the planted
    problem, reference defaults (tol=1e-5, hyper cadence n0=10/dn=1)."""
    import jax
    import jax.numpy as jnp
    from ccfindr_tpu.ops import vb as vb_ops
    from ccfindr_tpu.ops.pallas import xpass
    from ccfindr_tpu.ops.vb import Hyper

    dtype = jnp.float32
    x_np, w, h = _problem(n, m, r, dtype)
    if backend == "pallas":
        x = xpass.pad_matrix(jnp.asarray(x_np, jnp.int8))
        fused = xpass.make_vb_backend()
    else:
        x = jnp.asarray(x_np, jnp.int8)
        fused = vb_ops.fused_dense
    hyper = Hyper(*(jnp.asarray(v, dtype) for v in (1.0,) * 4))

    def run(seed):
        st = vb_ops.vb_init_random(jax.random.PRNGKey(seed), n, m, r,
                                   hyper, dtype)
        return vb_ops.vb_run(x, st, hyper, itmax=10000, tol=1e-5,
                             fused=fused)
    jax.block_until_ready(run(1))      # compile + warm
    t0 = time.perf_counter()
    out = run(0)
    nit = int(out.n_iter)              # reads back: the run finished
    return time.perf_counter() - t0, nit


def bench_cpu_reference(n=4096, m=8192, r=16, iters=3):
    """Reference-math throughput: float64 BLAS dense sweeps (the
    Eigen/GSL kernel's computational twin) on the host CPU."""
    from ccfindr_tpu.ops import reference_impl as ref

    rng = np.random.default_rng(0)
    x = rng.poisson(2.0, size=(n, m)).astype(np.float64)
    lw = rng.gamma(1.0, 1.0, size=(n, r))
    lh = rng.gamma(1.0, 1.0, size=(r, m))
    ew, eh = lw.copy(), lh.copy()
    out = ref.vb_sweep_np(x, lw, lh, ew, eh, 1.0, 1.0, 1.0, 1.0)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = ref.vb_sweep_np(x, out["lw"], out["lh"], out["ew"],
                              out["eh"], 1.0, 1.0, 1.0, 1.0)
    dt = time.perf_counter() - t0
    return iters / dt


def bench_workflow(backend="pallas"):
    """Bundled-dataset full rank scan (2..8 x 3 restarts, batched)
    wall time, warm."""
    import ccfindr_tpu as cf
    from ccfindr_tpu.data import pbmc_sim_dir

    s = cf.read_10x(pbmc_sim_dir())
    s = cf.filter_cells(s, umi_min=700, umi_max=8000, plot=False)
    s = cf.filter_genes(s, vmr_min=1.2, min_cells_expressed=50,
                        plot=False, verbose=False)

    def run(seed):
        return cf.vb_factorize(s, ranks=list(range(2, 9)), nrun=3,
                               verbose=0, Itmax=3000, seed=seed,
                               backend=backend)
    run(1)                  # compile + warm
    t0 = time.perf_counter()
    out = run(0)
    dt = time.perf_counter() - t0
    return dt, cf.optimal_rank(out)["ropt"]


def bench_atlas_workflow():
    """Atlas-scale end-to-end science run: QC -> batched VB rank scan
    2..20 -> optimal_rank -> tree -> metagenes on a simulated
    100k-cell x 20k-gene atlas, one GPU.
    Returns (total_wall_s, ropt, concordance)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", "atlas_demo.py")
    spec = importlib.util.spec_from_file_location("atlas_demo", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ropt, concord, phases = mod.main()
    return sum(phases.values()), ropt, concord


def main():
    import os

    import jax

    from ccfindr_tpu.utils import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py measures a GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        sys.exit(2)
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}

    def emit(metric, value, unit, vs_baseline=None):
        rec = {"metric": metric, "value": float(value), "unit": unit,
               "device": device}
        if vs_baseline is not None:
            rec["vs_baseline"] = float(vs_baseline)
        print(json.dumps(rec), flush=True)

    quick = "--quick" in sys.argv
    budget = float(os.environ.get("BENCH_BUDGET_S", "1200"))
    t_start = time.perf_counter()

    def remaining():
        return budget - (time.perf_counter() - t_start)

    def leg(name, est, fn):
        """Run one OPTIONAL leg under the wall-clock budget; a leg that
        doesn't fit, or fails, emits a JSON note instead."""
        if remaining() < est:
            print(json.dumps(
                {"metric": name, "skipped":
                 f"budget: {remaining():.0f}s left < {est}s est"}),
                flush=True)
            return None
        try:
            return fn()
        except Exception as e:          # noqa: BLE001
            print(json.dumps({"metric": name,
                              "error": str(e)[:200]}), flush=True)
            return None

    n, m, r = 4096, 8192, 16
    cpu_sps = bench_cpu_reference(n, m, r)

    # ---- headline with vs_baseline, emitted FIRST
    star_name = f"vb_sweeps_per_sec_n{n}_m{m}_r{r}_xint8"
    star_sps = bench_vb(n, m, r)
    emit(star_name, star_sps, "sweeps/s", vs_baseline=star_sps / cpu_sps)
    if quick:
        return

    # ---- bundled-dataset correctness gate
    def _workflow():
        dt, ropt = bench_workflow()
        emit("bundled_rank_scan_2to8x3_wall", dt, "s")
        emit("bundled_optimal_rank", ropt, "rank")
    leg("bundled_optimal_rank", 240, _workflow)

    def _variant(name, est, **kw):
        def f():
            emit(name, bench_vb(**kw), "sweeps/s")
        leg(name, est, f)

    # XLA's version of the same math, then the kernel's variants
    _variant(f"{star_name}_dense_fused", 90, n=n, m=m, r=r,
             backend="dense_fused")
    _variant(f"{star_name}_bf16", 90, n=n, m=m, r=r, precision="bf16")
    _variant(f"{star_name.replace('_xint8', '_xf32')}", 90, n=n, m=m,
             r=r, x_dtype="f32")
    _variant(f"{star_name.replace('_r16', '_r32')}", 90, n=n, m=m, r=32)

    def _ml():
        emit(f"ml_sweeps_per_sec_n{n}_m{m}_r{r}", bench_ml(n, m, r),
             "sweeps/s")
    leg("ml_sweeps", 120, _ml)

    def _conv():
        dt, nit = bench_convergence(n, m, r)
        emit(f"vb_time_to_converged_elbo_n{n}_m{m}_r{r}", dt, "s")
        emit(f"vb_sweeps_to_converged_elbo_n{n}_m{m}_r{r}", nit,
             "sweeps")
    leg("time_to_converged_elbo", 120, _conv)

    # ---- sparse backends at scRNA density (10%)
    _variant(f"vb_sweeps_per_sec_n2048_m8192_r{r}_sparse_ell10pct", 120,
             n=2048, m=8192, r=r, backend="sparse_ell", density=0.10,
             k=(16, 80))
    _variant(f"vb_sweeps_per_sec_n2048_m8192_r{r}_dense10pct", 90,
             n=2048, m=8192, r=r, density=0.10)

    # ---- 100k-cell atlas on ONE GPU (int8 X = 2 GB on device)
    _variant("vb_sweeps_per_sec_n20480_m100352_r20_xint8_atlas", 240,
             n=20480, m=100352, r=20, k=(2, 10), tile_cells=49)

    def _atlas_wf():
        wall, ropt, concord = bench_atlas_workflow()
        emit("atlas_workflow_100k_wall", wall, "s")
        emit("atlas_workflow_100k_ropt", ropt, "rank")
        if concord is not None:
            emit("atlas_workflow_100k_concordance", concord,
                 "fraction")
    leg("atlas_workflow_100k", 480, _atlas_wf)

    # headline re-emitted last (same measurement)
    emit(star_name, star_sps, "sweeps/s", vs_baseline=star_sps / cpu_sps)


if __name__ == "__main__":
    main()
