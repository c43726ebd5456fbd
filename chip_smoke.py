#!/usr/bin/env python3
"""Smoke run of the factorization on one NVIDIA GPU, through the public
entry points, at real data sizes.

Phases (each prints one line with its wall time; any failure exits
non-zero and no result line is printed):

0. device — refuses anything but a GPU; prints the card, its power
   limit, the JAX version, the compile cache and the optional imports.
1. the fused X-pass kernel compiled at 4096 genes x 8192 cells, r=16,
   int8 planted-Poisson X, against the float64 host oracle
   (ops/reference_impl.xpass_np) and XLA's fused_dense, at f32 and bf16.
2. the kernel against XLA's version of the same math (dense_fused),
   ms per sweep of the production loop (ops.vb.vb_run): one lane and a
   45-lane rank sweep batch at 4096 x 8192, and the 20480 x 100352
   int8 atlas shape with its 38-lane batch.
3. the PBMC vignette replay on the bundled data (QC -> rank scan 2..8
   -> optimal rank 5 -> clusters -> tree -> GSEA cell types), default
   backend and backend='pallas'.
4. a simulated 10x sample (4096 x 8192, 8 planted types, ~2,500 UMI per
   cell): rank scan 2..10 x 5 restarts to convergence with
   backend='pallas', 'dense_fused' and the default.
5. ML factorize ('pallas' against 'dense') and the sparse VB backend
   (ELL) against dense, on the PBMC set.

``--four-cards`` runs only the cell-sharded mesh path on four GPUs
(vb_factorize(mesh=make_mesh(cells=4), backend='pallas') on the int8
atlas matrix) against the same call on one card.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

Usage: python chip_smoke.py [--four-cards]
"""

import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# f32: float32 accumulation of up to 8192 products per output (no
# TF32) gives ~1e-7 relative on swn/shn; 1e-4 leaves room for the
# summation order of larger reductions.  The log term is one sum of
# 33.5 M float32 products of order 1: per-tile accumulators keep it
# within 1e-6.  bf16: operands rounded to 8 mantissa bits (2^-9
# relative each), accumulated in float32.
TOL = {"f32": {"swn": 1e-4, "shn": 1e-4, "xlog": 1e-5},
       "bf16": {"swn": 1e-2, "shn": 1e-2, "xlog": 1e-2}}
# evidences of two float32 runs from the same initial state: the
# backends differ in summation order only, so converged ELBOs (order
# -1 per matrix entry) agree to float32 roundoff accumulated over the
# sweeps; 1e-3 relative is far below the gaps between ranks.
EVIDENCE_RTOL = 1e-3
# planted-type concordance at rank 8 on the simulated sample.  The
# generator's own ceiling (cells whose planted type is also the program
# that dominates their expected counts) is 0.9937 for seed 17; VB at
# rank 8 reached 0.980 (dense XLA, float32, on a CPU) — the remaining
# cells carry more Poisson noise than signal.  0.97 fails a broken
# sweep, not that noise floor.
CONCORDANCE_MIN = 0.97
N, M, R = 4096, 8192, 16
ATLAS = (20480, 100352)


def _fail(msg):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def _load_example(name):
    path = os.path.join(ROOT, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_ex_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Phase:
    """Context manager printing one line per phase with its wall time;
    an exception propagates (the run then exits non-zero)."""

    def __init__(self, name):
        self.name = name
        self.notes = []

    def note(self, text):
        self.notes.append(text)

    def __enter__(self):
        self.t0 = time.perf_counter()
        print(f"[{self.name}] start", flush=True)
        return self

    def __exit__(self, kind, value, tb):
        dt = time.perf_counter() - self.t0
        status = "ok" if kind is None else f"FAILED ({kind.__name__})"
        print(f"[{self.name}] {status} in {dt:.1f} s"
              + ("".join(f"\n    {n}" for n in self.notes)), flush=True)
        return False


def _rel(got, want):
    import numpy as np

    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _planted_counts(n, m, rank, seed):
    """Planted-rank Poisson counts, mean 0.3 per entry, int8."""
    import numpy as np

    rng = np.random.default_rng(seed)
    w = rng.gamma(0.5, 1.0, (n, rank))
    h = rng.gamma(0.5, 1.0, (rank, m))
    lam = w @ h
    lam *= 0.3 * n * m / lam.sum()
    return np.minimum(rng.poisson(lam), 127).astype(np.int8)


def _device_counts(n, m, rank, seed, chunk=2048):
    """The same planted-Poisson int8 matrix generated on the device in
    row chunks (host sampling of 2e9 entries would take minutes)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def block(key, w, h, scale):
        return jnp.minimum(jax.random.poisson(key, (w @ h) * scale),
                           127).astype(jnp.int8)

    key = jax.random.PRNGKey(seed)
    kw, kh, key = jax.random.split(key, 3)
    w = jax.random.gamma(kw, 0.5, (n, rank))
    h = jax.random.gamma(kh, 0.5, (rank, m))
    scale = 0.12 * n * m / (jnp.sum(w, 0) @ jnp.sum(h, 1))
    rows = []
    for i0 in range(0, n, chunk):
        key, k = jax.random.split(key)
        rows.append(block(k, w[i0:i0 + chunk], h, scale))
    return jnp.concatenate(rows)


def phase_device(four):
    import jax

    with Phase("0 device") as ph:
        devs = jax.devices()
        dev = devs[0]
        if dev.platform != "gpu":
            raise SystemExit(
                f"chip_smoke: needs an NVIDIA GPU; JAX found platform "
                f"{dev.platform!r}")
        if four and len(devs) < 4:
            raise SystemExit(f"chip_smoke: --four-cards needs 4 GPUs, "
                             f"JAX found {len(devs)}")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
        from ccfindr_tpu.utils import compile_cache_dir

        print(f"nvidia-smi: {smi}")
        ph.note(f"device_kind={dev.device_kind} count={len(devs)}")
        ph.note(f"jax {jax.__version__}; compile cache "
                f"{compile_cache_dir()}")
        for mod in ("pandas", "matplotlib", "sklearn"):
            ok = importlib.util.find_spec(mod) is not None
            ph.note(f"{mod}: {'imports' if ok else 'MISSING'}")
        return dev


def phase_kernel():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ccfindr_tpu.ops import reference_impl as ref
    from ccfindr_tpu.ops import vb as vb_ops
    from ccfindr_tpu.ops.pallas import xpass as xk

    with Phase("1 kernel at 4096x8192 r=16, int8 X") as ph:
        xn = _planted_counts(N, M, 8, seed=0)
        rng = np.random.default_rng(1)
        lwn = rng.gamma(2.0, 1.0, (N, R)).astype(np.float32)
        lhn = rng.gamma(2.0, 1.0, (R, M)).astype(np.float32)
        x = jnp.asarray(xn)
        lw, lh = jnp.asarray(lwn), jnp.asarray(lhn)
        want = ref.xpass_np(xn, lwn, lhn)
        xla = jax.jit(vb_ops.fused_dense)(x, lw, lh)
        for prec in ("f32", "bf16"):
            fn = jax.jit(lambda a, b, c, p=prec: xk.xpass(
                a, b, c, precision=p))
            compiled = fn.lower(x, lw, lh).compile()
            if prec == "f32":
                ph.note(f"memory_analysis: {compiled.memory_analysis()}")
            swn, shn, xlog = compiled(x, lw, lh)
            errs = {"swn": _rel(swn, want[0]), "shn": _rel(shn, want[1]),
                    "xlog": abs(float(xlog) - want[2]) / abs(want[2])}
            dterm = xk.fold_dterm(swn, shn, lw, lh, xlog)
            vs_xla = {"swn": _rel(swn, xla[0]), "shn": _rel(shn, xla[1]),
                      "dterm": abs(float(dterm) - float(xla[2]))
                      / abs(float(xla[2]))}
            ph.note(f"{prec}: vs float64 "
                    + " ".join(f"{k}={v:.2e}" for k, v in errs.items())
                    + f" (limits {TOL[prec]}); vs XLA fused_dense "
                    + " ".join(f"{k}={v:.2e}" for k, v in vs_xla.items()))
            for k, v in errs.items():
                if not v <= TOL[prec][k]:
                    raise AssertionError(f"{prec} {k} error {v:.3e} > "
                                         f"{TOL[prec][k]}")
            lim = TOL[prec]["swn"]
            if not max(vs_xla.values()) <= lim:
                raise AssertionError(f"{prec}: kernel vs XLA {vs_xla}")
    return xn


def _loop_ms(run, args, k1, k2, reps=2):
    """ms per sweep of a compiled loop run(*args, k): two loop lengths,
    differenced (cancels launch and sync costs)."""
    import jax

    def timed(k):
        t0 = time.perf_counter()
        out = run(*args, k)
        jax.block_until_ready(out)
        float(jax.tree.leaves(out)[0].ravel()[0])
        return time.perf_counter() - t0

    timed(k1)                                   # compile + warm
    b1 = min(timed(k1) for _ in range(reps))
    b2 = min(timed(k2) for _ in range(reps))
    return 1e3 * (b2 - b1) / (k2 - k1)


def _sweep_loop(x, n, m, r, lanes, fused):
    """(jitted loop, its args): ``lanes`` vmapped restarts of the
    production VB loop, run for exactly k sweeps (tol < 0)."""
    import jax
    import jax.numpy as jnp

    from ccfindr_tpu.ops import vb as vb_ops
    from ccfindr_tpu.ops.vb import Hyper

    hy = Hyper(*(jnp.float32(1.0),) * 4)
    keys = jax.random.split(jax.random.PRNGKey(0), lanes)
    st = jax.vmap(lambda k: vb_ops.vb_init_random(
        k, n, m, r, hy, jnp.float32))(keys)
    hys = jax.tree.map(lambda a: jnp.full((lanes,), a), hy)

    @jax.jit
    def run(x, st, hys, k):
        return jax.vmap(lambda s, h: vb_ops.vb_run(
            x, s, h, itmax=k, tol=-1.0, fused=fused).lml)(st, hys)

    return run, (x, st, hys)


def phase_speed(xn):
    import jax
    import jax.numpy as jnp

    from ccfindr_tpu.ops import vb as vb_ops
    from ccfindr_tpu.ops.pallas import xpass as xk

    kern = xk.make_vb_backend("f32")
    res = {}
    with Phase("2 kernel vs XLA dense_fused, ms per sweep (vb_run)") as ph:
        x = jnp.asarray(xn)
        xp = xk.pad_matrix(x)
        for lanes, r in ((1, R), (45, 10)):
            for name, xx, f in (("pallas", xp, kern),
                                ("dense_fused", x, vb_ops.fused_dense)):
                run, args = _sweep_loop(xx, N, M, r, lanes, f)
                ms = _loop_ms(run, args, 4, 24)
                res[(N, lanes, name)] = ms
                ph.note(f"{N}x{M} r={r} lanes={lanes} {name}: "
                        f"{ms:.3f} ms/sweep")
        del x, xp
        n, m = ATLAS
        xa = xk.pad_matrix(_device_counts(n, m, 12, seed=3))
        limit = (jax.devices()[0].memory_stats() or {}).get(
            "bytes_limit") or float("inf")
        for lanes in (1, 38):
            for name, f in (("pallas", kern),
                            ("dense_fused", vb_ops.fused_dense)):
                run, args = _sweep_loop(xa, n, m, 20, lanes, f)
                mem = run.lower(*args, 1).compile().memory_analysis()
                need = (mem.temp_size_in_bytes + mem.argument_size_in_bytes
                        + mem.output_size_in_bytes)
                if need > limit:
                    res[(n, lanes, name)] = float("inf")
                    ph.note(f"{n}x{m} r=20 lanes={lanes} {name}: needs "
                            f"{need / 2**30:.1f} GiB > {limit / 2**30:.1f}"
                            " GiB of device memory: does not run")
                    continue
                ms = _loop_ms(run, args, 1, 3, reps=1)
                res[(n, lanes, name)] = ms
                ph.note(f"{n}x{m} r=20 lanes={lanes} {name}: {ms:.1f} "
                        f"ms/sweep (program {need / 2**30:.1f} GiB)")
        del xa
        wins = [res[(k[0], k[1], "pallas")] < res[(k[0], k[1],
                                                   "dense_fused")]
                for k in res if k[2] == "pallas"]
        ph.note("kernel faster per sweep in "
                f"{sum(wins)} of {len(wins)} configurations")
    return res


def _qc_pbmc():
    import ccfindr_tpu as cf
    from ccfindr_tpu.data import pbmc_sim_dir

    s = cf.read_10x(pbmc_sim_dir())
    s = cf.filter_cells(s, umi_min=700, umi_max=8000, plot=False)
    return cf.filter_genes(s, vmr_min=1.2, min_cells_expressed=50,
                           plot=False, verbose=False)


def _evidence_gap(a, b):
    import numpy as np

    la = a.measure.set_index("rank")["lml"]
    lb = b.measure.set_index("rank")["lml"]
    common = la.index.intersection(lb.index)
    if len(common) != len(la) or len(common) != len(lb):
        raise AssertionError(f"rank scans differ: {list(la.index)} vs "
                             f"{list(lb.index)}")
    return float(np.max(np.abs(la[common] - lb[common])
                        / np.abs(lb[common])))


def phase_pbmc():
    import ccfindr_tpu as cf

    markers = _load_example("pbmc_workflow").MARKERS
    with Phase("3 PBMC vignette replay (bundled data)") as ph:
        s = _qc_pbmc()
        ph.note(f"after QC: {s.n_genes} genes x {s.n_cells} cells")
        kw = dict(ranks=list(range(2, 9)), nrun=3, verbose=0,
                  Itmax=3000, seed=0)
        out = {}
        for backend in ("dense", "pallas"):
            t0 = time.perf_counter()
            res = cf.vb_factorize(s, backend=backend, **kw)
            ropt = cf.optimal_rank(res)["ropt"]
            out[backend] = res
            ph.note(f"vb_factorize backend={backend}: ropt={ropt} "
                    f"[{time.perf_counter() - t0:.1f} s]")
        ropts = {b: cf.optimal_rank(r)["ropt"] for b, r in out.items()}
        gap = _evidence_gap(out["pallas"], out["dense"])
        ph.note(f"evidence max relative gap pallas vs dense: {gap:.2e} "
                f"(limit {EVIDENCE_RTOL})")
        if ropts["dense"] != 5 or ropts["pallas"] != 5:
            raise AssertionError(f"optimal ranks {ropts}, expected 5")
        if not gap <= EVIDENCE_RTOL:
            raise AssertionError(f"evidence gap {gap:.3e}")
        res = out["dense"]
        cid = cf.cluster_id(res, rank=5)
        if set(cid.unique()) != {1, 2, 3, 4, 5}:
            raise AssertionError(f"clusters {sorted(cid.unique())}")
        nwk = cf.newick(cf.build_tree(res, rmax=5))
        gene_names = res.row_data.iloc[:, 1].to_numpy()
        es = cf.assign_celltype(res, rank=5, gset=markers,
                                gene_names=gene_names,
                                grp_prefix=("IG", "HLA"))
        best = es.idxmax(axis=0)
        ph.note(f"tree: {nwk}")
        ph.note("cell types: " + ", ".join(
            f"{c}={t}" for c, t in best.items()))
        if set(best) != set(markers):
            raise AssertionError(f"cell types assigned: {dict(best)}")
    return s


def _concordance(cid, types, rank):
    """Fraction of cells whose cluster is their planted type's
    majority cluster."""
    import numpy as np

    remap = {t: np.bincount(cid[types == t], minlength=rank).argmax()
             for t in np.unique(types)}
    return float(np.mean(np.array([remap[t] for t in types]) == cid))


def phase_sample():
    import numpy as np

    import ccfindr_tpu as cf

    atlas = _load_example("atlas_demo")
    with Phase("4 simulated 10x sample, 4096 x 8192, 8 planted types") as ph:
        # seed 17 plants every type in 7.6-26% of the cells; seed 0
        # plants two in ~1% each, which VB at rank 8 merges into larger
        # types while it splits the largest (43%) with the spare
        # components — concordance at rank 8 then measures that split
        # (0.79-0.90 on both backends), not recovery
        x, types = atlas.simulate_atlas(n_genes=N, n_cells=M, rank=8,
                                        seed=17)
        s = cf.SCSet(count=x)
        ph.note(f"UMI per cell {x.sum(0).mean():.0f}, nonzero "
                f"{np.count_nonzero(x) / x.size:.3f}")
        m0 = s.n_cells
        s = cf.filter_cells(s, umi_min=1, plot=False)
        s = cf.filter_genes(s, vmr_min=1.05, min_cells_expressed=50,
                            plot=False, verbose=False)
        if s.n_cells != m0:
            types = types[np.asarray(s.colnames, dtype=np.int64)]
        ph.note(f"after QC: {s.n_genes} genes x {s.n_cells} cells")
        kw = dict(ranks=list(range(2, 11)), nrun=5, verbose=0,
                  Itmax=10000, Tol=1e-5, seed=0)
        out = {}
        walls = {}
        # every backend twice: the first call compiles, the second is
        # the warm end-to-end time
        for backend in ("pallas", "dense_fused", "dense") * 2:
            t0 = time.perf_counter()
            res = cf.vb_factorize(s, backend=backend, **kw)
            walls.setdefault(backend, []).append(time.perf_counter() - t0)
            if len(walls[backend]) == 1:
                continue
            dt = walls[backend]
            ropt = cf.optimal_rank(res)["ropt"]
            cid = cf.cluster_id(res, rank=8).to_numpy() - 1
            conc = _concordance(cid, types, 8)
            sweeps = res.metadata["timings"][0].get(
                "lane_sweeps_executed")
            ph.note(f"backend={backend}: cold {dt[0]:.1f} s, warm "
                    f"{dt[1]:.1f} s, ropt={ropt} "
                    f"(planted 8), concordance at r=8 {conc:.4f}, "
                    f"lane sweeps {sweeps}")
            out[backend] = (res, ropt, conc)
            if not conc >= CONCORDANCE_MIN:
                raise AssertionError(f"{backend} concordance {conc:.4f}")
        gap = _evidence_gap(out["pallas"][0], out["dense"][0])
        ph.note(f"evidence max relative gap: {gap:.2e} "
                f"(limit {EVIDENCE_RTOL})")
        if not gap <= EVIDENCE_RTOL:
            raise AssertionError(f"evidence gap {gap:.3e}")
        if out["pallas"][1] != out["dense"][1]:
            raise AssertionError("optimal ranks differ across backends")


def phase_ml_sparse(s):
    import numpy as np

    import ccfindr_tpu as cf

    with Phase("5 ML factorize and sparse VB on PBMC") as ph:
        kw = dict(ranks=list(range(2, 7)), nrun=5, verbose=0, seed=0)
        ml = {b: cf.factorize(s, backend=b, **kw)
              for b in ("pallas", "dense")}
        lk = {b: r.measure["likelihood"].to_numpy() for b, r in ml.items()}
        gap = float(np.max(np.abs(lk["pallas"] - lk["dense"])
                           / np.abs(lk["dense"])))
        ph.note(f"ML likelihood gap pallas vs dense: {gap:.2e} "
                f"(limit {EVIDENCE_RTOL})")
        if not gap <= EVIDENCE_RTOL:
            raise AssertionError(f"ML likelihood gap {gap:.3e}")
        vkw = dict(ranks=list(range(2, 9)), nrun=3, verbose=0,
                   Itmax=3000, seed=0)
        sp = cf.vb_factorize(s, backend="sparse", **vkw)
        de = cf.vb_factorize(s, backend="dense", **vkw)
        gap = _evidence_gap(sp, de)
        ropts = (cf.optimal_rank(sp)["ropt"], cf.optimal_rank(de)["ropt"])
        ph.note(f"sparse (ELL) vs dense evidence gap {gap:.2e}, ropt "
                f"{ropts[0]} vs {ropts[1]}")
        if not gap <= EVIDENCE_RTOL or ropts[0] != ropts[1]:
            raise AssertionError("sparse and dense VB disagree")


def phase_four_cards():
    import jax
    import numpy as np

    import ccfindr_tpu as cf

    n, m = ATLAS
    with Phase("4 cards: cell-sharded mesh vs one card, atlas int8") as ph:
        x = np.asarray(_device_counts(n, m, 12, seed=3))
        x = x[x.any(axis=1)][:, x.any(axis=0)]
        ph.note(f"X {x.shape[0]} x {x.shape[1]} int8 "
                f"({x.nbytes / 2**30:.2f} GiB)")
        kw = dict(ranks=list(range(2, 21)), nrun=2, verbose=0, Itmax=20,
                  seed=0, backend="pallas")
        t0 = time.perf_counter()
        mesh = cf.make_mesh(cells=4, devices=jax.devices()[:4])
        a = cf.vb_factorize(x, mesh=mesh, **kw)
        ph.note(f"mesh cells=4: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        b = cf.vb_factorize(x, **kw)
        ph.note(f"one card: {time.perf_counter() - t0:.1f} s")
        gap = _evidence_gap(a, b)
        ra, rb = cf.optimal_rank(a)["ropt"], cf.optimal_rank(b)["ropt"]
        same = float(np.mean(cf.cluster_id(a, rank=ra).to_numpy()
                             == cf.cluster_id(b, rank=ra).to_numpy()))
        ph.note(f"evidence gap {gap:.2e}, ropt {ra} vs {rb}, cluster "
                f"agreement at r={ra}: {same:.4f}")
        if not (gap <= EVIDENCE_RTOL and ra == rb and same >= 0.99):
            raise AssertionError("mesh and one-card results disagree")


def main():
    four = "--four-cards" in sys.argv[1:]
    try:
        import ccfindr_tpu
    except ImportError:
        _fail("the ccfindr_tpu package is not beside this script")
    if os.path.dirname(os.path.dirname(
            os.path.abspath(ccfindr_tpu.__file__))) != ROOT:
        _fail("the ccfindr_tpu package is not beside this script")
    from ccfindr_tpu.utils import enable_compile_cache

    enable_compile_cache()
    dev = phase_device(four)
    if four:
        phase_four_cards()
    else:
        xn = phase_kernel()
        phase_speed(xn)
        s = phase_pbmc()
        phase_sample()
        phase_ml_sparse(s)
    import jax

    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
