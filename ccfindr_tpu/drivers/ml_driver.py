"""Maximum-likelihood factorization driver.

JAX equivalent of reference factorize (R/factorize.R:139-276):
rank sweep x nsmpl randomized replicates x nrun restarts.  Redesigns:

* Restarts — and, with ``batch_ranks`` (default auto), the whole
  rank sweep — run as ONE vmapped device loop with per-instance rank
  masks, mirroring the VB driver's batching.
* With a ``jax.sharding.Mesh``, X/H shard over the 'cells' axis and
  the fused X-pass GPU kernel's ML phases run per shard under
  shard_map with explicit psums (parallel.sharded.make_ml_sharded).
* Consensus statistics stream through
  ops.consensus.ConsensusAccumulator — exact dispersion without ever
  materializing the m(m-1)/2 connectivity vector the reference
  accumulates (R/factorize.R:214-216); the cophenetic correlation
  (which inherently needs the condensed consensus distance) is
  computed only while m <= ``cophenetic_max_cells`` and reported NaN
  above it.
* The gamma-prior MAP terms the reference documents but never enables
  (R/factorize.R:9-22; quirk (e) in SURVEY §7.3) are exposed as
  ``prior=True`` with ``gamma_a``/``gamma_b``.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

import jax
import jax.numpy as jnp

from ..container import SCSet
from ..ops import ml as ml_ops
from ..ops import consensus as cons


def _default_dtype():
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def _scatter_rows(dst, src, lanes, nreal):
    res = np.array(dst)
    res[lanes[:nreal]] = src[:nreal]
    return res


def _chunked_ml(call, w0, h0, nb, m_arr, itmax, every, ckpt_file,
                np_dtype, verbose, compact=True):
    """Run a vmapped ml_run in sweep chunks with host checkpoints and
    converged-lane compaction — the ML twin of
    vb_driver._chunked_vb (reference treats the two drivers
    symmetrically, R/factorize.R:139-276 vs R/bayesian.R:229-390, so
    both get the same two-level resume here).

    ``call(w, h, cid, zstep, lk0, end, it0, lanes) -> MLRunResult``
    (vmapped over the rows of w/h; ``lanes`` are the GLOBAL instance
    indices so the caller can subset per-instance rank masks).  After
    each chunk the full loop carry (factors, per-instance likelihood,
    connectivity streak, absolute sweep index) persists to
    ``ckpt_file`` when given; resumption is bit-exact (ml_run's
    it0/lk0_init/cid0/zstep0 continuation).  Converged lanes freeze
    host-side and, with ``compact=True``, drop out of the next
    chunk's (power-of-two-padded) batch.
    """
    import os

    from ..ops.ml import MLRunResult

    it0 = 1
    n_rec = np.full(nb, -1, np.int64)
    g = None
    if ckpt_file is not None and os.path.exists(ckpt_file):
        z = np.load(ckpt_file)
        it0 = int(z["it0"])
        n_rec = z["n_rec"]
        g = MLRunResult(w=z["w"], h=z["h"], lkh=z["lk0"],
                        n_iter=np.where(n_rec >= 0, n_rec, 0),
                        cid=z["cid"], zstep=z["zstep"],
                        done=n_rec >= 0)
        if verbose >= 1:
            print(f"Resumed ML sweep checkpoint at iteration {it0}")

    while True:
        end = min(it0 - 1 + every, itmax)
        live = np.nonzero(n_rec < 0)[0]
        if g is not None and len(live) == 0:
            break
        if g is None:
            lanes = np.arange(nb)
            nreal = nb
            w_l, h_l = w0, h0
            cid_l = np.zeros((nb, m_arr), np.int32)
            zst_l = np.zeros((nb,), np.int32)
            lk_l = np.full(nb, -np.inf, np_dtype)
        else:
            nreal = len(live)
            if compact:
                size = 1 << max(0, int(nreal - 1).bit_length())
                size = min(max(size, 1), nb)
            else:
                size = nb
            pad = size - nreal
            lanes = np.concatenate(
                [live, np.repeat(live[:1], pad)]) if pad else live
            w_l = jnp.asarray(np.asarray(g.w)[lanes])
            h_l = jnp.asarray(np.asarray(g.h)[lanes])
            cid_l = np.asarray(g.cid)[lanes]
            zst_l = np.asarray(g.zstep)[lanes]
            lk_l = np.asarray(g.lkh)[lanes].astype(np_dtype)
        out = call(w_l, h_l, jnp.asarray(cid_l), jnp.asarray(zst_l),
                   jnp.asarray(lk_l), jnp.asarray(end),
                   jnp.asarray(it0), lanes)
        out = jax.tree.map(np.asarray, out)
        if g is None:
            g = jax.tree.map(np.copy, out)
        else:
            g = jax.tree.map(
                lambda ga, oa: _scatter_rows(ga, oa, lanes, nreal),
                g, out)
        loc = out.done[:nreal] | (out.n_iter[:nreal] < end)
        sel = loc & (n_rec[lanes[:nreal]] < 0)
        n_rec[lanes[:nreal][sel]] = out.n_iter[:nreal][sel]
        if end >= itmax or (n_rec >= 0).all():
            break
        it0 = end + 1
        if ckpt_file is not None:
            np.savez(ckpt_file, it0=it0, lk0=np.asarray(g.lkh),
                     cid=np.asarray(g.cid),
                     zstep=np.asarray(g.zstep), n_rec=n_rec,
                     w=np.asarray(g.w), h=np.asarray(g.h))
        if verbose >= 2:
            print(f"ML checkpointed at sweep {end}: "
                  f"{int((n_rec >= 0).sum())}/{nb} converged")

    if ckpt_file is not None and os.path.exists(ckpt_file):
        os.remove(ckpt_file)
    return g


def factorize(object, ranks=2, nrun=20, randomize=False, nsmpl=1,
              verbose=2, Itmax=10000, ncnn_step=40,
              criterion="likelihood", linkage="average", Tol=1e-5,
              store_connectivity=False, dtype=None, seed=0,
              backend="dense", mesh=None, batch_ranks="auto",
              prior=False, gamma_a=1.0, gamma_b=1.0,
              cophenetic_max_cells=10000, cophenetic_nsub=3,
              storage_dtype="auto", sparse_layout="auto",
              checkpoint_dir=None, checkpoint_every=None,
              compact_every=None,
              distributed="auto", _process_count=None,
              _process_id=None):
    """ML (Lee–Seung KL) NMF over a rank sweep.

    Mirrors reference factorize parameters (R/factorize.R:139-143).
    With ``randomize=True``, each of ``nsmpl`` replicates shuffles every
    column of the count matrix independently (null model for rank
    statistics) and measures are averaged with standard errors.

    ``backend``:

    * ``'dense'``       — eager XLA loop (parity oracle)
    * ``'dense_fused'`` — XLA, deferred-likelihood 2-passes-over-X loop
    * ``'pallas'``      — the same loop over the fused X-pass GPU
      kernel's H and W phases (ops.pallas.xpass).  GPU only.
    * ``'sparse'``      — nonzero-only phases, no densification
      (``sparse_layout``: 'ell', the 'auto' default — dual
      gather-only hybrid ELL, single device; no ``randomize``)

    ``checkpoint_every=K`` (with ``checkpoint_dir``) checkpoints
    MID-RUN every K sweeps, exactly as vb_factorize: the device loop
    executes in K-sweep chunks whose full carry (factors, likelihoods,
    connectivity streaks, absolute sweep index) persists, and an
    interrupted run resumes bit-identically (ml_run's continuation
    args).  ``checkpoint_dir`` alone additionally persists each
    completed sample's statistics and winning factors, so a crashed
    multi-sample randomized scan skips finished samples on rerun.
    ``compact_every=K`` chunks the device loop WITHOUT checkpoint
    files and re-packs only still-running instances into a smaller
    batch at each boundary (converged-lane compaction, exactly as
    vb_factorize); ``checkpoint_every`` implies the same compaction.

    ``storage_dtype`` stores X on device as int8/int16 (dense layouts
    only): 4x/2x less X HBM traffic with exact math, mirroring
    vb_factorize.  ``'auto'`` (the default) compresses raw integer
    counts that fit and silently keeps floats/overflow/sparse at full
    precision; ``None`` opts out.

    ``mesh`` shards X and H over the mesh's 'cells' axis (W stays
    replicated): 'dense'/'dense_fused' partition via GSPMD, 'pallas'
    runs the per-shard kernels under shard_map with explicit psums.

    ``batch_ranks=True`` runs the whole rank sweep x restarts as one
    padded vmapped batch (one compilation, one device loop); 'auto'
    batches whenever there are multiple ranks.  ``prior=True`` enables
    the gamma-prior MAP update terms with ``gamma_a``/``gamma_b``.

    **Multi-host** (mirroring vb_factorize): under a multi-process
    JAX runtime the (sample, rank, RUN) grid round-robin partitions
    across processes at restart granularity — a restart-heavy
    consensus run (the reference default ``nrun=20``,
    R/factorize.R:139) with few (sample, rank) items spreads evenly
    instead of leaving hosts idle.  The consensus needs every
    restart's assignment, so the per-restart hard cluster vectors
    (m int32 each) all-gather after the local batches; every host
    then accumulates the identical consensus and replicates each
    rank's best-likelihood factors from the winning restart's owner.
    Every host returns the identical SCSet, equal to a single-process
    run with the same seed (per-restart RNG keys are derived from the
    grid position, not the process).  Requires ``batch_ranks``
    (forced on).

    Above ``cophenetic_max_cells`` cells, the cophenetic correlation
    switches to a subsampled estimator (``cophenetic_nsub`` random
    subsets of that size, each scored exactly; mean reported in the
    measure table, per-draw standard errors in
    ``metadata['cophenetic_se']``) instead of materializing the full
    m(m-1)/2 consensus (reference R/factorize.R:69-78 always does).
    """
    if np.isscalar(ranks):
        ranks = [int(ranks)]
    ranks = [int(r) for r in ranks]
    if dtype is None:
        dtype = _default_dtype()

    if isinstance(object, SCSet):
        obj = object
    else:
        obj = SCSet(count=object, remove_zeros=False)
    if backend == "sparse":
        import scipy.sparse as sp
        mat0 = sp.csr_matrix(obj.counts)
        n, m = mat0.shape
        if (np.asarray(mat0.sum(axis=1)).ravel() == 0).any():
            raise ValueError("Input matrix contains empty rows")
        if (np.asarray(mat0.sum(axis=0)).ravel() == 0).any():
            raise ValueError("Input matrix contains empty columns")
        if sparse_layout not in ("auto", "ell"):
            raise ValueError(f"unknown sparse_layout {sparse_layout!r}")
        if randomize:
            raise ValueError("randomize is not supported with "
                             "backend='sparse'; use a dense backend")
        if mesh is not None:
            raise ValueError("the sparse ML layout is single-device; "
                             "use a dense backend with a mesh")
    else:
        mat0 = obj.counts_dense(dtype=np.dtype(dtype))
        n, m = mat0.shape
        if (mat0.sum(axis=1) == 0).any():
            raise ValueError("Input matrix contains empty rows")
        if (mat0.sum(axis=0) == 0).any():
            raise ValueError("Input matrix contains empty columns")

    dev_dtype = dtype
    if isinstance(storage_dtype, str) and storage_dtype == "auto":
        from ..utils import auto_storage_dtype
        storage_dtype = (None if backend == "sparse"
                         else auto_storage_dtype(mat0))
    if storage_dtype is not None:
        sd = np.dtype(storage_dtype)
        if backend == "sparse":
            raise ValueError("storage_dtype applies to the dense "
                             "layouts; the sparse backend already "
                             "stores only nonzeros")
        if sd.kind not in "iu":
            raise ValueError("storage_dtype must be an integer dtype")
        if np.any(mat0 != np.round(mat0)):
            raise ValueError(
                "storage_dtype requires integer counts (normalized "
                "matrices are float — factorize raw counts instead)")
        if float(mat0.max()) > np.iinfo(sd).max:
            raise ValueError(
                f"counts up to {mat0.max():.0f} overflow "
                f"storage_dtype {sd.name}; use a wider type")
        dev_dtype = sd

    pn = float(gamma_a) - 1.0 if prior else 0.0
    pd_ = float(gamma_a) / float(gamma_b) if prior else 0.0

    # mesh: pad the cell axis to the 'cells' axis size with zero
    # columns (same eps-level effect as the X-pass kernel's tile padding; the
    # likelihood normalizes by the true (n, m) via nm_true)
    m_pad = m
    if mesh is not None and "cells" in mesh.axis_names:
        ncells_ax = mesh.shape["cells"]
        m_pad = -(-m // ncells_ax) * ncells_ax

    if isinstance(distributed, dict):
        from ..parallel.mesh import init_distributed
        init_distributed(**distributed)
        distributed = "auto"
    if distributed in (False, None):
        nproc, pid = 1, 0
    else:
        nproc = (_process_count if _process_count is not None
                 else jax.process_count())
        pid = (_process_id if _process_id is not None
               else jax.process_index())

    key0 = jax.random.PRNGKey(seed)
    nrank = len(ranks)
    if batch_ranks == "auto":
        batch_ranks = nrank > 1 or nproc > 1
    if nproc > 1:
        if not batch_ranks:
            raise ValueError("multi-host factorize requires "
                             "batch_ranks")
        if mesh is not None:
            raise ValueError("multi-host factorize partitions items "
                             "across processes; per-host meshes are "
                             "not combined")

    coph_ses = []
    wdat, hdat = [None] * nrank, [None] * nrank
    rdat = [[] for _ in range(nrank)]
    ddat = [[] for _ in range(nrank)]
    cdat = [[] for _ in range(nrank)]
    conav_last = None

    def place(x, w0, h0):
        if mesh is None:
            return x, w0, h0
        from jax.sharding import NamedSharding, PartitionSpec as P

        axes = mesh.axis_names
        runs = "runs" if "runs" in axes else None
        cells = "cells" if "cells" in axes else None
        x = jax.device_put(x, NamedSharding(mesh, P(None, cells)))
        w0 = jax.device_put(w0, NamedSharding(mesh, P(runs, None, None)))
        h0 = jax.device_put(h0, NamedSharding(mesh, P(runs, None, cells)))
        return x, w0, h0

    def device_x(mat):
        run_kwargs = dict(pn=jnp.asarray(pn, dtype),
                          pd=jnp.asarray(pd_, dtype))
        if backend == "sparse":
            from ..ops import ell as ek
            x = ek.from_scipy_ell(mat, dtype=dtype)
            fh, fw = ek.make_ell_ml_backend()
            run_kwargs.update(fused_h=fh, fused_w=fw, nm_true=(n, m))
            return x, run_kwargs
        x = jnp.asarray(mat, dev_dtype)
        if m_pad != m:
            x = jnp.pad(x, ((0, 0), (0, m_pad - m)))
        if backend == "dense_fused":
            run_kwargs.update(fused_h=ml_ops.ml_h_dense,
                              fused_w=ml_ops.ml_w_dense,
                              nm_true=(n, m))
        elif backend == "pallas":
            from ..ops.pallas import xpass as xk
            if mesh is not None and "cells" in mesh.axis_names:
                from ..parallel.sharded import make_ml_sharded
                fh, fw = make_ml_sharded(mesh)
            else:
                fh, fw = xk.make_ml_backend()
                x = xk.pad_matrix(x)
            run_kwargs.update(fused_h=fh, fused_w=fw, nm_true=(n, m))
        elif backend == "dense":
            if m_pad != m:
                run_kwargs.update(fused_h=ml_ops.ml_h_dense,
                                  fused_w=ml_ops.ml_w_dense,
                                  nm_true=(n, m))
        else:
            raise ValueError(f"unknown backend {backend!r}")
        return x, run_kwargs

    def consensus_stats(cids, lkhs, niters, label="", quiet=False):
        """Best-of-run selection + streaming consensus over restarts
        (reference R/factorize.R:214-226)."""
        acc = cons.ConsensusAccumulator(m)
        rmax, imax = -np.inf, 0
        for i in range(len(lkhs)):
            acc.add(cids[i])
            lk = float(lkhs[i])
            if (i == 0 or lk > rmax) and not np.isnan(lk):
                rmax, imax = lk, i
            if verbose >= 2 and not quiet:
                print(f"Run #{i + 1}{label}: Nsteps = {int(niters[i])},"
                      f" likelihood = {lk:.6g}, "
                      f"dispersion = {acc.dispersion():.6g}")
        disp = acc.dispersion()
        if m <= cophenetic_max_cells:
            conav = acc.conav()
            coph = cons.cophenet(conav, m, method=linkage)
        else:
            # subsampled estimator (exact on each random cell subset)
            # instead of NaN; the reference computes the
            # full m x m consensus unconditionally, R/factorize.R:69-78
            conav = None
            coph, coph_se = cons.cophenet_subsampled(
                acc, cophenetic_max_cells, method=linkage,
                nsub=cophenetic_nsub, seed=seed)
            coph_ses.append(coph_se)
        return imax, rmax, disp, coph, conav

    from ..parallel import schedule

    import os
    np_dtype = np.dtype(jnp.zeros((), dtype).dtype)
    # sample-level progress store: completed (sample, rank) results
    # persist so a crashed multi-sample scan skips finished samples
    # (the ML analog of vb_driver's per-rank checkpoints).  Disabled
    # under store_connectivity (the consensus accumulator of the last
    # sample cannot be reconstructed from the stored statistics).
    progress_file = None
    progress = {}
    if checkpoint_dir is not None and not store_connectivity:
        os.makedirs(checkpoint_dir, exist_ok=True)
        progress_file = os.path.join(checkpoint_dir,
                                     f"ml_progress_p{pid}.npz")
        if os.path.exists(progress_file):
            z = np.load(progress_file)
            progress = {key: z[key] for key in z.files}

    def _prog_key(ismpl, k):
        return f"s{ismpl}_k{k}"

    for ismpl in range(nsmpl):
        # work partition: single-process owns everything; multi-host
        # partitions at RESTART granularity — the (sample, rank, run) grid round-robins across
        # processes, so a restart-heavy consensus run (the reference
        # default nrun=20, R/factorize.R:139) with few (sample, rank)
        # items no longer leaves hosts idle.  The consensus needs
        # every restart's hard assignment, so those (m int32 each)
        # all-gather after the local batches (see below).
        if nproc > 1:
            pairs = [(k, i) for k in range(nrank) for i in range(nrun)
                     if ((ismpl * nrank + k) * nrun + i) % nproc == pid]
        else:
            pairs = [(k, i) for k in range(nrank) for i in range(nrun)]
        owned = sorted({k for k, _ in pairs})
        # with restart-split consensus every host holds EVERY rank's
        # final statistics, so progress stores/restores all ranks
        need = owned if nproc == 1 else list(range(nrank))
        restored = (progress_file is not None and need and
                    all(f"r_{_prog_key(ismpl, k)}" in progress
                        for k in need))
        if restored:
            local = {}
            for k in need:
                key = _prog_key(ismpl, k)
                stats = progress[f"r_{key}"]
                local[k] = dict(rmax=float(stats[0]),
                                disp=float(stats[1]),
                                coph=float(stats[2]),
                                wmax=progress[f"w_{key}"],
                                hmax=progress[f"h_{key}"])
            if verbose >= 1 and pid == 0:
                print(f"Sample# {ismpl + 1}: restored from checkpoint")
            for k in range(nrank):
                res = local[k]
                if ismpl == 0:
                    wdat[k] = res["wmax"].copy()
                    hdat[k] = res["hmax"].copy()
                else:
                    wdat[k] += res["wmax"]
                    hdat[k] += res["hmax"]
                rdat[k].append(float(res["rmax"]))
                ddat[k].append(float(res["disp"]))
                cdat[k].append(float(res["coph"]))
            continue
        if randomize:
            # per-sample deterministic stream, so any process can
            # rebuild sample ismpl's shuffled matrix identically
            rng_i = np.random.default_rng(
                np.random.SeedSequence([seed, 104729 + ismpl]))
            mat = np.empty_like(mat0)
            for j in range(m):
                mat[:, j] = rng_i.permutation(mat0[:, j])
        else:
            mat = mat0

        local = {}
        if pairs and batch_ranks:
            x, run_kwargs = device_x(mat)
            rmax_ = max(ranks)
            nb = len(pairs)
            rank_arr = np.asarray([ranks[k] for k, _ in pairs],
                                  np.int64)
            # per-(item, run) key derivation: independent of which
            # process runs the restart, so multi-host == single-host
            # exactly
            _kc = {}

            def _restart_key(k, i):
                if k not in _kc:
                    _kc[k] = jax.random.split(
                        jax.random.fold_in(key0, ismpl * nrank + k),
                        nrun)
                return _kc[k][i]

            keys = jnp.stack([_restart_key(k, i) for k, i in pairs])
            w0, h0 = jax.vmap(
                lambda kk: ml_ops.ml_init(kk, n, m_pad, rmax_,
                                          dtype))(keys)
            rmask = jnp.asarray(
                (np.arange(rmax_)[None, :] < rank_arr[:, None]
                 ).astype(np_dtype))
            x, w0, h0 = place(x, w0, h0)
            batched = jax.vmap(
                lambda w, h, rm, c0, z0, l0, im, i0: ml_ops.ml_run(
                    x, w, h, itmax=im, tol=float(Tol),
                    criterion=criterion, ncnn_step=int(ncnn_step),
                    rank_mask=rm, it0=i0, lk0_init=l0, cid0=c0,
                    zstep0=z0, **run_kwargs),
                in_axes=(0, 0, 0, 0, 0, 0, None, None))

            def call(w, h, c0, z0, l0, im, i0, lanes=None):
                rm = rmask
                if lanes is not None:
                    # compacted lanes are reordered even at full size
                    rm = rmask[np.asarray(lanes)]
                return batched(w, h, rm, c0, z0, l0, im, i0)

            if checkpoint_every or compact_every:
                ckf = None
                if checkpoint_every and checkpoint_dir is not None:
                    ckf = os.path.join(
                        checkpoint_dir,
                        f"ml_sweeps_s{ismpl}_p{pid}.npz")
                    os.makedirs(checkpoint_dir, exist_ok=True)
                out = _chunked_ml(call, w0, h0, nb, m_pad,
                                  int(Itmax),
                                  int(checkpoint_every
                                      or compact_every),
                                  ckf, np_dtype, verbose)
            else:
                out = jax.tree.map(np.asarray, call(
                    w0, h0, jnp.zeros((nb, m_pad), jnp.int32),
                    jnp.zeros((nb,), jnp.int32),
                    jnp.full((nb,), -jnp.inf, dtype),
                    jnp.asarray(int(Itmax)), jnp.asarray(1)))
            groups = [(k, ranks[k],
                       [j for j, (kk, _) in enumerate(pairs)
                        if kk == k])
                      for k in owned]
            outs = None
        elif owned:
            x, run_kwargs = device_x(mat)
            groups = []
            outs = {}
            for k in owned:
                rank = ranks[k]
                if verbose > 0:
                    print(f"Rank {rank} [{k + 1}/{nrank}]")
                keys = jax.random.split(
                    jax.random.fold_in(key0, ismpl * nrank + k), nrun)
                w0, h0 = jax.vmap(
                    lambda kk: ml_ops.ml_init(kk, n, m_pad, rank,
                                              dtype))(keys)
                x, w0, h0 = place(x, w0, h0)
                batched = jax.vmap(
                    lambda w, h, c0, z0, l0, im, i0: ml_ops.ml_run(
                        x, w, h, itmax=im, tol=float(Tol),
                        criterion=criterion, it0=i0, lk0_init=l0,
                        cid0=c0, zstep0=z0,
                        ncnn_step=int(ncnn_step), **run_kwargs),
                    in_axes=(0, 0, 0, 0, 0, None, None))
                if checkpoint_every or compact_every:
                    ckf = None
                    if checkpoint_every and checkpoint_dir is not None:
                        ckf = os.path.join(
                            checkpoint_dir,
                            f"ml_sweeps_s{ismpl}_r{rank}_p{pid}.npz")
                        os.makedirs(checkpoint_dir, exist_ok=True)
                    outs[k] = _chunked_ml(
                        lambda *a: batched(*a[:-1]), w0, h0, nrun,
                        m_pad, int(Itmax),
                        int(checkpoint_every or compact_every), ckf,
                        np_dtype, verbose)
                else:
                    outs[k] = jax.tree.map(np.asarray, batched(
                        w0, h0,
                        jnp.zeros((nrun, m_pad), jnp.int32),
                        jnp.zeros((nrun,), jnp.int32),
                        jnp.full((nrun,), -jnp.inf, dtype),
                        jnp.asarray(int(Itmax)), jnp.asarray(1)))
                groups.append((k, rank, list(range(nrun))))
        else:
            groups = []

        if nproc > 1:
            # restart-granular merge: all-gather
            # every restart's hard assignment (m int32), likelihood
            # and sweep count, so every host accumulates the IDENTICAL
            # consensus even though one item's restarts now live on
            # different hosts; then replicate each rank's
            # best-likelihood factors from the restart's owner.
            nit_all = nrank * nrun
            loc_idx = np.asarray([k * nrun + i for k, i in pairs],
                                 np.int64)
            lkh_loc = (np.asarray(out.lkh, np.float64) if pairs
                       else np.zeros(0))
            nit_loc = (np.asarray(out.n_iter, np.float64) if pairs
                       else np.zeros(0))
            cid_loc = (np.asarray(out.cid)[:, :m] if pairs
                       else np.zeros((0, m), np.int32))
            lkh_glob = schedule.gather_results(
                lkh_loc, loc_idx, nit_all, process_count=nproc)
            nit_glob = schedule.gather_results(
                nit_loc, loc_idx, nit_all, fill=-1.0,
                process_count=nproc)
            cid_glob = schedule.gather_rows(
                cid_loc, loc_idx, nit_all, m, process_count=nproc)
            for k in range(nrank):
                rank = ranks[k]
                sl = slice(k * nrun, (k + 1) * nrun)
                imax, rmax, disp, coph, conav = consensus_stats(
                    list(cid_glob[sl]), list(lkh_glob[sl]),
                    list(nit_glob[sl]), f" rank {rank}",
                    quiet=(pid != 0))
                owner = ((ismpl * nrank + k) * nrun + imax) % nproc
                if owner == pid:
                    b = pairs.index((k, imax))
                    cand = dict(w=np.asarray(out.w[b][:, :rank]),
                                h=np.asarray(out.h[b][:rank, :m]))
                else:
                    cand = dict(w=np.zeros((n, rank)),
                                h=np.zeros((rank, m)))
                cand = schedule.exchange_winner(
                    cand, owner == pid, owner, process_count=nproc)
                local[k] = dict(rmax=rmax, disp=disp, coph=coph,
                                wmax=np.asarray(cand["w"]),
                                hmax=np.asarray(cand["h"]))
                conav_last = conav
                if verbose >= 1 and pid == 0:
                    print(f"Sample# {ismpl + 1}: rank {rank}: "
                          f"Max(likelihood) = {rmax:.6g}, dispersion"
                          f" = {disp:.6g}, cophenetic = {coph:.6g}")
            groups = []

        for k, rank, idxs in groups:
            o = out if outs is None else outs[k]
            # padded-rank instances: slice factors and clamp cids to
            # the true rank (padded rows are eps, never argmax)
            cids = [o.cid[b][:m] for b in idxs]
            lkhs = [o.lkh[b] for b in idxs]
            nits = [o.n_iter[b] for b in idxs]
            label = f" rank {rank}" if batch_ranks else ""
            imax, rmax, disp, coph, conav = consensus_stats(
                cids, lkhs, nits, label)
            local[k] = dict(
                rmax=rmax, disp=disp, coph=coph,
                wmax=np.asarray(o.w[idxs[imax]][:, :rank]),
                hmax=np.asarray(o.h[idxs[imax]][:rank, :m]))
            conav_last = conav
            if verbose >= 1:
                print(f"Sample# {ismpl + 1}: rank {rank}: "
                      f"Max(likelihood) = {rmax:.6g}, dispersion = "
                      f"{disp:.6g}, cophenetic = {coph:.6g}")

        if progress_file is not None:
            # under multi-host every rank's merged stats exist on
            # every host; store them all so restore needs no exchange
            for k in sorted(local):
                key = _prog_key(ismpl, k)
                progress[f"r_{key}"] = np.asarray(
                    [local[k]["rmax"], local[k]["disp"],
                     local[k]["coph"]], np.float64)
                progress[f"w_{key}"] = local[k]["wmax"]
                progress[f"h_{key}"] = local[k]["hmax"]
            np.savez(progress_file, **progress)

        for k in range(nrank):
            res = local[k]
            if ismpl == 0:
                wdat[k] = res["wmax"].copy()
                hdat[k] = res["hmax"].copy()
            else:
                wdat[k] += res["wmax"]
                hdat[k] += res["hmax"]
            rdat[k].append(float(res["rmax"]))
            ddat[k].append(float(res["disp"]))
            cdat[k].append(float(res["coph"]))

    if progress_file is not None and os.path.exists(progress_file):
        os.remove(progress_file)

    for k in range(nrank):
        wdat[k] /= nsmpl
        hdat[k] /= nsmpl

    rave = [float(np.mean(v)) for v in rdat]
    dave = [float(np.mean(v)) for v in ddat]
    cave = [float(np.mean(v)) for v in cdat]

    out_obj = obj[np.arange(obj.n_genes), np.arange(obj.n_cells)]
    out_obj.ranks = list(ranks)
    out_obj.basis = [np.asarray(w) for w in wdat]
    out_obj.coeff = [np.asarray(h) for h in hdat]
    out_obj.dbasis = [np.zeros_like(w) for w in wdat]
    out_obj.dcoeff = [np.zeros_like(h) for h in hdat]
    if randomize and nsmpl > 1:
        denom = np.sqrt(nsmpl - 1)
        rste = [float(np.std(v, ddof=1) / denom) for v in rdat]
        dste = [float(np.std(v, ddof=1) / denom) for v in ddat]
        cste = [float(np.std(v, ddof=1) / denom) for v in cdat]
        out_obj.measure = pd.DataFrame(dict(
            rank=ranks, likelihood=rave, r_se=rste, dispersion=dave,
            d_se=dste, cophenetic=cave, c_se=cste))
    else:
        out_obj.measure = pd.DataFrame(dict(
            rank=ranks, likelihood=rave, dispersion=dave,
            cophenetic=cave))
    if coph_ses:
        out_obj.metadata["cophenetic_se"] = coph_ses
        out_obj.metadata["cophenetic_subsampled"] = dict(
            max_cells=int(cophenetic_max_cells),
            nsub=int(cophenetic_nsub))
    if store_connectivity:
        out_obj.metadata.update(nrun=nrun, connectivity=conav_last)
    out_obj.validate()
    return out_obj
