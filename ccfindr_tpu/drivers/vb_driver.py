"""Variational-Bayes factorization driver.

JAX equivalent of reference vb_factorize / vb_iterate
(R/bayesian.R:229-390).  Key redesigns:

* Restarts are a **batch axis**: all ``nrun`` restarts of a rank run as
  one ``vmap``-ed ``lax.while_loop`` on device (replacing the
  reference's serial lapply / Rmpi::mpi.applyLB restart farm,
  R/bayesian.R:260-263).
* With a ``jax.sharding.Mesh``, the restart axis shards over the
  ``'runs'`` mesh axis and the cell axis of X/H over ``'cells'``;
  W stays replicated and XLA inserts the per-sweep all-reduces of
  ``rowSums(eh)``, the n x r sufficient-stat partials, and the scalar
  ELBO (SURVEY.md §5 communication-backend plan).
* Degeneracy (uniform basis column) is detected per run after
  convergence and masks that run's remaining ranks, mirroring the
  reference's rank-scan abort (R/bayesian.R:368-378) without host
  control flow inside jit.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

import jax
import jax.numpy as jnp

from ..container import SCSet
from ..ops import vb as vb_ops
from ..ops.vb import Hyper, VBState
from ..ops import consensus as cons
from ..utils import Timings


def _default_dtype():
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def _round_up(v, mult):
    return -(-v // mult) * mult


def _as_counts_matrix(obj, dtype):
    if isinstance(obj, SCSet):
        return obj.counts_dense(dtype=np.dtype(dtype))
    mat = np.asarray(obj, dtype=np.dtype(dtype))
    return mat


def _rank_ckpt_path(ckpt_dir, rank):
    import os
    return os.path.join(ckpt_dir, f"vb_rank{rank}.npz")


def _save_rank_ckpt(ckpt_dir, rank, rdat_col, imax, res):
    """Persist one completed rank: all runs' log evidences + the best
    run's factors/hyper (sweep-resume support; the reference has no
    checkpoint mechanism, SURVEY.md §5)."""
    import os
    os.makedirs(ckpt_dir, exist_ok=True)
    np.savez_compressed(
        _rank_ckpt_path(ckpt_dir, rank), rdat=rdat_col, imax=imax,
        ew=res["ew"], eh=res["eh"], dw=res["dw"], dh=res["dh"],
        hyper=np.asarray([res["hyper"][k] for k in
                          ("aw", "bw", "ah", "bh")]),
        n_iter=res["n_iter"], nunif=res["nunif"])


def _load_rank_ckpt(ckpt_dir, rank):
    import os
    if ckpt_dir is None:
        return None
    path = _rank_ckpt_path(ckpt_dir, rank)
    if not os.path.exists(path):
        return None
    d = np.load(path)
    hy = d["hyper"]
    res = dict(ew=d["ew"], eh=d["eh"], dw=d["dw"], dh=d["dh"],
               hyper=dict(aw=float(hy[0]), bw=float(hy[1]),
                          ah=float(hy[2]), bh=float(hy[3])),
               n_iter=int(d["n_iter"]), nunif=int(d["nunif"]))
    return d["rdat"], int(d["imax"]), res


def _chunked_vb(call, states, hypers, nb, itmax, every, ckpt_file,
                np_dtype, verbose, place=None, compact=True,
                stats=None):
    """Run a vmapped vb_run in sweep chunks with host checkpoints and
    converged-lane compaction.

    ``call(states, hypers, itmax, it0, lk0, lanes) -> VBRunResult``
    (vmapped over the rows of ``states``; ``lanes`` are the GLOBAL
    instance indices of those rows, so the caller can subset
    per-instance statics like rank masks).  After each chunk the full
    loop carry (states, hypers, per-instance lk0, absolute sweep
    index) is held host-side (and saved to ``ckpt_file`` when given);
    the next chunk resumes exactly via vb_run's it0/lk0_init
    continuation.

    Lanes whose stopping rule fired are FROZEN — their (state, lml,
    n_iter) equal the uninterrupted run's bit-for-bit — and with
    ``compact=True`` the next chunk re-packs only the LIVE lanes into
    a smaller batch (padded to the next power of two, so at most
    log2(nb) distinct batch sizes compile).  A heterogeneous rank
    sweep then stops paying full-batch sweeps for lanes that
    converged early.

    The global carry stays ON DEVICE between chunks when no
    checkpoint file is written (pure compaction): each chunk is ONE
    jitted gather -> run -> scatter call, so the only per-chunk host
    traffic is the small (n_iter, done) vectors.  The extra jit boundary lets XLA
    fuse differently, so recorded evidences can move at roundoff
    (factors unchanged in practice).  Checkpointed runs
    (``ckpt_file``) and mesh runs (``place``) use a host round-trip
    per chunk instead, which keeps them BIT-identical to the
    unchunked run — the documented checkpoint_every guarantee.
    """
    import functools
    import os

    from ..ops.vb import VBRunResult

    it0 = 1
    n_rec = np.full(nb, -1, np.int64)
    hf = np.zeros(nb, bool)
    last_niter = np.zeros(nb, np.int64)
    gs, gh = states, hypers         # device carry, full batch
    glml = jnp.zeros((nb,), np_dtype)
    if ckpt_file is not None and os.path.exists(ckpt_file):
        z = np.load(ckpt_file)
        it0 = int(z["it0"])
        n_rec = z["n_rec"]
        hf = z["hf"].astype(bool)
        last_niter = np.where(n_rec >= 0, n_rec, it0 - 1)
        gs = VBState(*(jnp.asarray(z[f"st_{f}"])
                       for f in VBState._fields))
        gh = Hyper(*(jnp.asarray(z[f"hy_{f}"])
                     for f in Hyper._fields))
        glml = jnp.asarray(z["lk0"]).astype(np_dtype)
        if verbose >= 1:
            print(f"Resumed sweep checkpoint at iteration {it0}")

    # no buffer donation: the initial state aliases arrays (ew and lw
    # share one buffer from vb_init_random) and XLA rejects donating
    # the same buffer twice
    @jax.jit
    def chunk_step(gs, gh, glml, lanes_j, end, it_0):
        st_l = jax.tree.map(lambda a: a[lanes_j], gs)
        hy_l = jax.tree.map(lambda a: a[lanes_j], gh)
        out = call(st_l, hy_l, end, it_0, glml[lanes_j], lanes_j)
        # compaction-padding rows duplicate a live lane bit-for-bit
        # (same carry, same mask), so scattering them back is a
        # benign same-value overwrite
        gs2 = jax.tree.map(lambda a, o: a.at[lanes_j].set(o),
                           gs, out.state)
        gh2 = jax.tree.map(lambda a, o: a.at[lanes_j].set(o),
                           gh, out.hyper)
        glml2 = glml.at[lanes_j].set(out.lml)
        return gs2, gh2, glml2, out.n_iter, out.done, out.hyper_failed

    fast = place is None and ckpt_file is None
    first = it0 == 1
    import time as _time
    t_last = _time.perf_counter()
    while True:
        end = min(it0 - 1 + every, itmax)
        live = np.nonzero(n_rec < 0)[0]
        if not first and len(live) == 0:
            break
        if first:
            lanes = np.arange(nb)
            nreal = nb
            first = False
        else:
            nreal = len(live)
            if compact:
                # power-of-two sizes, floored at nb/8: each size is a
                # fresh trace+compile of the chunk, and lanes below
                # nb/8 cost little to keep running padded
                size = 1 << max(0, int(nreal - 1).bit_length())
                size = min(max(size, max(1, nb // 8)), nb)
            else:
                size = nb
            pad = size - nreal
            lanes = np.concatenate(
                [live, np.repeat(live[:1], pad)]) if pad else live
        if fast:
            gs, gh, glml, o_niter, o_done, o_hf = chunk_step(
                gs, gh, glml, jnp.asarray(lanes), jnp.asarray(end),
                jnp.asarray(it0))
        else:
            # bit-exact path (checkpointing / mesh): host round-trip;
            # the chunk executes in the same eager fusion context as
            # the unchunked run
            st_l = jax.tree.map(
                lambda a: jnp.asarray(np.asarray(a)[lanes]), gs)
            hy_l = jax.tree.map(
                lambda a: jnp.asarray(np.asarray(a)[lanes]), gh)
            if place is not None:
                st_l, hy_l = place(st_l, hy_l)
            out = call(st_l, hy_l, jnp.asarray(end),
                       jnp.asarray(it0),
                       jnp.asarray(np.asarray(glml)[lanes]), lanes)
            out = jax.tree.map(np.asarray, out)
            gs = jax.tree.map(
                lambda a, o: jnp.asarray(
                    _scatter_rows(np.asarray(a), o, lanes, nreal)),
                gs, out.state)
            gh = jax.tree.map(
                lambda a, o: jnp.asarray(
                    _scatter_rows(np.asarray(a), o, lanes, nreal)),
                gh, out.hyper)
            glml = jnp.asarray(_scatter_rows(np.asarray(glml),
                                             out.lml, lanes, nreal))
            o_niter, o_done, o_hf = (out.n_iter, out.done,
                                     out.hyper_failed)
        o_niter = np.asarray(o_niter)
        o_done = np.asarray(o_done)
        if stats is not None:
            # executed rounds: the vmapped loop stops when every lane
            # in THIS chunk is done, which can be before the chunk
            # bound
            rounds = max(0, int(np.max(o_niter[:nreal])) - it0 + 1)
            stats["lane_sweeps"] = (stats.get("lane_sweeps", 0)
                                    + len(lanes) * rounds)
        hf[lanes[:nreal]] |= np.asarray(o_hf)[:nreal]
        last_niter[lanes[:nreal]] = o_niter[:nreal]
        # the done flag (stopping rule fired) disambiguates a lane
        # that converged EXACTLY at the chunk boundary (n_iter == end)
        # from one that merely ran out of chunk
        sel = (o_done[:nreal] | (o_niter[:nreal] < end)) \
            & (n_rec[lanes[:nreal]] < 0)
        n_rec[lanes[:nreal][sel]] = o_niter[:nreal][sel]
        if end >= itmax or (n_rec >= 0).all():
            break
        it0 = end + 1
        if ckpt_file is not None:
            save = dict(it0=it0, lk0=np.asarray(glml), n_rec=n_rec,
                        hf=hf)
            for f in VBState._fields:
                save[f"st_{f}"] = np.asarray(getattr(gs, f))
            for f in Hyper._fields:
                save[f"hy_{f}"] = np.asarray(getattr(gh, f))
            np.savez(ckpt_file, **save)
        if verbose >= 2:
            now = _time.perf_counter()
            print(f"checkpointed at sweep {end}: "
                  f"{int((n_rec >= 0).sum())}/{nb} converged"
                  + (f", batch compacted to {len(lanes)}"
                     if len(lanes) < nb else "")
                  + f" [{now - t_last:.2f}s]")
            t_last = now

    if ckpt_file is not None and os.path.exists(ckpt_file):
        os.remove(ckpt_file)
    return VBRunResult(
        state=jax.tree.map(np.asarray, gs),
        hyper=jax.tree.map(np.asarray, gh),
        lml=np.asarray(glml),
        n_iter=np.where(n_rec >= 0, n_rec, last_niter),
        hyper_failed=hf, done=n_rec >= 0)


def _scatter_rows(dst, src, lanes, nreal):
    res = np.array(dst)
    res[lanes[:nreal]] = src[:nreal]
    return res


def _place_sharded(x, states, hypers, mesh):
    """Lay out the batched problem on a device mesh: X cell-sharded,
    H-family cell-sharded, W-family replicated, restarts over 'runs'."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..ops.ell import EllCounts
    from ..ops.sparse import SparseCounts

    axes = mesh.axis_names
    runs = "runs" if "runs" in axes else None
    cells = "cells" if "cells" in axes else None
    genes = "genes" if "genes" in axes else None

    if isinstance(x, (SparseCounts, EllCounts)):
        # sharded nonzero layouts: every leaf carries a leading
        # shard axis, one shard of nonzeros per device on 'cells'
        x = jax.tree.map(
            lambda a: jax.device_put(
                a, NamedSharding(mesh, P(cells))), x)
    else:
        x = jax.device_put(x, NamedSharding(mesh, P(genes, cells)))
    specs = dict(ew=P(runs, genes, None), eh=P(runs, None, cells),
                 lw=P(runs, genes, None), lh=P(runs, None, cells),
                 dw=P(runs, genes, None), dh=P(runs, None, cells),
                 lkh=P(runs))
    states = VBState(**{
        f: jax.device_put(getattr(states, f), NamedSharding(mesh, specs[f]))
        for f in specs})
    hypers = Hyper(*(jax.device_put(leaf, NamedSharding(mesh, P(runs)))
                     for leaf in hypers))
    return x, states, hypers


def _record_multihost(out, my_idx, ranks, nrun, n, m, Tol, unif_stop,
                      verbose, nproc, pid, rdat, results, run_alive):
    """Merge a multi-host batched run into the (rdat, results) tables.

    Per-item log evidences and degeneracy counts are all-gathered so
    every host applies the IDENTICAL rank-scan-abort and best-of-run
    selection (reference semantics R/bayesian.R:268-291, 368-378);
    only the winning factors are exchanged
    (parallel.schedule.exchange_winner).
    """
    from ..parallel import schedule

    nrank = len(ranks)
    nb_all = nrank * nrun

    # local degeneracy counts (uniform basis columns at the TRUE rank)
    nunif_loc = np.empty(len(my_idx))
    for b, t in enumerate(np.asarray(my_idx)):
        rank = ranks[int(t) // nrun]
        ew = np.asarray(out.state.ew[b][:n, :rank])
        nunif_loc[b] = int(
            ((ew.max(axis=0) - ew.min(axis=0)) < float(Tol)).sum())

    lml_glob = schedule.gather_results(np.asarray(out.lml), my_idx,
                                       nb_all, process_count=nproc)
    nunif_glob = schedule.gather_results(nunif_loc, my_idx, nb_all,
                                         fill=-1.0,
                                         process_count=nproc)
    niter_glob = schedule.gather_results(
        np.asarray(out.n_iter, np.float64), my_idx, nb_all, fill=-1.0,
        process_count=nproc)

    # identical kill/record pass on every host
    for k, rank in enumerate(ranks):
        for i in range(nrun):
            if not run_alive[i]:
                continue
            t = k * nrun + i
            nunif_i = int(nunif_glob[t])
            if nunif_i > 0:
                if pid == 0:
                    print(f"Warning: Rank {rank} has {nunif_i} "
                          "constant column(s).")
                if unif_stop:
                    if pid == 0:
                        print("Warning: Rank scan stopped for rank >= "
                              f"{rank}")
                    if k == 0:
                        raise ValueError("Rerun with lower ranks")
                    run_alive[i] = False
                    continue
            rdat[i, k] = lml_glob[t]

    # exchange only each rank's winner
    local_pos = {int(t): b for b, t in enumerate(np.asarray(my_idx))}
    for k, rank in enumerate(ranks):
        if not np.isfinite(rdat[:, k]).any():
            continue
        imax = int(np.argmax(rdat[:, k]))
        t = k * nrun + imax
        owner = t % nproc                   # round-robin partition
        if owner == pid:
            b = local_pos[t]
            cand = dict(
                ew=np.asarray(out.state.ew[b][:n, :rank]),
                eh=np.asarray(out.state.eh[b][:rank, :m]),
                dw=np.asarray(out.state.dw[b][:n, :rank]),
                dh=np.asarray(out.state.dh[b][:rank, :m]),
                hyper=np.asarray([out.hyper.aw[b], out.hyper.bw[b],
                                  out.hyper.ah[b], out.hyper.bh[b]],
                                 np.float64))
        else:
            cand = dict(ew=np.zeros((n, rank)),
                        eh=np.zeros((rank, m)),
                        dw=np.zeros((n, rank)),
                        dh=np.zeros((rank, m)),
                        hyper=np.zeros(4))
        cand = schedule.exchange_winner(cand, owner == pid, owner,
                                        process_count=nproc)
        hy = cand["hyper"]
        results[imax][k] = dict(
            ew=cand["ew"], eh=cand["eh"], dw=cand["dw"],
            dh=cand["dh"],
            hyper=dict(aw=float(hy[0]), bw=float(hy[1]),
                       ah=float(hy[2]), bh=float(hy[3])),
            n_iter=int(niter_glob[t]), nunif=int(nunif_glob[t]))
        if verbose >= 2 and pid == 0:
            print(f"Rank = {rank}: best log(evidence) = "
                  f"{rdat[imax, k]:.6g} (run {imax + 1}, host "
                  f"{owner})")


def vb_factorize(object, ranks=2, nrun=1, verbose=2,
                 initializer="random", Itmax=10000,
                 hyper_update=(True, True, True, True),
                 gamma_a=1.0, gamma_b=1.0, Tol=1e-5,
                 hyper_update_n0=10, hyper_update_dn=1,
                 connectivity=False, fudge=None, unif_stop=True,
                 dtype=None, seed=0, mesh=None, backend="dense",
                 batch_ranks="auto", checkpoint_dir=None,
                 checkpoint_every=None, compact_every=None,
                 suffstats=None, data_term=None,
                 distributed="auto", svd_method="auto",
                 storage_dtype="auto", sparse_layout="auto",
                 elbo_every=1, precision="f32",
                 _process_count=None, _process_id=None):
    """Bayesian NMF inference of a count matrix.

    Parameters mirror the reference (R/bayesian.R:229-236) with
    accelerator-era replacements: ``ncores``/``useC`` are superseded by
    ``mesh`` (device mesh for runs x cells sharding) and ``backend``:

    * ``'dense'``       — XLA GEMM path (default; the parity oracle)
    * ``'dense_fused'`` — XLA path, one pass over X per sweep
      (deferred-ELBO loop, ops.vb.vb_run(fused=...))
    * ``'pallas'``      — the same deferred-ELBO loop over the fused
      X-pass GPU kernel (ops.pallas.xpass: wth and X/wth stay in
      registers; one read of X per sweep).  GPU only.
    * ``'sparse'``      — nonzero-only storage (no densification
      anywhere).  ``sparse_layout`` picks the device layout:
      ``'ell'`` (the ``'auto'`` default, single-device AND
      cell-sharded mesh) — dual gather-only hybrid ELL (ops.ell);
      ``'coo'`` — chunked COO scan.

    ``batch_ranks=True`` runs the ENTIRE rank sweep x restarts as one
    vmapped batch padded to max(ranks) with per-instance rank masks —
    one compilation and one device loop instead of len(ranks)
    sequential ones.  Works with every initializer: deterministic
    svd/svd2 inits are computed per rank on host and batched (and
    collapse nrun to 1, since identical restarts tie).  The default
    ``'auto'`` batches whenever there are multiple ranks and no
    checkpoint dir is given (checkpointing needs per-rank
    completion); pass False to force the sequential rank loop.

    ``checkpoint_every=K`` (with ``checkpoint_dir``) additionally
    checkpoints MID-RUN every K sweeps: the device loop executes in
    K-sweep chunks whose full carry (factors, hypers, per-instance
    ELBO, absolute sweep index) is persisted, so an interrupted
    multi-hour factorization resumes exactly where it stopped — with
    results bit-identical to an uninterrupted run (vb_run's it0 /
    lk0_init continuation is exact).  Works in both the batched and
    sequential rank paths.

    ``compact_every=K`` runs the device loop in K-sweep chunks WITHOUT
    writing checkpoint files, re-packing only still-running (rank,
    run) instances into a smaller batch at each boundary (padded to
    powers of two, so at most log2(batch) sizes compile).  The chunks
    run as single fused device calls, whose different XLA fusion
    context can move recorded evidences at float roundoff;
    ``checkpoint_every`` implies the same compaction through the
    bit-exact host-checkpointed path instead.  Convergence sweep
    counts tend to cluster within ~2x across ranks at reference
    tolerances, so there is often little converged-lane waste to
    recover and the chunking overhead (re-trace per batch size,
    dispatch per chunk) can dominate — profile before enabling.

    ``suffstats``/``data_term`` override the backend kernels directly.

    ``elbo_every=k`` (opt-in; backend='pallas', single device or
    cell-sharded mesh) evaluates the ELBO and convergence test only
    every k-th sweep, skipping the data term's O(n*m) logarithm on
    the others — stopping is conservative since the ELBO is monotone
    (at most k-1 extra sweeps vs the per-sweep rule).

    ``precision='bf16'`` (opt-in; backend='pallas', single device OR
    cell-sharded mesh) casts the sweep's three GEMM operands to bf16
    with f32 accumulation, which puts them on the tensor cores;
    ``'f32'`` keeps full float32 GEMMs (no TF32).  Converged factors
    move ~1e-3 relative; cluster assignments are unchanged
    (tests/test_xpass_loop.py).

    ``storage_dtype='auto'`` (the default) stores raw integer counts
    that fit int8/int16 compressed on device — mathematically EXACT
    (the kernels upcast in registers) and 4x/2x fewer bytes of X per
    sweep; floats, counts beyond int16, and the sparse backend keep
    the full-precision stream.  ``None`` opts out; an explicit integer
    dtype validates strictly (errors on float counts / overflow).

    Returns a new :class:`SCSet` with ranks/basis/dbasis/coeff/dcoeff
    and the measure table (rank, lml, aw, bw, ah, bh, nunif) filled.

    **Multi-host** (the replacement for the reference's
    Rmpi restart farm, R/bayesian.R:260-263): under a multi-process
    JAX runtime (``jax.distributed.initialize`` on each host — pass
    ``distributed=dict(coordinator_address=..., num_processes=...,
    process_id=...)`` to let the driver call it), the (rank, run)
    grid is round-robin partitioned across processes
    (parallel.schedule.partition_items); each host runs its share as
    one local batched sweep, per-item log evidences and degeneracy
    flags are all-gathered, every host performs the identical
    best-of-runs selection, and the winning factors are replicated
    (parallel.schedule.exchange_winner).  The returned SCSet is
    identical on every host, and identical to a single-host run with
    the same seed.  ``distributed='auto'`` (default) detects the
    process count.  Deterministic initializers partition over ranks
    only (each host computes the identical init for its owned ranks).
    """
    if np.isscalar(ranks):
        ranks = [int(ranks)]
    ranks = [int(r) for r in ranks]
    if dtype is None:
        dtype = _default_dtype()
    if initializer in ("svd", "svd2") and nrun > 1:
        # the reference runs nrun IDENTICAL deterministic restarts
        # (vb_init is deterministic for svd/svd2, R/bayesian.R:334-335)
        # and best-of-nrun then picks that one result; a single
        # restart reproduces it at 1/nrun the cost
        if verbose >= 1:
            print(f"Note: initializer={initializer!r} is "
                  "deterministic; running 1 restart (the reference's "
                  f"{nrun} would be identical).")
        nrun = 1

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
    if nproc > 1:
        # the (rank, run) item grid partitions across hosts; with a
        # deterministic initializer nrun is already 1 and each host
        # computes the (identical) init for its owned ranks
        batch_ranks = True

    if isinstance(object, SCSet):
        obj = object
    else:
        obj = SCSet(count=object, remove_zeros=False)
    if backend == "sparse":
        # NO densification anywhere: guards, shapes and the device
        # layout all come from the CSR (the reference densifies before
        # every sweep, as.matrix at R/bayesian.R:339; its only
        # no-densify precedent is the save.memory VMR,
        # R/utils.R:197-218 — here the whole path stays sparse)
        import scipy.sparse as sp
        mat = sp.csr_matrix(obj.counts)
        n, m = mat.shape
        if (np.asarray(mat.sum(axis=1)).ravel() == 0).any():
            raise ValueError("Input matrix contains empty rows")
        if (np.asarray(mat.sum(axis=0)).ravel() == 0).any():
            raise ValueError("Input matrix contains empty columns")
    else:
        mat = _as_counts_matrix(obj, dtype)
        n, m = mat.shape
        if (mat.sum(axis=1) == 0).any():
            raise ValueError("Input matrix contains empty rows")
        if (mat.sum(axis=0) == 0).any():
            raise ValueError("Input matrix contains empty columns")

    ranks = [r for r in ranks if r <= m]
    for r in ranks:
        if r > min(n, m):
            raise ValueError("Rank exceeded min(nrow,ncol)")

    gamma_a = np.atleast_1d(np.asarray(gamma_a, dtype=float))
    gamma_b = np.atleast_1d(np.asarray(gamma_b, dtype=float))
    aw0, ah0 = float(gamma_a[0]), float(gamma_a[-1])
    bw0, bh0 = float(gamma_b[0]), float(gamma_b[-1])
    hyper_mask = tuple(bool(b) for b in hyper_update)

    key = jax.random.PRNGKey(seed)

    run_kwargs = dict(tol=float(Tol), fudge=fudge,
                      hyper_mask=hyper_mask, n0=int(hyper_update_n0),
                      dn=int(hyper_update_dn))
    itmax = int(Itmax)
    np_dtype = np.dtype(np.zeros((), np.dtype(jnp.zeros((), dtype).dtype)).dtype)
    if precision not in ("f32", "bf16"):
        raise ValueError(f"unknown precision {precision!r}")
    if precision == "bf16" and backend != "pallas":
        raise ValueError("precision='bf16' is supported by "
                         "backend='pallas' (single device or "
                         "cell-sharded mesh)")
    if elbo_every != 1 and backend != "pallas":
        raise ValueError("elbo_every is supported by backend='pallas' "
                         "(single device or cell-sharded mesh)")
    # the X-pass kernel's tile sizes: a mesh pads every shard of X to
    # whole tiles once, so no sweep copies X
    tile_n, tile_m = 1, 1
    if backend == "pallas":
        from ..ops.pallas import xpass as xk
        if mesh is not None:
            tile_n, tile_m = xk.BN, xk.BM
    # mesh mode: pad the cell axis to the 'cells' axis size and mask —
    # masked padding contributes exactly nothing (ops.vb.vb_sweep)
    m_pad = m
    cell_mask = None
    if mesh is not None and "cells" in mesh.axis_names:
        ncells_ax = mesh.shape["cells"]
        m_pad = ncells_ax * _round_up(-(-m // ncells_ax), tile_m)
        if m_pad != m:
            if backend != "sparse":
                mat = np.pad(mat, ((0, 0), (0, m_pad - m)))
            cell_mask = jnp.asarray(
                (np.arange(m_pad) < m).astype(np.dtype(dtype)))
            run_kwargs["cell_mask"] = cell_mask
            run_kwargs["m_true"] = m
    # gene-axis sharding (TP dual): pad the gene axis to the 'genes'
    # axis size; padded X rows are 0 and the masked posterior pins
    # padded lw rows at 1 (X-pass contract) and ew/dw rows at 0
    n_pad = n
    gene_mask = None
    if (mesh is not None and "genes" in mesh.axis_names
            and mesh.shape["genes"] > 1):
        if backend == "sparse":
            raise ValueError("gene-axis sharding applies to the dense "
                             "layouts; the sparse layouts shard cells")
        ng_ax = mesh.shape["genes"]
        n_pad = ng_ax * _round_up(-(-n // ng_ax), tile_n)
        if n_pad != n:
            mat = np.pad(mat, ((0, n_pad - n), (0, 0)))
            gene_mask = jnp.asarray(
                (np.arange(n_pad) < n).astype(np.dtype(dtype)))
            run_kwargs["gene_mask"] = gene_mask
            run_kwargs["n_true"] = n
    elif mesh is not None and backend == "pallas":
        # replicated genes: zero rows up to whole tiles (the kernel
        # pads the factors to X's extent; the state keeps n rows)
        mat = np.pad(mat, ((0, _round_up(n, tile_n) - n), (0, 0)))

    # compressed integer X storage: UMI counts are small ints, so an
    # int8/int16 device layout cuts X's device footprint and the bytes
    # each sweep reads 4x/2x with EXACT math (the kernels upcast in
    # registers).  'auto' (the default): raw integer counts that fit
    # get the compressed layout, floats/overflow/sparse keep the
    # full-precision stream; explicit dtypes keep strict validation.
    dev_dtype = dtype
    if isinstance(storage_dtype, str) and storage_dtype == "auto":
        from ..utils import auto_storage_dtype
        storage_dtype = (None if backend == "sparse"
                         else auto_storage_dtype(mat))
    if storage_dtype is not None:
        sd = np.dtype(storage_dtype)
        if backend == "sparse":
            raise ValueError("storage_dtype applies to the dense "
                             "layouts; the sparse backend already "
                             "stores only nonzeros")
        if sd.kind not in "iu":
            raise ValueError("storage_dtype must be an integer dtype")
        if np.any(mat != np.round(mat)):
            raise ValueError(
                "storage_dtype requires integer counts (normalized "
                "matrices are float — factorize raw counts instead)")
        if float(mat.max()) > np.iinfo(sd).max:
            raise ValueError(
                f"counts up to {mat.max():.0f} overflow "
                f"storage_dtype {sd.name}; use a wider type")
        dev_dtype = sd

    if backend == "dense":
        x = jnp.asarray(mat, dev_dtype)
    elif backend == "dense_fused":
        x = jnp.asarray(mat, dev_dtype)
        run_kwargs["fused"] = vb_ops.fused_dense
    elif backend == "pallas":
        # the deferred-ELBO loop (ops.vb.vb_run) over the fused X-pass
        # kernel; posterior update and hyper Newton run in XLA
        if mesh is not None and "cells" in mesh.axis_names:
            from ..parallel.sharded import make_fused_sharded
            x = jnp.asarray(mat, dev_dtype)
            run_kwargs["fused"] = make_fused_sharded(
                mesh, precision=precision)
        else:
            x = xk.pad_matrix(jnp.asarray(mat, dev_dtype))
            run_kwargs["fused"] = xk.make_vb_backend(precision)
        if elbo_every != 1:
            run_kwargs["elbo_every"] = int(elbo_every)
    elif backend == "sparse":
        from ..ops import ell as ek
        from ..ops import sparse as sk
        if sparse_layout not in ("auto", "ell", "coo"):
            raise ValueError(f"unknown sparse_layout {sparse_layout!r}")
        if mesh is not None and "cells" in mesh.axis_names:
            # cell-sharded nonzeros: each device touches only its own
            # cells'; psum of the n x r suffstat partial + scalar
            # ELBO (same collective pattern as the dense mesh path)
            if sparse_layout == "coo":
                from ..parallel.sharded import make_sparse_fused_sharded
                x = sk.from_scipy_sharded(mat, mesh.shape["cells"],
                                          m_pad=m_pad, dtype=dtype)
                run_kwargs["fused"] = make_sparse_fused_sharded(mesh)
            else:
                from ..parallel.sharded import make_ell_fused_sharded
                x = ek.from_scipy_ell_sharded(mat, mesh.shape["cells"],
                                              m_pad=m_pad, dtype=dtype)
                run_kwargs["fused"] = make_ell_fused_sharded(mesh)
        elif sparse_layout == "coo":
            x = sk.from_scipy(mat, dtype=dtype)
            run_kwargs["fused"] = sk.make_sparse_fused()
        else:
            x = ek.from_scipy_ell(mat, dtype=dtype)
            run_kwargs["fused"] = ek.make_ell_fused()
    else:
        raise ValueError(f"unknown backend {backend!r}")
    if suffstats is not None or data_term is not None:
        # explicit kernels replace the backend's fused X-pass
        run_kwargs.pop("fused", None)
        if suffstats is not None:
            run_kwargs["suffstats"] = suffstats
        if data_term is not None:
            run_kwargs["data_term"] = data_term
    run_fn = vb_ops.vb_run

    def _pad_state_mesh(st):
        """Pad an unbatched state to the mesh cell/gene extents
        (masked to exactly nothing inside vb_run)."""
        if m_pad != m:
            pad = ((0, 0), (0, m_pad - m))
            st = st._replace(eh=jnp.pad(st.eh, pad),
                             dh=jnp.pad(st.dh, pad),
                             lh=jnp.pad(st.lh, pad,
                                        constant_values=1.0))
        if n_pad != n:
            pad = ((0, n_pad - n), (0, 0))
            st = st._replace(ew=jnp.pad(st.ew, pad),
                             dw=jnp.pad(st.dw, pad),
                             lw=jnp.pad(st.lw, pad,
                                        constant_values=1.0))
        return st

    def _pad_state_rank(st, rmax_):
        """Pad a rank-r state to rmax_ components; padded entries are
        re-masked by vb_run's rank_mask handling, so the fill values
        (0 / 1) only need to be benign."""
        r0 = st.ew.shape[1]
        if r0 == rmax_:
            return st
        pw = ((0, 0), (0, rmax_ - r0))
        ph = ((0, rmax_ - r0), (0, 0))
        return st._replace(
            ew=jnp.pad(st.ew, pw), dw=jnp.pad(st.dw, pw),
            lw=jnp.pad(st.lw, pw, constant_values=1.0),
            eh=jnp.pad(st.eh, ph), dh=jnp.pad(st.dh, ph),
            lh=jnp.pad(st.lh, ph, constant_values=1.0))

    def _init_random_padded(kk, rank, h1):
        # draw the random state at the TRUE shape, then pad to the
        # mesh axes — so a padded mesh run consumes the exact same
        # random stream as a single-device run (padding is masked to
        # nothing inside vb_run either way)
        st = vb_ops.vb_init_random(kk, n, m, rank, h1, dtype)
        if m_pad != m:
            pad = ((0, 0), (0, m_pad - m))
            st = st._replace(eh=jnp.pad(st.eh, pad),
                             dh=jnp.pad(st.dh, pad),
                             lh=jnp.pad(st.lh, pad,
                                        constant_values=1.0))
        if n_pad != n:
            pad = ((0, n_pad - n), (0, 0))
            st = st._replace(ew=jnp.pad(st.ew, pad),
                             dw=jnp.pad(st.dw, pad),
                             lw=jnp.pad(st.lw, pad,
                                        constant_values=1.0))
        return st

    timings = Timings()
    nrank = len(ranks)
    # per (run, rank) log-evidence; -inf marks missing/degenerate
    rdat = np.full((nrun, nrank), -np.inf)
    results = [[None] * nrank for _ in range(nrun)]
    run_alive = np.ones(nrun, dtype=bool)
    # running per-rank connectivity mean across restarts (the
    # reference INTENDS dispersion of the across-run mean — its code
    # re-zeroes conav inside a single-run worker and divides by irun,
    # R/bayesian.R:328-330,353-357, a latent bug; here the running
    # mean is accumulated correctly)
    conav_acc = {}

    def _record(out, b, i, k, rank):
        """Record one converged (run, rank) instance; returns False and
        kills the run on degeneracy (reference R/bayesian.R:368-378)."""
        ew = np.asarray(out.state.ew[b][:n, :rank])
        eh = np.asarray(out.state.eh[b][:rank, :m])
        unif_i = (ew.max(axis=0) - ew.min(axis=0)) < float(Tol)
        nunif_i = int(unif_i.sum())
        if nunif_i > 0:
            cols = np.nonzero(unif_i)[0] + 1
            print(f"Warning: Rank {rank} column "
                  f"{','.join(map(str, cols))} constant.")
            if unif_stop:
                print(f"Warning: Rank scan stopped for rank >= {rank}")
                if k == 0:
                    raise ValueError("Rerun with lower ranks")
                run_alive[i] = False
                return False
        lml = float(out.lml[b])
        rdat[i, k] = lml
        results[i][k] = dict(
            ew=ew, eh=eh,
            dw=np.asarray(out.state.dw[b][:n, :rank]),
            dh=np.asarray(out.state.dh[b][:rank, :m]),
            hyper=dict(aw=float(out.hyper.aw[b]),
                       bw=float(out.hyper.bw[b]),
                       ah=float(out.hyper.ah[b]),
                       bh=float(out.hyper.bh[b])),
            n_iter=int(out.n_iter[b]), nunif=nunif_i)
        if connectivity:
            cnn = cons.connectivity(h=eh)
            acc, cnt = conav_acc.get(rank, (0.0, 0))
            conav_acc[rank] = (acc + cnn, cnt + 1)
        if verbose >= 2:
            msg = (f"Rank = {rank}: Nsteps = {int(out.n_iter[b])}, "
                   f"log(evidence) = {lml:.6g}, hyper = "
                   f"({out.hyper.aw[b]:.4g},{out.hyper.bw[b]:.4g},"
                   f"{out.hyper.ah[b]:.4g},{out.hyper.bh[b]:.4g})")
            if connectivity:
                acc, cnt = conav_acc[rank]
                disp = cons.dispersion(acc / cnt, m)
                msg += f", dispersion = {disp:.6g}"
            print(msg)
        return True

    if batch_ranks == "auto":
        batch_ranks = (len(ranks) > 1
                       and (checkpoint_dir is None
                            or checkpoint_every is not None))
    if batch_ranks:
        # one vmapped batch over ALL (rank, run) instances, padded to
        # max(ranks) with per-instance rank masks; under multi-host,
        # over THIS process's round-robin share of the instance grid
        from ..parallel import schedule
        rmax_ = max(ranks)
        nb_all = nrank * nrun
        rank_arr_all = np.repeat(np.asarray(ranks, np.int64), nrun)
        key, sub = jax.random.split(key)
        keys_all = jax.random.split(sub, nb_all)
        my_idx = (schedule.partition_items(nb_all, nproc, pid)
                  if nproc > 1 else np.arange(nb_all))
        nb = len(my_idx)
        if nb == 0:
            # This process owns no (rank, run) items (nproc > grid
            # size under the round-robin partition).  It must still
            # join every collective exchange below, or the owning
            # hosts deadlock in the all-gather — so skip the local
            # batch and go straight to the merge with an empty result
            # set (the Rmpi analog of an idle worker).
            if verbose >= 1:
                print(f"process {pid}: idle ({nb_all} (rank, run) "
                      f"items across {nproc} processes)")

            class _EmptyOut:          # only .lml/.n_iter are read
                lml = np.zeros(0)     # when my_idx is empty
                n_iter = np.zeros(0, np.int64)

            _record_multihost(_EmptyOut(), my_idx, ranks, nrun, n, m,
                              Tol, unif_stop, verbose, nproc, pid,
                              rdat, results, run_alive)
            ranks_iter = []
            body = False
        else:
            body = True
        if body:
            rank_arr = rank_arr_all[my_idx]
            keys = keys_all[my_idx]
            h1 = Hyper(aw=aw0, bw=bw0, ah=ah0, bh=bh0)
            if initializer == "random":
                states = jax.vmap(
                    lambda kk: _init_random_padded(kk, rmax_, h1))(keys)
            else:
                # deterministic per-rank inits (nrun is 1 here), each
                # padded to rmax_; the fill values are re-masked by
                # vb_run's rank_mask handling (reference computes vb_init
                # per (run, rank), R/bayesian.R:334-335)
                per_rank = {}
                for t in my_idx:
                    rank = ranks[int(t) // nrun]
                    if rank not in per_rank:
                        st = vb_ops.vb_init_svd(
                            mat, rank, h1, variant=initializer,
                            dtype=dtype, method=svd_method, seed=seed)
                        per_rank[rank] = _pad_state_mesh(
                            _pad_state_rank(st, rmax_))
                states = jax.tree.map(
                    lambda *xs: jnp.stack(xs),
                    *(per_rank[ranks[int(t) // nrun]] for t in my_idx))
            hyper0 = Hyper(aw=jnp.full((nb,), aw0, dtype),
                           bw=jnp.full((nb,), bw0, dtype),
                           ah=jnp.full((nb,), ah0, dtype),
                           bh=jnp.full((nb,), bh0, dtype))
            rmask = jnp.asarray(
                (np.arange(rmax_)[None, :] < rank_arr[:, None]
                 ).astype(np_dtype))
            rtrue = jnp.asarray(rank_arr.astype(np_dtype))
            xdev = x
            if mesh is not None:
                xdev, states, hyper0 = _place_sharded(x, states, hyper0,
                                                      mesh)
            batched = jax.vmap(
                lambda st, hy, rm, rt, l0, im, i0: run_fn(
                    xdev, st, hy, rank_mask=rm, r_true=rt, itmax=im,
                    it0=i0, lk0_init=l0, **run_kwargs),
                in_axes=(0, 0, 0, 0, 0, None, None))

            def call(st, hy, im, i0, l0, lanes=None):
                rm, rt = rmask, rtrue
                if lanes is not None:
                    # compacted lanes are reordered even when their count
                    # equals nb; lanes may be traced (the chunker's fused
                    # device step) — jnp gather works either way
                    rm, rt = rmask[lanes], rtrue[lanes]
                return batched(st, hy, rm, rt, l0, im, i0)

            place = ((lambda st, hy: _place_sharded(x, st, hy, mesh)[1:])
                     if mesh is not None else None)
            with timings.phase("vb_rank_batch", ranks=list(ranks),
                               nrun=nrun):
                every_eff = checkpoint_every or compact_every
                chunk_stats = {}
                if every_eff:
                    import os
                    ckf = None
                    if checkpoint_every and checkpoint_dir is not None:
                        ckname = ("vb_sweeps_batch.npz" if nproc == 1
                                  else f"vb_sweeps_batch_p{pid}.npz")
                        ckf = os.path.join(checkpoint_dir, ckname)
                        os.makedirs(checkpoint_dir, exist_ok=True)
                    out = _chunked_vb(call, states, hyper0, nb, itmax,
                                      int(every_eff), ckf, np_dtype,
                                      verbose, place=place,
                                      stats=chunk_stats)
                else:
                    out = call(states, hyper0, jnp.asarray(itmax),
                               jnp.asarray(1),
                               jnp.zeros((nb,), dtype))
                out = jax.tree.map(np.asarray, out)
            timings.records[-1]["total_sweeps"] = int(out.n_iter.sum())
            # device work actually executed: the vmapped loop runs every
            # lane until ALL stop, so the plain path pays nb * the max
            # sweep count; chunked/compacted paths count exactly
            _ls = chunk_stats.get("lane_sweeps")   # 0 is a legitimate value
            timings.records[-1]["lane_sweeps_executed"] = (
                _ls if _ls is not None
                else nb * (int(np.max(out.n_iter)) + 1))
            if np.asarray(out.hyper_failed).any():
                print("Warning: hyperparameter update did not converge "
                      "in some runs")   # reference raises, R/bayesian.R:43
            if nproc > 1:
                _record_multihost(out, my_idx, ranks, nrun, n, m, Tol,
                                  unif_stop, verbose, nproc, pid, rdat,
                                  results, run_alive)
            else:
                for k, rank in enumerate(ranks):
                    for i in range(nrun):
                        if run_alive[i]:
                            _record(out, k * nrun + i, i, k, rank)
            ranks_iter = []
    else:
        ranks_iter = list(enumerate(ranks))

    for k, rank in ranks_iter:
        if not run_alive.any():
            break
        if verbose == 1:
            # rank-scan progress for long sweeps (reference
            # txtProgressBar, R/factorize.R:174-185); verbose>=2
            # already prints per-rank detail lines
            print(f"[{k + 1}/{nrank}] rank {rank} ...", flush=True)
        # keep the key stream identical whether or not ranks restore
        key, sub = jax.random.split(key)
        ckpt = _load_rank_ckpt(checkpoint_dir, rank)
        if ckpt is not None and len(ckpt[0]) == nrun:
            rdat_col, imax, res = ckpt
            rdat[:, k] = rdat_col
            results[imax][k] = res
            if verbose >= 1:
                print(f"Rank = {rank}: restored from checkpoint")
            continue
        hyper0 = Hyper(aw=jnp.full((nrun,), aw0, dtype),
                       bw=jnp.full((nrun,), bw0, dtype),
                       ah=jnp.full((nrun,), ah0, dtype),
                       bh=jnp.full((nrun,), bh0, dtype))
        if initializer == "random":
            keys = jax.random.split(sub, nrun)
            h1 = Hyper(aw=aw0, bw=bw0, ah=ah0, bh=bh0)
            states = jax.vmap(
                lambda kk: _init_random_padded(kk, rank, h1))(keys)
        else:
            st = vb_ops.vb_init_svd(mat, rank,
                                    Hyper(aw=aw0, bw=bw0, ah=ah0, bh=bh0),
                                    variant=initializer, dtype=dtype,
                                    method=svd_method, seed=seed)
            st = _pad_state_mesh(st)
            states = jax.tree.map(lambda a: a[None], st)

        xdev = x
        if mesh is not None:
            xdev, states, hyper0 = _place_sharded(x, states, hyper0, mesh)

        batched = jax.vmap(
            lambda st, hy, l0, im, i0: run_fn(
                xdev, st, hy, itmax=im, it0=i0, lk0_init=l0,
                **run_kwargs),
            in_axes=(0, 0, 0, None, None))

        def call(st, hy, im, i0, l0, lanes=None):
            return batched(st, hy, l0, im, i0)

        place = ((lambda st, hy: _place_sharded(x, st, hy, mesh)[1:])
                 if mesh is not None else None)
        with timings.phase("vb_rank", rank=rank, nrun=nrun):
            if checkpoint_every or compact_every:
                import os
                ckf = None
                if checkpoint_every and checkpoint_dir is not None:
                    ckf = os.path.join(checkpoint_dir,
                                       f"vb_sweeps_rank{rank}.npz")
                    os.makedirs(checkpoint_dir, exist_ok=True)
                out = _chunked_vb(call, states, hyper0, nrun, itmax,
                                  int(checkpoint_every
                                      or compact_every), ckf,
                                  np_dtype, verbose, place=place)
            else:
                out = call(states, hyper0, jnp.asarray(itmax),
                           jnp.asarray(1),
                           jnp.zeros((nrun,), dtype))
            out = jax.tree.map(np.asarray, out)
        timings.records[-1]["total_sweeps"] = int(out.n_iter.sum())
        if np.asarray(out.hyper_failed).any():
            print("Warning: hyperparameter update did not converge "
                  "in some runs")   # reference raises, R/bayesian.R:43

        for i in range(nrun):
            if run_alive[i]:
                _record(out, i, i, k, rank)

        if checkpoint_dir is not None and np.isfinite(rdat[:, k]).any():
            imax = int(np.argmax(rdat[:, k]))
            _save_rank_ckpt(checkpoint_dir, rank, rdat[:, k], imax,
                            results[imax][k])

    # best-of-nrun selection per rank (reference R/bayesian.R:268-291)
    ranks2, lmls, basis, dbasis, coeff, dcoeff = [], [], [], [], [], []
    awd, bwd, ahd, bhd, nunifd = [], [], [], [], []
    for k, rank in enumerate(ranks):
        if not np.isfinite(rdat[:, k]).any():
            continue
        imax = int(np.argmax(rdat[:, k]))
        res = results[imax][k]
        ranks2.append(rank)
        lmls.append(rdat[imax, k])
        basis.append(np.asarray(res["ew"]))
        coeff.append(np.asarray(res["eh"]))
        dbasis.append(np.sqrt(np.asarray(res["dw"])))
        dcoeff.append(np.sqrt(np.asarray(res["dh"])))
        awd.append(res["hyper"]["aw"])
        bwd.append(res["hyper"]["bw"])
        ahd.append(res["hyper"]["ah"])
        bhd.append(res["hyper"]["bh"])
        nunifd.append(res["nunif"])

    out_obj = obj[np.arange(obj.n_genes), np.arange(obj.n_cells)]
    out_obj.ranks = ranks2
    out_obj.basis = basis
    out_obj.dbasis = dbasis
    out_obj.coeff = coeff
    out_obj.dcoeff = dcoeff
    out_obj.measure = pd.DataFrame(dict(
        rank=ranks2, lml=lmls, aw=awd, bw=bwd, ah=ahd, bh=bhd,
        nunif=nunifd))
    out_obj.metadata["timings"] = timings.summary()
    out_obj.validate()
    return out_obj
