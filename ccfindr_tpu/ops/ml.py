"""Maximum-likelihood (Lee–Seung KL) NMF kernels in JAX.

Redesign of the reference's ML path (R/factorize.R:2-49) for an
accelerator: one multiplicative sweep = 4 rank-r GEMMs; the convergence loop
is a ``lax.while_loop`` batched over restarts with ``vmap``.

The 'connectivity' stopping criterion compares hard cluster partitions
between consecutive sweeps.  The reference materializes the
m(m-1)/2 comembership vector (R/factorize.R:51-59); here partition
equality is decided from the r x r contingency table (two partitions
induce identical comembership iff the table is a sub-permutation), so
the criterion costs O(m + r^2) instead of O(m^2) and fits in jit.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax


def _dot(a, b):
    acc = jnp.promote_types(a.dtype, jnp.float32)
    return lax.dot(a, b, precision=lax.Precision.HIGHEST,
                   preferred_element_type=acc)


def ml_sweep(x, w, h, eps, pn=0.0, pd=0.0, rank_mask=None):
    """One KL multiplicative update of H then W
    (reference nmf_updateR, R/factorize.R:2-27).

    ``pn``/``pd`` are the optional gamma-prior MAP terms
    (pn = gamma_a - 1 added to the numerators, pd = gamma_a/gamma_b to
    the denominators; reference R/factorize.R:9-22 — note the
    reference's own driver never enables them, quirk (e) of SURVEY
    §7.3; here ``factorize(prior=True)`` does).

    ``rank_mask`` (r_pad,) pins padded rank components at ``eps`` for
    batched rank sweeps; their contribution to W@H is eps^2 per
    element, below float32 resolution.
    """
    h = (h * _dot(w.T, x / _dot(w, h)) + pn) \
        / (jnp.sum(w, axis=0)[:, None] + pd)
    h = jnp.maximum(h, eps)
    if rank_mask is not None:
        h = jnp.where(rank_mask[:, None] > 0, h, eps)
    w = (w * _dot(x / _dot(w, h), h.T) + pn) \
        / (jnp.sum(h, axis=1)[None, :] + pd)
    w = jnp.maximum(w, eps)
    if rank_mask is not None:
        w = jnp.where(rank_mask[None, :] > 0, w, eps)
    return w, h


def likelihood(x, w, h, lgx_zero_term):
    """Per-element Poisson log-likelihood, KL form
    (reference R/factorize.R:40-49).

    ``lgx_zero_term`` = sum_{x>0}(-x log x + x), a per-dataset constant
    hoisted out of the loop.
    """
    wh = _dot(w, h)
    val = jnp.sum(x * jnp.log(wh) - wh) + lgx_zero_term
    return val / (x.shape[0] * x.shape[1])


def likelihood_const(x, dtype=None):
    """The data-only term sum_{x>0}(-x log x + x) of the likelihood.
    ``x`` may be a flat nonzero-values vector (sparse layouts) — zeros
    contribute 0 either way."""
    if dtype is not None:
        x = x.astype(dtype)
    xl = jnp.where(x > 0, -x * jnp.log(jnp.where(x > 0, x, 1.0)) + x, 0.0)
    return jnp.sum(xl)


def _xvals(x):
    """Dense array or the .val nonzeros of a sparse-layout pytree."""
    return x.val if isinstance(x, tuple) and hasattr(x, "val") else x


def hard_assign(h) -> jax.Array:
    """argmax cluster id per cell (0-based)."""
    return jnp.argmax(h, axis=0).astype(jnp.int32)


def partitions_equal(cid0, cid1, r: int) -> jax.Array:
    """True iff two hard assignments induce the same comembership.

    Builds the r x r contingency table; the partitions are equal iff
    every nonzero row and column of the table has exactly one nonzero
    entry.
    """
    idx = cid0 * r + cid1
    tab = jnp.zeros((r * r,), jnp.int32).at[idx].add(1).reshape(r, r)
    nz = tab > 0
    rows_ok = jnp.all(jnp.sum(nz, axis=1) <= 1)
    cols_ok = jnp.all(jnp.sum(nz, axis=0) <= 1)
    return rows_ok & cols_ok


class MLRunResult(NamedTuple):
    w: jax.Array
    h: jax.Array
    lkh: jax.Array
    n_iter: jax.Array
    cid: jax.Array
    # connectivity-criterion streak counter at exit (0 under the
    # likelihood criterion) — part of the resume carry for sweep-level
    # checkpointing (drivers.ml_driver checkpoint_every)
    zstep: jax.Array
    # True iff the stopping rule fired (vs the sweep bound running
    # out) — see ops.vb.VBRunResult.done
    done: jax.Array


def ml_h_dense(x, w, h):
    """Single-pass fused H-phase (XLA): H-update numerator w^T(x/wh)
    plus sum x*log(wh) — the likelihood data term for the same (w, h).
    The remaining -sum(wh) reduces in rank space outside."""
    wh = _dot(w, h)
    return _dot(w.T, x / wh), jnp.sum(x * jnp.log(wh))


def ml_w_dense(x, w, h):
    """Fused W-phase (XLA): W-update numerator (x/wh) h^T."""
    return _dot(x / _dot(w, h), h.T)


@partial(jax.jit, static_argnames=("criterion", "ncnn_step",
                                   "fused_h", "fused_w", "nm_true"))
def ml_run(x, w0, h0, *, itmax=10000, tol: float = 1e-5,
           criterion: str = "likelihood", ncnn_step: int = 40,
           fused_h=None, fused_w=None, nm_true=None,
           pn=0.0, pd=0.0, rank_mask=None,
           it0=1, lk0_init=None, cid0=None, zstep0=None
           ) -> MLRunResult:
    """Iterate ml_sweep to convergence for one restart
    (reference driver loop R/factorize.R:187-213).

    criterion='likelihood': stop when |lkold - lk| < tol*|lkold|.
    criterion='connectivity': stop after ``ncnn_step`` consecutive
    sweeps with an unchanged hard-cluster partition.

    ``fused_h``/``fused_w``, if given, are single-pass kernels
    (ops.pallas.xpass.MLXPass or the ml_*_dense pair above):
    ``fused_h(x, w, h) -> (hn, xlogwh)`` and
    ``fused_w(x, w, h') -> wn``.  The loop then evaluates the
    likelihood of sweep t inside sweep t+1's H pass (same (w, h)),
    bringing a sweep + likelihood from 3 passes over X down to 2, with
    the identical stopping sequence, lkh, n_iter, and final factors.
    ``x`` may then be pre-padded to tile boundaries; pass the true
    (n, m) via ``nm_true``.

    ``it0``/``lk0_init``/``cid0``/``zstep0`` resume a previously
    bounded run (the VB twin of vb_run's continuation): pass the prior
    call's ``n_iter + 1``, ``lkh``, ``cid``, and ``zstep`` together
    with its final (w, h), and the loop continues the exact stopping
    sequence of one uninterrupted run — backbone of sweep-level
    checkpointing (drivers.ml_driver checkpoint_every).
    """
    if fused_h is not None:
        return _ml_run_fused(x, w0, h0, itmax=itmax, tol=tol,
                             criterion=criterion, ncnn_step=ncnn_step,
                             fused_h=fused_h, fused_w=fused_w,
                             nm_true=nm_true, pn=pn, pd=pd,
                             rank_mask=rank_mask, it0=it0,
                             lk0_init=lk0_init, cid0=cid0,
                             zstep0=zstep0)
    # loop scalars use the FACTOR dtype: x may be a compressed integer
    # storage layout or a sparse-nonzeros pytree
    ref_t = w0.dtype
    eps = jnp.asarray(jnp.finfo(ref_t).eps, ref_t)
    tol = jnp.asarray(tol, ref_t)
    lgconst = likelihood_const(_xvals(x), ref_t)
    r = h0.shape[0]
    neginf = jnp.asarray(-jnp.inf, ref_t)
    lk_start = (neginf if lk0_init is None
                else jnp.asarray(lk0_init, ref_t))
    it_start = jnp.asarray(it0)

    if criterion == "likelihood":
        def cond(c):
            it, w, h, lkold, lk0, done = c
            return (~done) & (it <= itmax)

        def body(c):
            it, w, h, lkold, lk0, _ = c
            w, h = ml_sweep(x, w, h, eps, pn=pn, pd=pd,
                            rank_mask=rank_mask)
            lk = likelihood(x, w, h, lgconst)
            done = jnp.abs(lkold - lk) < tol * jnp.abs(lkold)
            return it + 1, w, h, lk, lk, done

        it, w, h, lkold, lk0, done = lax.while_loop(
            cond, body, (it_start, w0, h0, lk_start, lk_start,
                         jnp.asarray(False)))
        zstep = jnp.zeros((), jnp.int32)
    elif criterion == "connectivity":
        m_arr = h0.shape[1]
        cid_start = (jnp.zeros((m_arr,), jnp.int32) if cid0 is None
                     else jnp.asarray(cid0, jnp.int32))
        z_start = (jnp.asarray(0, jnp.int32) if zstep0 is None
                   else jnp.asarray(zstep0, jnp.int32))

        def cond(c):
            it, w, h, lk0, cid0, zstep, done = c
            return (~done) & (it <= itmax)

        def body(c):
            it, w, h, _, cid0, zstep, _ = c
            w, h = ml_sweep(x, w, h, eps)
            lk = likelihood(x, w, h, lgconst)
            cid = hard_assign(h)
            same = (it > 1) & partitions_equal(cid0, cid, r)
            zstep = jnp.where(same, zstep + 1, jnp.asarray(0, jnp.int32))
            done = zstep == ncnn_step
            return it + 1, w, h, lk, cid, zstep, done

        it, w, h, lk0, _, zstep, done = lax.while_loop(
            cond, body, (it_start, w0, h0, lk_start, cid_start,
                         z_start, jnp.asarray(False)))
    else:
        raise ValueError("Unknown stopping criterion.")

    return MLRunResult(w=w, h=h, lkh=lk0, n_iter=it - 1,
                       cid=hard_assign(h), zstep=zstep, done=done)


def _ml_run_fused(x, w0, h0, *, itmax, tol, criterion, ncnn_step,
                  fused_h, fused_w, nm_true=None, pn=0.0, pd=0.0,
                  rank_mask=None, it0=1, lk0_init=None, cid0=None,
                  zstep0=None) -> MLRunResult:
    """Deferred-likelihood ML loop over single-pass fused kernels.

    criterion='likelihood': fused iteration i completes the likelihood
    of sweep i-1 from fused_h's x*log(wh) sum (same (w, h)), checks the
    reference stopping rule one iteration late with identical inputs,
    then performs sweep i.  criterion='connectivity': the partition
    check needs only the updated H (no extra X pass); the final
    likelihood is evaluated once post-loop.

    Resume (it0/lk0_init/cid0/zstep0) mirrors ops.vb._vb_run_fused:
    the check of sweep it0-1 was already performed by the previous
    bounded call, so the first resumed iteration recomputes its
    likelihood only to feed the NEXT check (``valid`` guard), and the
    continued run is bit-identical to an uninterrupted one.
    """
    ref_t = w0.dtype
    eps = jnp.asarray(jnp.finfo(ref_t).eps, ref_t)
    tol = jnp.asarray(tol, ref_t)
    lgconst = likelihood_const(_xvals(x), ref_t)
    r = h0.shape[0]
    n, m = nm_true if nm_true is not None else (w0.shape[0], h0.shape[1])
    neginf = jnp.asarray(-jnp.inf, ref_t)
    it_start = jnp.asarray(it0)
    lk_start = (neginf if lk0_init is None
                else jnp.asarray(lk0_init, ref_t))

    def lk_of(xlw, w, h):
        # -sum(wh) reduces in rank space: dot(colsum(w), rowsum(h))
        return ((xlw - jnp.dot(jnp.sum(w, axis=0), jnp.sum(h, axis=1))
                 + lgconst) / (n * m))

    def do_sweep(w, h, hn):
        h1 = jnp.maximum((h * hn + pn)
                         / (jnp.sum(w, axis=0)[:, None] + pd), eps)
        if rank_mask is not None:
            h1 = jnp.where(rank_mask[:, None] > 0, h1, eps)
        wn = fused_w(x, w, h1)
        w1 = jnp.maximum((w * wn + pn)
                         / (jnp.sum(h1, axis=1)[None, :] + pd), eps)
        if rank_mask is not None:
            w1 = jnp.where(rank_mask[None, :] > 0, w1, eps)
        return w1, h1

    if criterion == "likelihood":
        def cond(c):
            it, w, h, lk2, done = c
            return (~done) & (it <= itmax + 1)

        def body(c):
            it, w, h, lk2, _ = c
            hn, xlw = fused_h(x, w, h)
            lk_prev = lk_of(xlw, w, h)        # likelihood of sweep it-1
            # sweep it-1's check belongs to THIS call only when it-1
            # was performed here; on resume the previous call already
            # checked sweep it0-1 (and lk0_init carries its value)
            valid = (it - 1) >= it_start
            conv = (valid & (it >= 2)
                    & (jnp.abs(lk2 - lk_prev) < tol * jnp.abs(lk2)))
            take = (~conv) & (it <= itmax)
            w1, h1 = do_sweep(w, h, hn)
            w = jnp.where(take, w1, w)
            h = jnp.where(take, h1, h)
            lk2 = jnp.where(valid & (it >= 2), lk_prev, lk2)
            done = conv
            return it + 1, w, h, lk2, done

        it, w, h, lk2, done = lax.while_loop(
            cond, body, (it_start, w0, h0, lk_start,
                         jnp.asarray(False)))
        return MLRunResult(w=w, h=h, lkh=lk2, n_iter=it - 2,
                           cid=hard_assign(h), done=done,
                           zstep=jnp.zeros((), jnp.int32))

    elif criterion == "connectivity":
        cid_start = (jnp.zeros((h0.shape[1],), jnp.int32)
                     if cid0 is None else jnp.asarray(cid0, jnp.int32))
        z_start = (jnp.asarray(0, jnp.int32) if zstep0 is None
                   else jnp.asarray(zstep0, jnp.int32))

        def cond(c):
            it, w, h, cid0, zstep, done = c
            return (~done) & (it <= itmax)

        def body(c):
            it, w, h, cid0, zstep, _ = c
            hn, _ = fused_h(x, w, h)
            w, h = do_sweep(w, h, hn)
            cid = hard_assign(h)
            same = (it > 1) & partitions_equal(cid0, cid, r)
            zstep = jnp.where(same, zstep + 1,
                              jnp.asarray(0, jnp.int32))
            done = zstep == ncnn_step
            return it + 1, w, h, cid, zstep, done

        it, w, h, cid, zstep, done = lax.while_loop(
            cond, body, (it_start, w0, h0, cid_start, z_start,
                         jnp.asarray(False)))
        _, xlw = fused_h(x, w, h)
        return MLRunResult(w=w, h=h, lkh=lk_of(xlw, w, h),
                           n_iter=it - 1, cid=cid, done=done,
                           zstep=zstep)
    else:
        raise ValueError("Unknown stopping criterion.")


def ml_init(key, n, m, rank, dtype=jnp.float32):
    """Uniform-random init (reference R/factorize.R:30-38)."""
    kw, kh = jax.random.split(key)
    w = jax.random.uniform(kw, (n, rank), dtype)
    h = jax.random.uniform(kh, (rank, m), dtype)
    return w, h
