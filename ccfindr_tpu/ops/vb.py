"""Variational-Bayes NMF math (JAX / XLA).

Redesign of the reference's hot path (src/vbnmf_update.cpp:16-102 and
driver loop R/bayesian.R:303-390) for an accelerator:

* State is an immutable pytree (:class:`VBState`); one CAVI sweep is the
  pure function :func:`vb_sweep` — three rank-r GEMMs plus fused
  element-wise gamma-posterior updates and digamma/lgamma.
* The constant ``sum(lgamma(X+1))`` term of the ELBO is hoisted out of
  the loop (the reference recomputes it every sweep,
  src/vbnmf_update.cpp:80-81).
* ``sum_ij (ew·eh)_ij`` is reduced in rank space as
  ``dot(colsum(ew), rowsum(eh))`` instead of an n x m matmul
  (identical by bilinearity; removes one O(n·m·r) GEMM per sweep).
* Convergence is a ``lax.while_loop`` (:func:`vb_run`); independent
  restarts batch via ``vmap`` (replacing the reference's Rmpi
  restart farm, R/bayesian.R:262-263), and the per-restart
  empirical-Bayes Newton update runs as a nested while_loop.

All functions preserve input dtype: float32 on the accelerator,
float64 on CPU for parity testing (the rebuild's useC=FALSE analog).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.special import digamma, gammaln


class Hyper(NamedTuple):
    """Gamma-prior hyperparameters: shapes (aw, ah), means (bw, bh)."""
    aw: jax.Array
    bw: jax.Array
    ah: jax.Array
    bh: jax.Array


class VBState(NamedTuple):
    """Mean-field gamma posterior state for one factorization.

    ew/eh: posterior means of W (n,r) and H (r,m);
    lw/lh: exp(E[log .]) geometric means driving the multiplicative
    updates; dw/dh: posterior variances; lkh: per-element ELBO.
    """
    ew: jax.Array
    eh: jax.Array
    lw: jax.Array
    lh: jax.Array
    dw: jax.Array
    dh: jax.Array
    lkh: jax.Array


def _dtype_eps(dtype):
    return jnp.finfo(dtype).eps


def trigamma(x):
    """psi'(x) for x > 0: recurrence to x >= 10 + Bernoulli asymptotic
    series (Abramowitz & Stegun 6.4.12).

    jax.scipy.special.polygamma(1, .) evaluates the Hurwitz zeta
    function — ~10x more arithmetic inside hyper_update's sequential
    scalar Newton chain.  Agreement vs polygamma:
    < 2e-15 relative in f64, f32-exact in f32, for x in [1e-3, 1e6].
    """
    shift = 10.0
    # psi'(x) = psi'(x + k) + sum_{i=0}^{k-1} 1/(x+i)^2, k = 10 terms
    # (unrolled; x > 0 always holds for gamma shapes)
    acc = jnp.zeros_like(x)
    xs = x
    for _ in range(10):
        acc = acc + jnp.where(xs < shift, 1.0 / (xs * xs), 0.0)
        xs = jnp.where(xs < shift, xs + 1.0, xs)
    z = 1.0 / (xs * xs)
    # 1/x + 1/(2x^2) + 1/x^3 * (B2 + z*(B4 + z*(B6 + z*(B8 + z*B10))))
    series = _horner([-691.0 / 2730.0, 5.0 / 66.0, -1.0 / 30.0,
                      1.0 / 42.0, -1.0 / 30.0, 1.0 / 6.0], z)
    return acc + 1.0 / xs + 0.5 * z + z / xs * series


def _horner(coeffs, z):
    """Horner evaluation with Python float coefficients."""
    acc = jnp.full_like(z, coeffs[0])
    for c in coeffs[1:]:
        acc = acc * z + c
    return acc


def suffstats_dense(x, lw, lh):
    """Sufficient statistics of one sweep on a dense count matrix.

    sw = lw * ((x / (lw@lh)) @ lh^T),  sh = lh * (lw^T @ (x / (lw@lh))).
    Kept as a seam so the sparse paths can be swapped in.
    """
    acc = jnp.promote_types(lw.dtype, jnp.float32)
    wth = lax.dot(lw, lh, precision=lax.Precision.HIGHEST,
                  preferred_element_type=acc)
    xw = x / wth
    sw = lw * lax.dot(xw, lh.T, precision=lax.Precision.HIGHEST,
                      preferred_element_type=acc)
    sh = lh * lax.dot(lw.T, xw, precision=lax.Precision.HIGHEST,
                      preferred_element_type=acc)
    return sw, sh


def elbo_data_term(x, lw, lh):
    """Data-dependent ELBO term  -sum x*(S/wth - log wth)  with
    S = (lw log lw)@lh + lw@(lh log lh).

    Computed in the FOLDED form (bilinearity):
    sum x*S/wth = sum ((x/wth)@lh^T)*(lw log lw)
                + sum (lw^T@(x/wth))*(lh log lh),
    which shares its GEMMs with the sufficient statistics — the same
    expression the fused backends use, so the eager and fused loops
    stay bit-identical."""
    acc = jnp.promote_types(lw.dtype, jnp.float32)
    dot = partial(lax.dot, precision=lax.Precision.HIGHEST,
                  preferred_element_type=acc)
    wth = dot(lw, lh)
    u = x / wth
    return (-(jnp.sum(dot(u, lh.T) * (lw * jnp.log(lw)))
              + jnp.sum(dot(lw.T, u) * (lh * jnp.log(lh))))
            + jnp.sum(x * jnp.log(wth)))


def posterior_update(sw, sh, state: VBState, hyper: Hyper, fudge, lgx,
                     cell_mask=None, m_true=None,
                     rank_mask=None, r_true=None,
                     gene_mask=None, n_true=None):
    """Gamma-posterior update from sufficient statistics + the ELBO
    terms that do NOT require another pass over X.

    Returns ``(new_state, pending)`` where ``pending`` is the partial
    (unnormalized) ELBO  -sum(ew@eh) - lgx + U2 + U3;  the full ELBO is
    ``(pending + data_term(x, new.lw, new.lh)) / (n*m)``.  Splitting
    here lets :func:`vb_run`'s fused path evaluate the data term of
    sweep t inside sweep t+1's single pass over X (both use the same
    lw/lh).  ``new_state.lkh`` is carried over unchanged.

    Masking semantics (padding contributes exactly nothing):

    * cell padding (mesh sharding): ``cell_mask`` is a (m_pad,) 0/1
      vector marking real cells, ``m_true`` the true cell count —
      eh/dh are zeroed, lh pinned at ``fudge`` (keeping W*H positive),
      and the U3 ELBO terms mask-summed.
    * gene padding (gene-axis mesh sharding): ``gene_mask`` is a
      (n_pad,) 0/1 vector marking real genes, ``n_true`` the true gene
      count — ew/dw rows are zeroed and lw rows pinned at 1.0 (the
      X-pass padding contract: padded X rows are 0, so any positive lw
      keeps W*H positive while contributing nothing), and the U2 ELBO
      terms mask-summed.
    * rank padding (batched rank sweeps): ``rank_mask`` is a (r_pad,)
      0/1 vector marking real components, ``r_true`` the (possibly
      traced, per-batch-instance) true rank — ew/eh are zeroed, lw/lh
      pinned at ``fudge`` so padded components add only
      fudge^2 ~ 1e-14 to W*H (below f32 resolution), and U2/U3 are
      mask-summed with r_true in the prior constants.
    """
    n = n_true if n_true is not None else state.lw.shape[0]
    r = state.lw.shape[1]
    m = m_true if m_true is not None else state.lh.shape[1]
    r_eff = r_true if r_true is not None else r
    aw, bw, ah, bh = hyper

    alw = aw + sw
    bew = 1.0 / (aw / bw + jnp.sum(state.eh, axis=1)[None, :])
    ew = alw * bew                    # must precede the eh update
    if gene_mask is not None:
        # padded gene rows must be dead BEFORE colsums(ew) feeds beh
        # (rows mix in the column sums; rank/cell masks never mix into
        # a same-sweep consumer and can apply after)
        ew = ew * gene_mask[:, None]
    alh = ah + sh
    beh = 1.0 / (ah / bh + jnp.sum(ew, axis=0)[:, None])
    eh = alh * beh

    lw = jnp.maximum(jnp.exp(digamma(alw)) * bew, fudge)
    lh = jnp.maximum(jnp.exp(digamma(alh)) * beh, fudge)
    dw = alw * bew ** 2
    dh = alh * beh ** 2
    if rank_mask is not None:
        mw = rank_mask[None, :]
        mh = rank_mask[:, None]
        ew = ew * mw
        dw = dw * mw
        eh = eh * mh
        dh = dh * mh
        lw = jnp.where(mw > 0, lw, fudge)
        lh = jnp.where(mh > 0, lh, fudge)
    if cell_mask is not None:
        eh = eh * cell_mask
        dh = dh * cell_mask
        lh = jnp.where(cell_mask > 0, lh, fudge)
    if gene_mask is not None:
        mg = gene_mask[:, None]
        dw = dw * mg
        lw = jnp.where(mg > 0, lw, 1.0)

    # ELBO: U1 data part; the -sum(ew@eh) term reduces in rank space.
    u1_part = -jnp.dot(jnp.sum(ew, axis=0), jnp.sum(eh, axis=1)) - lgx
    u2_elem = (-(aw / bw) * ew + alw * (1.0 + jnp.log(bew))
               + gammaln(alw))
    if rank_mask is not None:
        u2_elem = u2_elem * rank_mask[None, :]
    if gene_mask is not None:
        u2_elem = u2_elem * gene_mask[:, None]
    u2 = (jnp.sum(u2_elem)
          + n * r_eff * (aw * jnp.log(aw / bw) - gammaln(aw)))
    u3_elem = (-(ah / bh) * eh + alh * (1.0 + jnp.log(beh))
               + gammaln(alh))
    if rank_mask is not None:
        u3_elem = u3_elem * rank_mask[:, None]
    if cell_mask is not None:
        u3_elem = u3_elem * cell_mask
    u3 = (jnp.sum(u3_elem)
          + r_eff * m * (ah * jnp.log(ah / bh) - gammaln(ah)))
    pending = u1_part + u2 + u3

    return (VBState(ew=ew, eh=eh, lw=lw, lh=lh, dw=dw, dh=dh,
                    lkh=state.lkh), pending)


def fused_dense(x, lw, lh):
    """Single-pass fused backend (XLA): suffstat numerators + ELBO data
    term for the same (lw, lh), sharing wth = lw@lh and x/wth.

    Returns (swn, shn, dterm) with sw = lw*swn, sh = lh*shn,
    dterm = -sum x*(S/wth - log wth).  The S-dependent part folds into
    the suffstats by bilinearity (THREE GEMMs instead of five):
    sum x*S/wth = sum swn*(lw log lw) + sum shn*(lh log lh).
    See vb_run(fused=...).
    """
    acc = jnp.promote_types(lw.dtype, jnp.float32)
    dot = partial(lax.dot, precision=lax.Precision.HIGHEST,
                  preferred_element_type=acc)
    wth = dot(lw, lh)
    a = x / wth
    swn = dot(a, lh.T)
    shn = dot(lw.T, a)
    dterm = (-(jnp.sum(swn * (lw * jnp.log(lw)))
               + jnp.sum(shn * (lh * jnp.log(lh))))
             + jnp.sum(x * jnp.log(wth)))
    return swn, shn, dterm


def vb_sweep(x, state: VBState, hyper: Hyper, fudge, lgx,
             suffstats=suffstats_dense,
             data_term=elbo_data_term,
             cell_mask=None, m_true=None,
             rank_mask=None, r_true=None,
             gene_mask=None, n_true=None) -> VBState:
    """One CAVI sweep; exact math of reference src/vbnmf_update.cpp:33-90.

    ``lgx`` is the precomputed constant  sum_ij lgamma(x_ij + 1).
    ``suffstats`` / ``data_term`` are injection points for other
    kernels (e.g. the sparse layouts); with those backends ``x`` may be zero-padded to tile
    boundaries (padding contributes nothing), so the true (n, m) come
    from the state shapes.  Masking semantics: see
    :func:`posterior_update`.
    """
    n = n_true if n_true is not None else state.lw.shape[0]
    m = m_true if m_true is not None else state.lh.shape[1]
    sw, sh = suffstats(x, state.lw, state.lh)
    new, pending = posterior_update(
        sw, sh, state, hyper, fudge, lgx, cell_mask=cell_mask,
        m_true=m_true, rank_mask=rank_mask, r_true=r_true,
        gene_mask=gene_mask, n_true=n_true)
    lkh = (pending + data_term(x, new.lw, new.lh)) / (float(n) * float(m))
    return new._replace(lkh=lkh)


# ---------------------------------------------------------------------
# Empirical-Bayes hyperparameter update (reference R/bayesian.R:2-53)
# ---------------------------------------------------------------------

def hyper_update(mask, state: VBState, hyper: Hyper, niter: int = 100,
                 tol: float = 1e-4, cell_mask=None, m_true=None,
                 rank_mask=None, r_true=None,
                 gene_mask=None, n_true=None
                 ) -> tuple[Hyper, jax.Array]:
    """Damped-Newton update of gamma shapes + closed-form means.

    ``mask`` is a static 4-tuple of bools for (aw, bw, ah, bh).
    Returns (new_hyper, failed_flag); the reference raises on Newton
    non-convergence (R/bayesian.R:43) — inside jit we surface a status
    flag instead (SURVEY.md §5 failure-detection note).

    The reference always overwrites bh with mean(eh) even when
    mask[3] is FALSE (R/bayesian.R:50-51, latent bug); here the mask is
    honored.  ``cell_mask``/``m_true`` restrict the H-side means to
    real cells under mesh padding.
    """
    mask = tuple(bool(b) for b in mask)
    if not any(mask):
        return hyper, jnp.asarray(False)

    if cell_mask is None and rank_mask is None and gene_mask is None:
        lwm = jnp.mean(jnp.log(state.lw))
        ewm = jnp.mean(state.ew)
        lhm = jnp.mean(jnp.log(state.lh))
        ehm = jnp.mean(state.eh)
    else:
        r_pad, m_pad = state.lh.shape
        n_eff = n_true if n_true is not None else state.lw.shape[0]
        m_eff = m_true if m_true is not None else m_pad
        r_eff = r_true if r_true is not None else r_pad
        mask_w = jnp.ones((1, 1), state.lw.dtype)
        if rank_mask is not None:
            mask_w = mask_w * rank_mask[None, :]
        if gene_mask is not None:
            mask_w = mask_w * gene_mask[:, None]
        mask_h = jnp.ones((1, 1), state.lh.dtype)
        if rank_mask is not None:
            mask_h = mask_h * rank_mask[:, None]
        if cell_mask is not None:
            mask_h = mask_h * cell_mask
        denom_w = n_eff * r_eff
        denom_h = r_eff * m_eff
        logw = jnp.where(mask_w > 0, jnp.log(state.lw), 0.0)
        logh = jnp.where(mask_h > 0, jnp.log(state.lh), 0.0)
        lwm = (jnp.sum(logw * mask_w) / denom_w
               if rank_mask is not None or gene_mask is not None
               else jnp.sum(logw) / denom_w)
        ewm = jnp.sum(state.ew) / denom_w    # ew masked to 0 in padding
        lhm = jnp.sum(logh * mask_h) / denom_h
        ehm = jnp.sum(state.eh) / denom_h    # eh masked to 0 in padding
    aw0, bw0, ah0, bh0 = hyper

    if mask[0] or mask[2]:
        # Fixed-trip-count masked Newton (scalar work; fori_loops with
        # done-masking instead of nested while_loops keep vb_run's
        # compiled control flow shallow).
        def newton_step(a0, mean_e, mean_l, b0, enabled):
            if not enabled:
                return jnp.zeros_like(a0)
            return ((jnp.log(a0) - digamma(a0) - mean_e / b0 + 1.0
                     + mean_l - jnp.log(b0))
                    / (1.0 / a0 - trigamma(a0)))

        def positive_step(a0, d):
            # halve d until a0 - d > 0 (reference while loop,
            # R/bayesian.R:28-35).  Closed form: the minimal k >= 0
            # with d/2^k < a0 is floor(log2(d/a0)) + 1; halving by 2
            # is exact in fp, so d * 2^-k equals iterated halving
            # bit-for-bit.  One select each way absorbs log2 ulp
            # error.  (Replaces a 64-step unrolled select chain.)
            k = jnp.maximum(jnp.floor(jnp.log2(d / a0)) + 1.0, 0.0)
            k = jnp.where((d > 0) & jnp.isfinite(d), k, 0.0)
            ki = jnp.clip(k, 0.0, 2100.0).astype(jnp.int32)
            d2 = jnp.ldexp(d, -ki)        # exact 2^-k scale (exp2 is
            d2 = jnp.where(a0 - d2 <= 0, d2 * 0.5, d2)  # not)  # under
            over = (ki >= 1) & (d > 0) & (a0 - d2 * 2.0 > 0)
            return jnp.where(over, d2 * 2.0, d2)              # over

        def loop_cond(carry):
            it, _, _, done = carry
            return (~done) & (it < niter - 1)

        def loop_body(carry):
            it, aw0, ah0, done = carry
            dw = newton_step(aw0, ewm, lwm, bw0, mask[0])
            dh = newton_step(ah0, ehm, lhm, bh0, mask[2])
            dw = positive_step(aw0, dw)
            dh = positive_step(ah0, dh)
            aw1 = aw0 - dw
            ah1 = ah0 - dh
            df = (1.0 - aw1 / aw0) ** 2 + (1.0 - ah1 / ah0) ** 2
            return it + 1, aw1, ah1, df < tol

        # early-exit while_loop: warm-started from the previous
        # sweep's shapes, Newton converges in 1-5 iterations, so a
        # fixed trip count would spend most of its sequential scalar
        # chain on dead iterations.  Converged results are identical:
        # a fixed-trip loop's masked tail is a no-op.
        _, aw1, ah1, done = lax.while_loop(
            loop_cond, loop_body,
            (jnp.asarray(0), aw0, ah0, jnp.asarray(False)))
        failed = ~done
    else:
        aw1, ah1 = aw0, ah0
        failed = jnp.asarray(False)

    bw1 = ewm if mask[1] else bw0
    bh1 = ehm if mask[3] else bh0
    return Hyper(aw=aw1, bw=bw1, ah=ah1, bh=bh1), failed


# ---------------------------------------------------------------------
# Initialization (reference vb_init, R/bayesian.R:109-171)
# ---------------------------------------------------------------------

def vb_init_random(key, n, m, rank, hyper: Hyper, dtype=jnp.float32
                   ) -> VBState:
    """Random init: W, H drawn from the gamma priors."""
    kw, kh = jax.random.split(key)
    aw = jnp.asarray(hyper.aw, dtype)
    ah = jnp.asarray(hyper.ah, dtype)
    w = jax.random.gamma(kw, aw, (n, rank), dtype) * (hyper.bw / hyper.aw)
    h = jax.random.gamma(kh, ah, (rank, m), dtype) * (hyper.bh / hyper.ah)
    zw = jnp.zeros((n, rank), dtype)
    zh = jnp.zeros((rank, m), dtype)
    return VBState(ew=w, eh=h, lw=w, lh=h, dw=zw, dh=zh,
                   lkh=jnp.asarray(-jnp.inf, dtype))


def vb_init_svd(x, rank, hyper: Hyper, variant: str = "svd2",
                dtype=jnp.float32, method: str = "auto",
                seed: int = 0) -> VBState:
    """Deterministic SVD-based inits.

    ``'svd'``  — NNDSVD (Boutsidis & Gallopoulos 2008).  The reference's
    version reuses the positive-part norms for the negative parts
    (R/bayesian.R:135-136, a known bug); here the correct negative-part
    norms are used.
    ``'svd2'`` — truncated SVD, absolute values, scaled so mean(h)=bh
    (reference R/bayesian.R:150-159).

    ``method``: ``'exact'`` — host LAPACK/Lanczos (the irlba analog);
    ``'randomized'`` — ops.rsvd.randomized_svd on DEVICE (sharded tall
    GEMMs / COO scans; the atlas-scale path, SURVEY §7.3 "SVD init on
    device"); ``'auto'`` — exact below 4096 on the short axis, randomized
    above.  ``x`` may be dense, scipy sparse, or a
    ops.sparse.SparseCounts — never densified.
    """
    import numpy as np
    import scipy.sparse as sp

    from .sparse import SparseCounts

    if isinstance(x, SparseCounts):
        n, m = x.n, x.m
        sparse_in = True
    else:
        sparse_in = sp.issparse(x)
        if sparse_in:
            x = sp.csr_matrix(x).astype(np.float64)
        else:
            x = np.asarray(x, dtype=np.float64)
        n, m = x.shape
    if method == "auto":
        method = ("randomized" if min(n, m) > 4096
                  or isinstance(x, SparseCounts) else "exact")

    if method == "randomized":
        from . import rsvd

        if sparse_in and not isinstance(x, SparseCounts):
            from .sparse import from_scipy

            x = from_scipy(x, dtype=dtype)
        u, s, vt = rsvd.randomized_svd(x, rank, seed=seed)
        u = np.asarray(u, np.float64)
        s = np.asarray(s, np.float64)
        vt = np.asarray(vt, np.float64)
    elif min(n, m) / 2 > rank:
        # truncated Lanczos SVD (irlba-equivalent) — both variants
        # only consume the top-`rank` triplet, so sparse inputs never
        # densify (reference uses irlba only for svd2,
        # R/bayesian.R:152-156)
        import scipy.sparse.linalg as spla

        # seeded start vector: svds defaults to a RANDOM v0, which
        # would make the 'deterministic' initializer vary run to run
        v0 = np.random.default_rng(seed).standard_normal(min(n, m))
        u, s, vt = spla.svds(x, k=rank, v0=v0)
        order = np.argsort(-s)
        u, s, vt = u[:, order], s[order], vt[order]
    else:
        xd = x.toarray() if sparse_in else x
        u, s, vt = np.linalg.svd(xd, full_matrices=False)
        u, s, vt = u[:, :rank], s[:rank], vt[:rank]

    if variant == "svd":
        w = np.zeros((n, rank))
        h = np.zeros((rank, m))
        d1 = np.sqrt(s[0])
        w[:, 0] = d1 * u[:, 0]
        sgn = np.sign(w[0, 0]) if w[0, 0] != 0 else 1.0
        if sgn < 0:
            w = -w
        h[0, :] = sgn * d1 * vt[0]
        for k in range(1, rank):
            xv, yv = u[:, k], vt[k]
            xp, xn = np.maximum(xv, 0), np.maximum(-xv, 0)
            yp, yn = np.maximum(yv, 0), np.maximum(-yv, 0)
            xpn, ypn = np.linalg.norm(xp), np.linalg.norm(yp)
            xnn, ynn = np.linalg.norm(xn), np.linalg.norm(yn)
            mp, mn = xpn * ypn, xnn * ynn
            if mp >= mn:
                uu, vv, sig = xp / max(xpn, 1e-300), yp / max(ypn, 1e-300), mp
            else:
                uu, vv, sig = xn / max(xnn, 1e-300), yn / max(ynn, 1e-300), mn
            w[:, k] = np.sqrt(s[k] * sig) * uu
            h[k, :] = np.sqrt(s[k] * sig) * vv
        eps = np.finfo(np.float64).eps
        w = np.maximum(w, eps)
        h = np.maximum(h, eps)
    elif variant == "svd2":
        w = np.abs(u)
        h = np.abs(np.diag(s) @ vt)
        scale = float(hyper.bh) / h.mean()
        h = h * scale
        w = w / scale
    else:
        raise ValueError(f"Unknown initializer {variant!r}")

    w = jnp.asarray(w, dtype)
    h = jnp.asarray(h, dtype)
    zw = jnp.zeros((n, rank), dtype)
    zh = jnp.zeros((rank, m), dtype)
    return VBState(ew=w, eh=h, lw=w, lh=h, dw=zw, dh=zh,
                   lkh=jnp.asarray(-jnp.inf, dtype))


# ---------------------------------------------------------------------
# Convergence loop for one restart (reference vb_iterate hot loop,
# R/bayesian.R:337-352)
# ---------------------------------------------------------------------

class VBRunResult(NamedTuple):
    state: VBState
    hyper: Hyper
    lml: jax.Array          # recorded log evidence (see note below)
    n_iter: jax.Array
    hyper_failed: jax.Array
    # True iff the stopping rule fired (convergence or NaN), False iff
    # the run exhausted its sweep bound — disambiguates a lane that
    # converged exactly at a checkpoint-chunk boundary (n_iter == end)
    # from one that merely ran out of chunk (drivers._chunked_vb)
    done: jax.Array


@partial(jax.jit, static_argnames=("hyper_mask", "n0", "dn",
                                   "suffstats", "data_term", "m_true",
                                   "n_true", "fused", "elbo_every"))
def vb_run(x, state0: VBState, hyper0: Hyper, *, itmax: int = 10000,
           tol: float = 1e-5, fudge=None, hyper_mask=(True,) * 4,
           n0: int = 10, dn: int = 1,
           suffstats=suffstats_dense,
           data_term=elbo_data_term,
           fused=None,
           cell_mask=None, m_true=None,
           rank_mask=None, r_true=None,
           gene_mask=None, n_true=None,
           it0=1, lk0_init=None,
           elbo_every: int = 1) -> VBRunResult:
    """Iterate vb_sweep to convergence for a single restart.

    Stopping mirrors the reference (R/bayesian.R:345-348): after the
    first ``n0`` sweeps, stop when the ELBO is non-decreasing and its
    relative change is below ``tol`` (or on NaN).  The recorded ``lml``
    is the ELBO of the penultimate sweep, exactly as the reference
    records ``lk0`` (R/bayesian.R:348,379).

    vmap-compatible: batching over restarts turns the while_loop into a
    run-until-all-converged masked loop.

    ``x`` may be a dense array, a tile-padded dense array, or a
    ops.sparse.SparseCounts pytree (with matching suffstats/data_term
    backends); lgamma(x+1) over zeros is 0, so the hoisted constant is
    the same in every layout.

    ``fused``, if given, is a single-pass kernel
    ``(x, lw, lh) -> (swn, shn, dterm)`` returning the suffstat
    NUMERATORS (sw = lw*swn, sh = lh*shn) AND the ELBO data term for
    the same (lw, lh).  The loop then defers each sweep's ELBO
    completion to the next sweep's pass over X (the data term of sweep
    t and the suffstats of sweep t+1 consume identical lw/lh), halving
    the passes over X per sweep.  The ELBO sequence, stopping decision,
    recorded lml, n_iter, and final state are the same math as the
    two-pass path, at the cost of one trailing fused call whose
    suffstats are discarded.

    ``it0``/``lk0_init`` resume a previously bounded run: pass the
    prior call's ``n_iter + 1`` and ``lml`` together with its final
    state/hyper, and the loop continues with the exact same stopping
    sequence as one uninterrupted run (the sweep index is absolute, so
    the n0/dn hyper cadence and convergence guards line up).  Backbone
    of sweep-level checkpointing (drivers.vb_driver checkpoint_every).
    """
    if lk0_init is None:
        lk0_init = 0.0
    if elbo_every != 1 and fused is None:
        raise ValueError("elbo_every needs a fused backend whose "
                         "kernel takes the do_elbo flag")
    if fused is not None:
        return _vb_run_fused(x, state0, hyper0, itmax=itmax, tol=tol,
                             fudge=fudge, hyper_mask=hyper_mask, n0=n0,
                             dn=dn, fused=fused, cell_mask=cell_mask,
                             m_true=m_true, rank_mask=rank_mask,
                             r_true=r_true, gene_mask=gene_mask,
                             n_true=n_true, it0=it0,
                             lk0_init=lk0_init,
                             elbo_every=elbo_every)
    # SparseCounts -> its nonzero values; plain (possibly traced)
    # arrays pass through.  X may be stored in a compressed integer
    # dtype (drivers.vb_driver storage_dtype) — all loop scalars use
    # the FACTOR dtype.
    xval = x.val if isinstance(x, tuple) and hasattr(x, "val") else x
    ref_t = state0.lw.dtype
    if fudge is None:
        fudge = _dtype_eps(ref_t)
    fudge = jnp.asarray(fudge, ref_t)
    lgx = jnp.sum(gammaln(xval.astype(ref_t) + 1.0))
    tol = jnp.asarray(tol, ref_t)
    if rank_mask is not None:
        # zero out padded rank components in the initial state
        mw = rank_mask[None, :]
        mh = rank_mask[:, None]
        state0 = state0._replace(
            ew=state0.ew * mw, dw=state0.dw * mw,
            lw=jnp.where(mw > 0, state0.lw, fudge),
            eh=state0.eh * mh, dh=state0.dh * mh,
            lh=jnp.where(mh > 0, state0.lh, fudge))
    if cell_mask is not None:
        # zero out padded cells in the initial state
        state0 = state0._replace(
            eh=state0.eh * cell_mask, dh=state0.dh * cell_mask,
            lh=jnp.where(cell_mask > 0, state0.lh, fudge))
    if gene_mask is not None:
        mg = gene_mask[:, None]
        state0 = state0._replace(
            ew=state0.ew * mg, dw=state0.dw * mg,
            lw=jnp.where(mg > 0, state0.lw, 1.0))

    def cond(carry):
        it, _, _, _, done, _ = carry
        return (~done) & (it <= itmax)

    def body(carry):
        it, state, hyper, lk0, done, hfail = carry
        state = vb_sweep(x, state, hyper, fudge, lgx,
                         suffstats=suffstats, data_term=data_term,
                         cell_mask=cell_mask, m_true=m_true,
                         rank_mask=rank_mask, r_true=r_true,
                         gene_mask=gene_mask, n_true=n_true)
        do_hyper = (it > n0) & (it % dn == 0)
        # compute the (cheap, scalar) empirical-Bayes update every
        # sweep and mask-select — avoids a cond wrapping nested loops
        new_hyper, failed = hyper_update(
            hyper_mask, state, hyper, cell_mask=cell_mask,
            m_true=m_true, rank_mask=rank_mask, r_true=r_true,
            gene_mask=gene_mask, n_true=n_true)
        hyper = Hyper(*(jnp.where(do_hyper, new, old)
                        for new, old in zip(new_hyper, hyper)))
        hfail = hfail | (do_hyper & failed)

        lkh = state.lkh
        nan_stop = jnp.isnan(lkh)
        conv = ((it > 1) & (it > n0) & (lkh >= lk0)
                & (jnp.abs(1.0 - lkh / lk0) < tol))
        done = nan_stop | conv
        lk0 = jnp.where(done, lk0, lkh)   # reference keeps previous lk0
        return it + 1, state, hyper, lk0, done, hfail

    it_start = jnp.asarray(it0)
    lk0 = jnp.asarray(lk0_init, ref_t)
    carry = (it_start, state0, hyper0, lk0, jnp.asarray(False),
             jnp.asarray(False))
    it, state, hyper, lk0, done, hfail = lax.while_loop(cond, body, carry)
    return VBRunResult(state=state, hyper=hyper, lml=lk0,
                       n_iter=it - 1, hyper_failed=hfail, done=done)


def _vb_run_fused(x, state0: VBState, hyper0: Hyper, *, itmax, tol,
                  fudge, hyper_mask, n0, dn, fused,
                  cell_mask=None, m_true=None,
                  rank_mask=None, r_true=None,
                  gene_mask=None, n_true=None,
                  it0=1, lk0_init=0.0,
                  elbo_every: int = 1) -> VBRunResult:
    """Deferred-ELBO convergence loop over a fused single-pass kernel.

    Fused iteration i evaluates ``fused(x, lw_i, lh_i)``; its data term
    COMPLETES the ELBO of sweep i-1 (whose posterior update produced
    lw_i/lh_i) while its suffstats BEGIN sweep i.  The reference-check
    of sweep it therefore executes at fused iteration it+1, with
    identical inputs and outcome as the eager two-pass loop in
    :func:`vb_run`.
    """
    xval = x.val if isinstance(x, tuple) and hasattr(x, "val") else x
    n = n_true if n_true is not None else state0.lw.shape[0]
    m = m_true if m_true is not None else state0.lh.shape[1]
    ref_t = state0.lw.dtype
    if fudge is None:
        fudge = _dtype_eps(ref_t)
    fudge = jnp.asarray(fudge, ref_t)
    lgx = jnp.sum(gammaln(xval.astype(ref_t) + 1.0))
    tol = jnp.asarray(tol, ref_t)
    if rank_mask is not None:
        mw = rank_mask[None, :]
        mh = rank_mask[:, None]
        state0 = state0._replace(
            ew=state0.ew * mw, dw=state0.dw * mw,
            lw=jnp.where(mw > 0, state0.lw, fudge),
            eh=state0.eh * mh, dh=state0.dh * mh,
            lh=jnp.where(mh > 0, state0.lh, fudge))
    if cell_mask is not None:
        state0 = state0._replace(
            eh=state0.eh * cell_mask, dh=state0.dh * cell_mask,
            lh=jnp.where(cell_mask > 0, state0.lh, fudge))
    if gene_mask is not None:
        mg = gene_mask[:, None]
        state0 = state0._replace(
            ew=state0.ew * mg, dw=state0.dw * mg,
            lw=jnp.where(mg > 0, state0.lw, 1.0))

    def cond(carry):
        it, _, _, _, _, done, _ = carry
        return (~done) & (it <= itmax + 1)

    def body(carry):
        it, state, hyper, lk0, pending, done, hfail = carry
        itp = it - 1                      # the sweep being checked
        if elbo_every > 1:
            # elbo_every cadence: the fused kernel skips the data
            # term's O(nnz) transcendental on non-check sweeps;
            # stopping is conservative (the ELBO is monotone, so the
            # k-sweep change bounds the 1-sweep change from above)
            elbo_now = itp % elbo_every == 0
            swn, shn, dterm = fused(x, state.lw, state.lh,
                                    do_elbo=elbo_now.astype(ref_t))
        else:
            elbo_now = jnp.asarray(True)
            swn, shn, dterm = fused(x, state.lw, state.lh)
        lkh_prev = (pending + dterm) / (float(n) * float(m))
        # pending is only valid for sweeps performed in THIS call
        # (itp >= it0); on resume, sweep it0-1 was already checked by
        # the previous call and lk0_init carries its ELBO
        valid = (itp >= it_start) & elbo_now
        nan_stop = jnp.isnan(lkh_prev) & valid
        conv = (valid & (itp > 1) & (itp > n0) & (lkh_prev >= lk0)
                & (jnp.abs(1.0 - lkh_prev / lk0) < tol))
        stop = nan_stop | conv
        lk0 = jnp.where(valid, jnp.where(stop, lk0, lkh_prev), lk0)
        state = state._replace(
            lkh=jnp.where(valid, lkh_prev, state.lkh))

        # sweep `it` (discarded when stopping or past itmax)
        do_sweep = (~stop) & (it <= itmax)
        sw = state.lw * swn
        sh = state.lh * shn
        new_state, new_pending = posterior_update(
            sw, sh, state, hyper, fudge, lgx, cell_mask=cell_mask,
            m_true=m_true, rank_mask=rank_mask, r_true=r_true,
            gene_mask=gene_mask, n_true=n_true)
        do_hyper = do_sweep & (it > n0) & (it % dn == 0)
        new_hyper, failed = hyper_update(
            hyper_mask, new_state, hyper, cell_mask=cell_mask,
            m_true=m_true, rank_mask=rank_mask, r_true=r_true,
            gene_mask=gene_mask, n_true=n_true)
        hyper = Hyper(*(jnp.where(do_hyper, new, old)
                        for new, old in zip(new_hyper, hyper)))
        hfail = hfail | (do_hyper & failed)
        state = jax.tree.map(
            lambda new, old: jnp.where(do_sweep, new, old),
            new_state, state)
        pending = jnp.where(do_sweep, new_pending, pending)
        # carry the STOP flag (not stop-or-bound): the loop cond's
        # it <= itmax + 1 bound still terminates, and the exit flag
        # then reports whether the stopping rule actually fired
        done = stop
        return it + 1, state, hyper, lk0, pending, done, hfail

    it_start = jnp.asarray(it0)
    lk0 = jnp.asarray(lk0_init, ref_t)
    pending0 = jnp.asarray(0.0, ref_t)
    carry = (it_start, state0, hyper0, lk0, pending0,
             jnp.asarray(False), jnp.asarray(False))
    it, state, hyper, lk0, _, done, hfail = lax.while_loop(
        cond, body, carry)
    return VBRunResult(state=state, hyper=hyper, lml=lk0,
                       n_iter=it - 2, hyper_failed=hfail, done=done)


def uniform_columns(ew, tol) -> jax.Array:
    """Per-column degeneracy flags: |max - min| < tol
    (reference R/bayesian.R:368-369)."""
    return (jnp.max(ew, axis=0) - jnp.min(ew, axis=0)) < tol
