"""ELL-layout sparse kernels: gather-only sufficient statistics.

The COO backend (ops/sparse.py) scans nonzero chunks and accumulates
``swn``/``shn`` with ``.at[].add`` — an XLA *scatter*, with
conflicting updates to the same output rows.  This module removes
every scatter by storing the nonzeros twice, each layout aligned with
one output:

* **by-gene ELL** ``(n, Kg)`` — slot k of row i holds the k-th nonzero
  of gene i (cell index + value).  ``swn[i] = sum_k a_ik * lh[:,c_ik]``
  is then a *gather* of lh columns followed by a dense reduction over
  the slot axis; the row index is the array index, so the output is
  written, never scattered.  The ELBO ``xlog = sum x log wth`` rides
  along.
* **by-cell ELL** ``(m, Kc)`` — the transpose view, producing
  ``shn[:,j] = sum_k a_jk * lw[g_jk,:]`` the same way.

Widths Kg/Kc are a high quantile of the per-row nonzero counts
(scRNA nnz-per-gene distributions are heavy-tailed: housekeeping genes
express everywhere); entries beyond the width go to small COO tails
handled by the scatter scan (hybrid ELL+COO).  Each layout partitions
the nonzeros exactly once, so each output is computed exactly once.

Both passes run as ``lax.scan`` over row blocks, bounding the gathered
(block, K, r) intermediate to ~tens of MB regardless of matrix size.
All arithmetic matches ops.sparse.fused_coo bit-for-bit in ordering-
insensitive form (same masked divides, same folded ELBO identity).

Reference semantics: src/vbnmf_update.cpp:33-36 (sw/sh GEMMs over the
densified X); here only nonzeros are touched, O(nnz*r).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax


class EllCounts(NamedTuple):
    """Dual hybrid ELL+COO count matrix (pytree; dims static).

    ``gcol``/``gval``: by-gene slots, padded rows to ``n_pad`` and
    slots with (col=m, val=0).  ``crow``/``cval``: by-cell slots,
    padded with (row=n, val=0).  ``g/c`` tails: flat COO arrays
    (possibly length 0) for slots beyond the ELL widths.
    """
    gcol: jax.Array          # (n_pad, Kg) int32
    gval: jax.Array          # (n_pad, Kg) float
    crow: jax.Array          # (m_pad, Kc) int32
    cval: jax.Array          # (m_pad, Kc) float
    gtrow: jax.Array         # (tg,) int32  by-gene overflow tail
    gtcol: jax.Array         # (tg,) int32
    gtval: jax.Array         # (tg,) float
    ctrow: jax.Array         # (tc,) int32  by-cell overflow tail
    ctcol: jax.Array         # (tc,) int32
    ctval: jax.Array         # (tc,) float
    n: int
    m: int
    bn: int                  # gene-block size for the scan
    bm: int                  # cell-block size for the scan

    @property
    def val(self):
        """All nonzero values exactly once (by-gene partition) — the
        hoisted ``sum lgamma(x+1)`` in ops.vb.vb_run reads this."""
        return jnp.concatenate([self.gval.ravel(),
                                self.gtval.ravel()])


def _ell_flatten(ec):
    return (ec.gcol, ec.gval, ec.crow, ec.cval, ec.gtrow, ec.gtcol,
            ec.gtval, ec.ctrow, ec.ctcol, ec.ctval), \
        (ec.n, ec.m, ec.bn, ec.bm)


def _ell_unflatten(aux, children):
    return EllCounts(*children, *aux)


jax.tree_util.register_pytree_node(EllCounts, _ell_flatten,
                                   _ell_unflatten)


def _round_up(v: int, mult: int) -> int:
    return -(-v // mult) * mult


def _ell_of(indptr, indices, data, width, dummy_idx, np_dtype):
    """Rows (CSR/CSC) -> fixed-width ELL slots + overflow COO tail.

    Returns (idx (rows, width), val (rows, width), tail_row, tail_idx,
    tail_val) with tail_* flat arrays for entries beyond ``width``.
    """
    nrows = len(indptr) - 1
    counts = np.diff(indptr)
    keep = np.minimum(counts, width)
    idx = np.full((nrows, width), dummy_idx, np.int32)
    val = np.zeros((nrows, width), np_dtype)
    # slot position of every nonzero within its row
    pos = np.arange(len(indices)) - np.repeat(indptr[:-1], counts)
    rows = np.repeat(np.arange(nrows), counts)
    main = pos < width
    idx[rows[main], pos[main]] = indices[main]
    val[rows[main], pos[main]] = data[main]
    tail = ~main
    return (idx, val, rows[tail].astype(np.int32),
            indices[tail].astype(np.int32), data[tail].astype(np_dtype))


def _width(counts, quantile, lane=128):
    if len(counts) == 0:
        return lane
    w = int(np.quantile(counts, quantile)) if quantile < 1.0 \
        else int(counts.max())
    return max(lane, _round_up(w, lane))


def _block(rows_total, width, r_max=64, budget=1 << 25):
    """Row-block size: keep the gathered (block, K, r) intermediate
    near ``budget`` floats-bytes (default 32 MB at r_max=64)."""
    b = max(8, budget // max(1, width * r_max * 4))
    b = 1 << int(np.floor(np.log2(b)))
    return int(min(b, _round_up(rows_total, 8)))


def from_scipy_ell(mat, dtype=jnp.float32, quantile: float = 0.98,
                   lane: int = 128) -> EllCounts:
    """Build the dual hybrid ELL+COO layout from a scipy sparse (or
    dense) matrix.  Done once per factorization on host.  ``lane``
    is the padding granularity that floors/rounds the ELL widths
    (tests shrink it to exercise overflow tails on tiny
    matrices)."""
    import scipy.sparse as sp

    csr = sp.csr_matrix(mat)
    csr.sum_duplicates()
    csr.eliminate_zeros()
    n, m = csr.shape
    np_dtype = np.dtype(jnp.zeros((), dtype).dtype)

    kg = _width(np.diff(csr.indptr), quantile, lane)
    gcol, gval, gtrow, gtcol, gtval = _ell_of(
        csr.indptr, csr.indices, csr.data, kg, m, np_dtype)

    csc = csr.tocsc()
    kc = _width(np.diff(csc.indptr), quantile, lane)
    crow, cval, ctcol, ctrow, ctval = _ell_of(
        csc.indptr, csc.indices, csc.data, kc, n, np_dtype)

    bn = _block(n, kg)
    bm = _block(m, kc)
    n_pad, m_pad = _round_up(n, bn), _round_up(m, bm)
    gcol = np.pad(gcol, ((0, n_pad - n), (0, 0)), constant_values=m)
    gval = np.pad(gval, ((0, n_pad - n), (0, 0)))
    crow = np.pad(crow, ((0, m_pad - m), (0, 0)), constant_values=n)
    cval = np.pad(cval, ((0, m_pad - m), (0, 0)))

    j = jnp.asarray
    return EllCounts(gcol=j(gcol), gval=j(gval), crow=j(crow),
                     cval=j(cval), gtrow=j(gtrow), gtcol=j(gtcol),
                     gtval=j(gtval), ctrow=j(ctrow), ctcol=j(ctcol),
                     ctval=j(ctval), n=n, m=m, bn=bn, bm=bm)


def from_dense_ell(x, dtype=jnp.float32, quantile: float = 0.98
                   ) -> EllCounts:
    import scipy.sparse as sp

    return from_scipy_ell(sp.csr_matrix(np.asarray(x)), dtype=dtype,
                          quantile=quantile)


def from_scipy_ell_sharded(mat, n_shards: int, m_pad: int | None = None,
                           dtype=jnp.float32, quantile: float = 0.98,
                           lane: int = 128) -> EllCounts:
    """Cell-sharded dual ELL: one shard's nonzeros per device.

    Returns an EllCounts whose leaf arrays carry a leading
    ``n_shards`` axis (laid out over the mesh's 'cells' axis) and
    whose ``m`` is the LOCAL cell count ``m_pad // n_shards``; cell
    indices are local to the shard.  Widths/blocks/tail lengths are
    computed globally so every shard has identical static shapes.
    Same collective pattern as ops.sparse.from_scipy_sharded: per
    sweep each device gathers only its own cells' nonzeros; swn and
    the ELBO term psum over 'cells', shn stays local
    (parallel.sharded.make_ell_fused_sharded).
    """
    import scipy.sparse as sp

    csr = sp.csr_matrix(mat)
    csr.sum_duplicates()
    csr.eliminate_zeros()
    csc = csr.tocsc()
    n, m = csc.shape
    if m_pad is None:
        m_pad = -(-m // n_shards) * n_shards
    if m_pad % n_shards != 0:
        raise ValueError(f"m_pad={m_pad} not divisible by {n_shards}")
    m_loc = m_pad // n_shards
    np_dtype = np.dtype(jnp.zeros((), dtype).dtype)

    blocks = []
    for s in range(n_shards):
        j0, j1 = s * m_loc, min((s + 1) * m_loc, m)
        blocks.append(sp.csr_matrix(csc[:, j0:max(j1, j0)]))

    # global static widths: per-(gene, shard) and per-cell nnz counts
    kg = _width(np.concatenate(
        [np.diff(b.indptr) for b in blocks]), quantile, lane)
    kc = _width(np.diff(csc.indptr), quantile, lane)
    bn = _block(n, kg)
    bm = _block(m_loc, kc)
    n_pad, m_loc_pad = _round_up(n, bn), _round_up(m_loc, bm)

    parts = []
    for b in blocks:
        gcol, gval, gtr, gtc, gtv = _ell_of(
            b.indptr, b.indices, b.data, kg, m_loc, np_dtype)
        gcol = np.pad(gcol, ((0, n_pad - n), (0, 0)),
                      constant_values=m_loc)
        gval = np.pad(gval, ((0, n_pad - n), (0, 0)))
        bc = b.tocsc()
        mb = bc.shape[1]
        crow, cval, ctc, ctr, ctv = _ell_of(
            bc.indptr, bc.indices, bc.data, kc, n, np_dtype)
        crow = np.pad(crow, ((0, m_loc_pad - mb), (0, 0)),
                      constant_values=n)
        cval = np.pad(cval, ((0, m_loc_pad - mb), (0, 0)))
        parts.append((gcol, gval, gtr, gtc, gtv,
                      crow, cval, ctr, ctc, ctv))

    # tails pad to the max length with discard-slot coordinates
    # (idx_out = n or m_loc, val = 0 — contributes exactly nothing)
    tg = max(len(p[2]) for p in parts)
    tc = max(len(p[7]) for p in parts)

    def _pad_tail(idx_out, idx_in, val, t, out_dummy, in_dummy):
        pad = t - len(idx_out)
        return (np.concatenate([idx_out,
                                np.full(pad, out_dummy, np.int32)]),
                np.concatenate([idx_in,
                                np.full(pad, in_dummy, np.int32)]),
                np.concatenate([val, np.zeros(pad, np_dtype)]))

    st = {f: [] for f in ("gcol", "gval", "gtrow", "gtcol", "gtval",
                          "crow", "cval", "ctrow", "ctcol", "ctval")}
    for (gcol, gval, gtr, gtc, gtv,
         crow, cval, ctr, ctc, ctv) in parts:
        gtr, gtc, gtv = _pad_tail(gtr, gtc, gtv, tg, n, m_loc)
        # by-cell tail: idx_out = cell (ctcol), idx_in = gene (ctrow)
        ctc, ctr, ctv = _pad_tail(ctc, ctr, ctv, tc, m_loc, n)
        for f, a in (("gcol", gcol), ("gval", gval), ("gtrow", gtr),
                     ("gtcol", gtc), ("gtval", gtv), ("crow", crow),
                     ("cval", cval), ("ctrow", ctr), ("ctcol", ctc),
                     ("ctval", ctv)):
            st[f].append(a)

    j = jnp.asarray
    return EllCounts(
        **{f: j(np.stack(v)) for f, v in st.items()},
        n=n, m=m_loc, bn=bn, bm=bm)


def _tail_scan(idx_out, idx_in, tval, ext_out, ext_in, out_rows,
               with_xlog, chunk=8192):
    """COO overflow tail: scatter-accumulated partial of ONE output.

    ``acc[idx_out] += (val / <ext_out[idx_out], ext_in[idx_in]>) *
    ext_in[idx_in]`` — swn when idx_out are genes, shn^T when cells.
    Tails are a few percent of nnz, so the scatter cost is negligible
    here."""
    r = ext_out.shape[1]
    t = idx_out.shape[0]
    acc = jnp.zeros((out_rows + 1, r), ext_out.dtype)
    xlog = jnp.zeros((), ext_out.dtype)
    if t == 0:
        return acc[:out_rows], xlog
    pad = (-t) % chunk
    idx_out = jnp.concatenate(
        [idx_out, jnp.full((pad,), out_rows, jnp.int32)])
    idx_in = jnp.concatenate(
        [idx_in, jnp.full((pad,), ext_in.shape[0] - 1, jnp.int32)])
    tval = jnp.concatenate([tval, jnp.zeros((pad,), tval.dtype)])
    nchunks = idx_out.shape[0] // chunk
    outs = idx_out.reshape(nchunks, chunk)
    ins = idx_in.reshape(nchunks, chunk)
    vals = tval.reshape(nchunks, chunk)

    def body(carry, inp):
        acc, xl = carry
        oo, ii, vv = inp
        o_side = ext_out[oo]              # (chunk, r) output-side row
        i_side = ext_in[ii]               # (chunk, r) gathered side
        wth = jnp.sum(o_side * i_side, axis=1)
        safe = jnp.where(wth > 0, wth, 1.0)
        a = jnp.where(vv > 0, vv / safe, 0.0)
        acc = acc.at[oo].add(a[:, None] * i_side)
        if with_xlog:
            xl = xl + jnp.sum(jnp.where(vv > 0, vv * jnp.log(safe),
                                        0.0))
        return (acc, xl), None

    (acc, xlog), _ = lax.scan(body, (acc, xlog), (outs, ins, vals))
    return acc[:out_rows], xlog


@jax.jit
def fused_ell(ec: EllCounts, lw, lh):
    """Single-pass fused backend over the dual ELL layout: returns
    (swn, shn, dterm) exactly as ops.vb.fused_dense /
    ops.sparse.fused_coo, with sw = lw*swn, sh = lh*shn.

    Wait-free on TPU: both passes are gathers + dense slot-axis
    reductions; the only scatters are the (tiny) overflow tails.
    """
    n, m = ec.n, ec.m
    r = lw.shape[1]
    acc_t = lw.dtype
    lh_ext = jnp.concatenate(
        [lh, jnp.zeros((r, 1), lh.dtype)], axis=1).T        # (m+1, r)
    lw_ext = jnp.concatenate(
        [lw, jnp.zeros((1, r), lw.dtype)])                  # (n+1, r)

    # ---- by-gene pass: swn + xlog -------------------------------
    n_pad, kg = ec.gcol.shape
    nb = n_pad // ec.bn
    gcol = ec.gcol.reshape(nb, ec.bn, kg)
    gval = ec.gval.reshape(nb, ec.bn, kg)
    lw_pad = jnp.concatenate(
        [lw, jnp.zeros((n_pad - n, r), lw.dtype)]).reshape(
            nb, ec.bn, r)

    def gbody(xlog, inp):
        gc, gv, lwb = inp
        lhg = lh_ext[gc]                                   # (bn,Kg,r)
        wth = jnp.einsum("bkr,br->bk", lhg, lwb,
                         preferred_element_type=acc_t)
        safe = jnp.where(wth > 0, wth, 1.0)
        a = jnp.where(gv > 0, gv / safe, 0.0)
        swn_b = jnp.einsum("bk,bkr->br", a, lhg,
                           preferred_element_type=acc_t)
        xlog = xlog + jnp.sum(jnp.where(gv > 0, gv * jnp.log(safe),
                                        0.0))
        return xlog, swn_b

    xlog, swn = lax.scan(gbody, jnp.zeros((), acc_t),
                         (gcol, gval, lw_pad))
    swn = swn.reshape(n_pad, r)[:n]

    # ---- by-cell pass: shn --------------------------------------
    m_pad, kc = ec.crow.shape
    mb = m_pad // ec.bm
    crow = ec.crow.reshape(mb, ec.bm, kc)
    cval = ec.cval.reshape(mb, ec.bm, kc)
    lh_pad = jnp.concatenate(
        [lh.T, jnp.zeros((m_pad - m, r), lh.dtype)]).reshape(
            mb, ec.bm, r)

    def cbody(_, inp):
        cr, cv, lhb = inp
        lwg = lw_ext[cr]                                   # (bm,Kc,r)
        wth = jnp.einsum("bkr,br->bk", lwg, lhb,
                         preferred_element_type=acc_t)
        safe = jnp.where(wth > 0, wth, 1.0)
        a = jnp.where(cv > 0, cv / safe, 0.0)
        shn_b = jnp.einsum("bk,bkr->br", a, lwg,
                           preferred_element_type=acc_t)
        return 0.0, shn_b

    _, shn = lax.scan(cbody, 0.0, (crow, cval, lh_pad))
    shn = shn.reshape(m_pad, r)[:m].T

    # ---- overflow tails -----------------------------------------
    gt_swn, gt_xlog = _tail_scan(ec.gtrow, ec.gtcol, ec.gtval,
                                 lw_ext, lh_ext, n, with_xlog=True)
    swn = swn + gt_swn
    xlog = xlog + gt_xlog
    ct_shn, _ = _tail_scan(ec.ctcol, ec.ctrow, ec.ctval,
                           lh_ext, lw_ext, m, with_xlog=False)
    shn = shn + ct_shn.T

    dterm = (-(jnp.sum(swn * (lw * jnp.log(lw)))
               + jnp.sum(shn * (lh * jnp.log(lh)))) + xlog)
    return swn, shn, dterm


def make_ell_fused():
    """Fused kernel for vb_run(fused=...)/vb_factorize
    backend='sparse' with sparse_layout='ell'."""
    def fused(x, lw, lh):
        return fused_ell(x, lw, lh)

    return fused


# ---------------------------------------------------------------------
# ML (Lee–Seung) phases over the dual ELL layout
# ---------------------------------------------------------------------

@jax.jit
def ell_ml_h(ec: EllCounts, w, h):
    """ML H-phase over nonzeros: (hn, xlogwh) with
    hn = w^T (x/wh) and xlogwh = sum x log(wh) — the ELL dual of
    ops.ml.ml_h_dense (contract of
    ops.ml.ml_run(fused_h=...)).  By-cell gather pass + overflow
    tail; O(nnz*r), no densification."""
    n, m = ec.n, ec.m
    r = w.shape[1]
    acc_t = w.dtype
    w_ext = jnp.concatenate([w, jnp.zeros((1, r), w.dtype)])

    m_pad, kc = ec.crow.shape
    mb = m_pad // ec.bm
    crow = ec.crow.reshape(mb, ec.bm, kc)
    cval = ec.cval.reshape(mb, ec.bm, kc)
    h_pad = jnp.concatenate(
        [h.T, jnp.zeros((m_pad - m, r), h.dtype)]).reshape(
            mb, ec.bm, r)

    def cbody(xlog, inp):
        cr, cv, hb = inp
        wg = w_ext[cr]                                    # (bm,Kc,r)
        wh = jnp.einsum("bkr,br->bk", wg, hb,
                        preferred_element_type=acc_t)
        safe = jnp.where(wh > 0, wh, 1.0)
        a = jnp.where(cv > 0, cv / safe, 0.0)
        hn_b = jnp.einsum("bk,bkr->br", a, wg,
                          preferred_element_type=acc_t)
        xlog = xlog + jnp.sum(jnp.where(cv > 0, cv * jnp.log(safe),
                                        0.0))
        return xlog, hn_b

    xlog, hn = lax.scan(cbody, jnp.zeros((), acc_t),
                        (crow, cval, h_pad))
    hn = hn.reshape(m_pad, r)[:m].T

    h_ext = jnp.concatenate(
        [h, jnp.zeros((r, 1), h.dtype)], axis=1).T         # (m+1, r)
    ct_hn, ct_xlog = _tail_scan(ec.ctcol, ec.ctrow, ec.ctval,
                                h_ext, w_ext, m, with_xlog=True)
    return hn + ct_hn.T, xlog + ct_xlog


@jax.jit
def ell_ml_w(ec: EllCounts, w, h):
    """ML W-phase over nonzeros: wn = (x/wh) h^T for the UPDATED h —
    the ELL dual of ml_w_pallas.  By-gene gather pass + tail."""
    n, m = ec.n, ec.m
    r = w.shape[1]
    acc_t = w.dtype
    lh_ext = jnp.concatenate(
        [h, jnp.zeros((r, 1), h.dtype)], axis=1).T         # (m+1, r)

    n_pad, kg = ec.gcol.shape
    nb = n_pad // ec.bn
    gcol = ec.gcol.reshape(nb, ec.bn, kg)
    gval = ec.gval.reshape(nb, ec.bn, kg)
    w_pad = jnp.concatenate(
        [w, jnp.zeros((n_pad - n, r), w.dtype)]).reshape(
            nb, ec.bn, r)

    def gbody(_, inp):
        gc, gv, wb = inp
        hg = lh_ext[gc]                                   # (bn,Kg,r)
        wh = jnp.einsum("bkr,br->bk", hg, wb,
                        preferred_element_type=acc_t)
        safe = jnp.where(wh > 0, wh, 1.0)
        a = jnp.where(gv > 0, gv / safe, 0.0)
        wn_b = jnp.einsum("bk,bkr->br", a, hg,
                          preferred_element_type=acc_t)
        return 0.0, wn_b

    _, wn = lax.scan(gbody, 0.0, (gcol, gval, w_pad))
    wn = wn.reshape(n_pad, r)[:n]

    w_ext = jnp.concatenate([w, jnp.zeros((1, r), w.dtype)])
    gt_wn, _ = _tail_scan(ec.gtrow, ec.gtcol, ec.gtval,
                          w_ext, lh_ext, n, with_xlog=False)
    return wn + gt_wn


def make_ell_ml_backend():
    """(fused_h, fused_w) pair for ops.ml.ml_run over an EllCounts —
    factorize(backend='sparse')."""
    def fused_h(x, w, h):
        return ell_ml_h(x, w, h)

    def fused_w(x, w, h):
        return ell_ml_w(x, w, h)

    return fused_h, fused_w
