"""Fused X-pass kernel for NVIDIA GPUs (Pallas, Triton route).

Every VB sweep reads the count matrix X once to produce three results
for the same geometric-mean factors (lw, lh):

* ``swn  = (X / wth) @ lh^T``     (n, r) — W sufficient-stat numerator
* ``shn  = lw^T @ (X / wth)``     (r, m) — H sufficient-stat numerator
* ``xlog = sum(X * log(wth))``     scalar — the data part of the ELBO

with ``wth = lw @ lh``.  The ML (Lee-Seung KL) sweep's two phases are
the same contractions: its H phase needs (shn, xlog), its W phase swn.
Under plain XLA (ops.vb.fused_dense) ``wth`` and ``X / wth`` are
written to device memory as n x m float32 arrays and read back by the
two GEMMs; here they live only in registers, so a sweep moves one read
of X (int8/int16/f32, upcast in registers) plus small per-block
partials.

Layout: the grid is parallel over (cell groups, gene chunks).  A
block loops over the cell tiles (``bm`` cells) of its group and, for
each, over the gene tiles (``bn`` genes) of its chunk: shn accumulates
in registers over the gene loop and is stored once per cell tile;
swn accumulates over the cell loop in the block's own slice of a
per-group partial buffer; xlog is one scalar per block.  XLA sums the
partials in a fixed order — no atomics, so results are bit-identical
from run to run (checkpoint resume depends on it).  The group and
chunk counts are the pair that fills the card with the fewest partial
bytes, so a vmapped batch of lanes stays small next to X.  The rank
pads to a power of two >= 16, the tensor cores' minimum width.

Padding contract (padding contributes exactly nothing): X pads with 0;
W rows pad with 1 and rank columns with 0; H rank rows pad with 0 and
cell columns with 1 — wth stays positive while padded X entries add
nothing to any output.  X may arrive already padded (see
:func:`pad_matrix`); the true (n, m) come from the factor shapes.

Precision: ``'f32'`` runs the GEMMs in full float32 (no TF32);
``'bf16'`` casts the GEMM operands to bfloat16 with float32
accumulation.  The division ``X / wth`` is exact.

The kernel compiles for the GPU only.  ``interpret=True`` runs it in
the Pallas interpreter (how the CPU tests exercise it); the wrapper
never picks interpret mode by itself and refuses any other platform.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Production tile sizes (genes per inner step, cells per cell tile),
# warps and pipeline stages — chosen on an H100 (see PERF.md).
BN = 32
BM = 64
NUM_WARPS = 2
NUM_STAGES = 3
# aim for at least this many blocks per kernel launch (132 SMs, two
# resident blocks each)
_MIN_BLOCKS = 264
PRECISIONS = ("f32", "bf16")


def _round_up(v: int, mult: int) -> int:
    return -(-v // mult) * mult


def rank_pad(r: int) -> int:
    """Padded rank: a power of two, at least 16."""
    return max(16, 1 << (int(r) - 1).bit_length())


def pad_matrix(x):
    """Zero-pad a count matrix to tile boundaries — do it once per
    factorization; the kernel then never copies X."""
    n, m = x.shape
    np_, mp_ = _round_up(n, BN), _round_up(m, BM)
    if (np_, mp_) == (n, m):
        return x
    return jnp.pad(x, ((0, np_ - n), (0, mp_ - m)))


def _grid(n_tiles: int, n_ct: int, rp: int, bn: int, bm: int):
    """(cell groups, gene chunks): divisors of the cell-tile and
    gene-tile counts (every block runs the same static trip counts)
    giving at least _MIN_BLOCKS blocks with the fewest partial-buffer
    elements, groups * n * rp (swn) + chunks * rp * m (shn).  Shapes
    too small to fill the card get one block per tile pair."""
    best = None
    for g in range(1, n_ct + 1):
        if n_ct % g:
            continue
        for c in range(1, n_tiles + 1):
            if n_tiles % c or g * c < min(_MIN_BLOCKS, n_ct * n_tiles):
                continue
            cost = (g * n_tiles * bn + c * n_ct * bm) * rp
            if best is None or cost < best[0]:
                best = (cost, g, c)
            break       # larger c only adds partials
    return best[1], best[2]


def _pad_factors(lw, lh, np_, mp_, rp):
    n, r = lw.shape
    m = lh.shape[1]
    lw_p = jnp.pad(lw, ((0, np_ - n), (0, 0)), constant_values=1.0)
    lw_p = jnp.pad(lw_p, ((0, 0), (0, rp - r)))
    lh_p = jnp.pad(lh, ((0, 0), (0, mp_ - m)), constant_values=1.0)
    lh_p = jnp.pad(lh_p, ((0, rp - r), (0, 0)))
    return lw_p, lh_p


def _dot(a, b, acc_t, *, ta=False, tb=False):
    # Precision.HIGHEST is pl.dot(allow_tf32=False): IEEE float32
    # operands (no TF32); bfloat16 operands run on the tensor cores.
    # The accumulator type stays explicit (float64 in interpret mode).
    dims = (((0 if ta else 1,), (1 if tb else 0,)), ((), ()))
    return lax.dot_general(a, b, dims, precision=lax.Precision.HIGHEST,
                           preferred_element_type=acc_t)


def _kernel(*refs, bn, bm, tpc, cpg, mm_t, acc_t, want_swn, want_shn,
            want_xlog):
    it = iter(refs)
    x_ref, lw_ref, lh_ref = next(it), next(it), next(it)
    swn_ref = next(it) if want_swn else None
    shn_ref = next(it) if want_shn else None
    xlog_ref = next(it) if want_xlog else None

    g = pl.program_id(0)                 # cell group
    c = pl.program_id(1)                 # gene chunk
    rp = lw_ref.shape[1]

    def cell_tile(jj, xl_acc):
        col0 = pl.multiple_of((g * cpg + jj) * bm, bm)
        lh = lh_ref[:, pl.ds(col0, bm)].astype(mm_t)      # (rp, bm)

        def gene_tile(t, carry):
            shn_acc, xl_acc = carry
            row0 = pl.multiple_of((c * tpc + t) * bn, bn)
            x = x_ref[pl.ds(row0, bn), pl.ds(col0, bm)].astype(acc_t)
            lw = lw_ref[pl.ds(row0, bn), :].astype(mm_t)  # (bn, rp)
            wth = _dot(lw, lh, acc_t)                      # (bn, bm)
            u = (x / wth).astype(mm_t)
            if want_shn:
                shn_acc = shn_acc + _dot(lw, u, acc_t, ta=True)
            if want_swn:
                s = _dot(u, lh, acc_t, tb=True)
                rows = (g, pl.ds(row0, bn), slice(None))
                # the block's first cell tile starts its partial rows
                swn_ref[rows] = jnp.where(jj == 0, s, swn_ref[rows] + s)
            if want_xlog:
                xl_acc = xl_acc + x * jnp.log(wth)
            return shn_acc, xl_acc

        shn_acc, xl_acc = lax.fori_loop(
            0, tpc, gene_tile, (jnp.zeros((rp, bm), acc_t), xl_acc))
        if want_shn:
            shn_ref[c, :, pl.ds(col0, bm)] = shn_acc
        return xl_acc

    xl_acc = lax.fori_loop(0, cpg, cell_tile, jnp.zeros((bn, bm), acc_t))
    if want_xlog:
        xlog_ref[c, g] = jnp.sum(xl_acc)


@functools.partial(jax.jit, static_argnames=(
    "precision", "want_swn", "want_shn", "want_xlog", "interpret"))
def _xpass(x, lw, lh, *, precision, want_swn, want_shn, want_xlog,
           interpret):
    bn, bm = BN, BM
    n, r = lw.shape
    m = lh.shape[1]
    x = pad_matrix(x)
    np_, mp_ = x.shape
    rp = rank_pad(r)
    acc_t = jnp.promote_types(lw.dtype, jnp.float32)
    mm_t = jnp.bfloat16 if precision == "bf16" else lw.dtype
    lw_p, lh_p = _pad_factors(lw, lh, np_, mp_, rp)
    n_tiles, n_ct = np_ // bn, mp_ // bm
    n_g, n_c = _grid(n_tiles, n_ct, rp, bn, bm)

    out_shape = []
    if want_swn:
        out_shape.append(jax.ShapeDtypeStruct((n_g, np_, rp), acc_t))
    if want_shn:
        out_shape.append(jax.ShapeDtypeStruct((n_c, rp, mp_), acc_t))
    if want_xlog:
        out_shape.append(jax.ShapeDtypeStruct((n_c, n_g), acc_t))
    kernel = functools.partial(
        _kernel, bn=bn, bm=bm, tpc=n_tiles // n_c, cpg=n_ct // n_g,
        mm_t=mm_t, acc_t=acc_t, want_swn=want_swn, want_shn=want_shn,
        want_xlog=want_xlog)
    outs = iter(pl.pallas_call(
        kernel,
        grid=(n_g, n_c),
        out_shape=out_shape,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        interpret=interpret,
        name="ccfindr_xpass",
    )(x, lw_p, lh_p))
    swn = jnp.sum(next(outs), axis=0)[:n, :r] if want_swn else None
    shn = jnp.sum(next(outs), axis=0)[:r, :m] if want_shn else None
    xlog = jnp.sum(next(outs)) if want_xlog else None
    return swn, shn, xlog


def _check_platform(lw, interpret):
    if interpret:
        return
    platform = jax.default_backend()
    if platform != "gpu":
        raise RuntimeError(
            "the fused X-pass kernel compiles for an NVIDIA GPU only "
            f"(JAX platform: {platform!r}); use backend='dense_fused' "
            "for the same math in plain XLA")
    if lw.dtype == jnp.float64:
        raise TypeError("the fused X-pass kernel runs float32 factors "
                        "on the GPU; float64 needs backend='dense' or "
                        "'dense_fused'")


def xpass(x, lw, lh, *, do_elbo=None, precision: str = "f32",
          want_swn: bool = True, want_shn: bool = True,
          want_xlog: bool = True, interpret: bool = False):
    """One read of X -> ``(swn, shn, xlog)`` for the factors (lw, lh).

    ``x``: (n', m') count matrix, n' >= n and m' >= m with zeros beyond
    the true extent, in any of int8/int16/float32 (float64 in
    interpret mode).  ``lw``: (n, r), ``lh``: (r, m), positive.
    ``do_elbo``: optional traced scalar; when it is 0 the kernel's
    variant without the logarithm runs and xlog = 0 (vb_run's
    elbo_every cadence).
    ``want_*`` drop outputs a caller does not need (returned as None).
    """
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    _check_platform(lw, interpret)
    kw = dict(precision=precision, want_swn=want_swn, want_shn=want_shn,
              interpret=interpret)
    if do_elbo is None or not want_xlog:
        return _xpass(x, lw, lh, want_xlog=want_xlog, **kw)

    # the elbo_every cadence: off sweeps run the kernel variant without
    # the logarithm (under vmap with per-lane flags XLA runs both)
    def skip_log(x, lw, lh):
        swn, shn, _ = _xpass(x, lw, lh, want_xlog=False, **kw)
        return swn, shn, jnp.zeros((), jnp.promote_types(lw.dtype,
                                                         jnp.float32))

    return lax.cond(jnp.asarray(do_elbo) > 0,
                    lambda *a: _xpass(*a, want_xlog=True, **kw),
                    skip_log, x, lw, lh)


def fold_dterm(swn, shn, lw, lh, xlog):
    """ELBO data term -sum x*(S/wth - log wth) from the X-pass outputs,
    S = (lw log lw)@lh + lw@(lh log lh); by bilinearity
    sum x*S/wth = sum swn*(lw log lw) + sum shn*(lh log lh)."""
    return (-(jnp.sum(swn * (lw * jnp.log(lw)))
              + jnp.sum(shn * (lh * jnp.log(lh)))) + xlog)


@dataclasses.dataclass(frozen=True)
class VBXPass:
    """Fused backend for ops.vb.vb_run(fused=...): ``(x, lw, lh) ->
    (swn, shn, dterm)``.  Hashable, so equal backends share compiled
    loops."""
    precision: str = "f32"
    interpret: bool = False

    def __call__(self, x, lw, lh, do_elbo=None):
        swn, shn, xlog = xpass(x, lw, lh, do_elbo=do_elbo,
                               precision=self.precision,
                               interpret=self.interpret)
        return swn, shn, fold_dterm(swn, shn, lw, lh, xlog)


@dataclasses.dataclass(frozen=True)
class MLXPass:
    """(fused_h, fused_w) phases for ops.ml.ml_run: ``h(x, w, h) ->
    (w^T(x/wh), sum x log wh)`` and ``w(x, w, h) -> (x/wh) h^T``."""
    interpret: bool = False

    def h(self, x, w, h):
        _, hn, xlw = xpass(x, w, h, want_swn=False,
                           interpret=self.interpret)
        return hn, xlw

    def w(self, x, w, h):
        wn, _, _ = xpass(x, w, h, want_shn=False, want_xlog=False,
                         interpret=self.interpret)
        return wn


def make_vb_backend(precision: str = "f32") -> VBXPass:
    """The VB fused backend the drivers use (compiled for the GPU)."""
    return VBXPass(precision=precision)


def make_ml_backend():
    """(fused_h, fused_w) for the ML driver (compiled for the GPU)."""
    b = MLXPass()
    return b.h, b.w
