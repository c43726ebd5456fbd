"""Sharded fused-kernel backends: explicit SPMD over the cell axis.

The dense mesh path lets GSPMD auto-partition the XLA einsums; this
module instead runs a fused single-pass kernel PER SHARD via
``shard_map`` and inserts the collectives by hand (the communication
plan in SURVEY.md §2.3/§5):

per sweep, each device reads only its (genes x local-cells) block of X
and contributes

* ``psum`` of the n x r sufficient-stat partial ``swn`` (W is
  replicated; its statistics reduce over cell shards),
* its local slice of ``shn`` (H is cell-sharded; no communication),
* ``psum`` of the scalar ELBO data term.

Communication per sweep is O(n*r) floats — tiny next to the
O(n*m_local*r) on-device compute.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P


def _smap(fn, mesh, in_specs, out_specs):
    return shard_map(fn, mesh=mesh, in_specs=in_specs,
                     out_specs=out_specs, check_vma=False)


def make_fused_sharded(mesh: Mesh, fused_local=None,
                       precision: str = "f32"):
    """Fused backend for ops.vb.vb_run(fused=...) over a cell-sharded
    mesh.

    ``fused_local(x_local, lw, lh_local, do_elbo=None) -> (swn_part,
    shn_local, dterm_part)`` runs on each device's X block; defaults
    to the fused X-pass GPU kernel (ops.pallas.xpass) at
    ``precision``.  X must be sharded P(None, 'cells') (or
    P('genes', 'cells')) and its extents divisible by the mesh axes
    (the driver's padding + masks guarantee this; it also pads each
    shard to whole kernel tiles so no sweep copies X).  Accepts
    vb_run's ``do_elbo`` flag (elbo_every cadence).
    """
    if fused_local is None:
        from ..ops.pallas import xpass
        fused_local = xpass.make_vb_backend(precision)

    g = "genes" if "genes" in mesh.axis_names else None

    def local(x, lw, lh, do_elbo):
        swn, shn, dterm = fused_local(x, lw, lh, do_elbo=do_elbo)
        # duals: swn rows are gene-local, reduce over cell shards;
        # shn cols are cell-local, reduce over gene shards
        swn = jax.lax.psum(swn, "cells")
        if g is not None:
            shn = jax.lax.psum(shn, g)
            dterm = jax.lax.psum(dterm, (g, "cells"))
        else:
            dterm = jax.lax.psum(dterm, "cells")
        return swn, shn, dterm

    sharded = _smap(local, mesh,
                    in_specs=(P(g, "cells"), P(g, None),
                              P(None, "cells"), P()),
                    out_specs=(P(g, None), P(None, "cells"), P()))

    def fused(x, lw, lh, do_elbo=None):
        if do_elbo is None:
            do_elbo = jnp.ones((), lw.dtype)
        return sharded(x, lw, lh, do_elbo)

    return fused


def make_sparse_fused_sharded(mesh: Mesh, chunk: int = 1 << 16):
    """Fused sparse backend for ops.vb.vb_run(fused=...) over a
    cell-sharded mesh — NO dense X anywhere.

    ``x`` is an ops.sparse.SparseCounts built by
    ``from_scipy_sharded(csr, mesh.shape['cells'])``: row/col/val of
    shape (n_shards, nnz_loc_pad) sharded on axis 0 over 'cells', with
    LOCAL column indices.  Each device scans only its own cells'
    nonzeros; the collectives are identical to the dense sharded path
    (psum of the n x r suffstat partial and the scalar ELBO term —
    the fold of the partial swn against lw*log(lw) commutes with the
    psum by linearity).
    """
    from ..ops import sparse as sk

    def local(x, lw, lh):
        sc = sk.SparseCounts(row=x.row[0], col=x.col[0], val=x.val[0],
                             n=x.n, m=x.m)
        swn, shn, dterm = sk.fused_coo(sc, lw, lh, chunk=chunk)
        swn = jax.lax.psum(swn, "cells")
        dterm = jax.lax.psum(dterm, "cells")
        return swn, shn, dterm

    # P('cells') as a tree-prefix leaf applies to every SparseCounts
    # array leaf (row/col/val, all sharded on axis 0)
    return _smap(local, mesh,
                 in_specs=(P("cells"), P(None, None),
                           P(None, "cells")),
                 out_specs=(P(None, None), P(None, "cells"), P()))


def make_ell_fused_sharded(mesh: Mesh):
    """Fused ELL backend for ops.vb.vb_run(fused=...) over a
    cell-sharded mesh — gather-only sparse, NO dense X anywhere.

    ``x`` is an ops.ell.EllCounts built by
    ``from_scipy_ell_sharded(csr, mesh.shape['cells'])``: every leaf
    carries a leading shard axis over 'cells', cell indices local to
    the shard.  Collectives are identical to the COO sharded path:
    psum of the n x r swn partial and the scalar ELBO term (the
    lw*log(lw) fold commutes with the psum by linearity); shn is
    cell-local.
    """
    from ..ops import ell as ek

    def local(x, lw, lh):
        ec = jax.tree.map(lambda a: a[0], x)
        swn, shn, dterm = ek.fused_ell(ec, lw, lh)
        swn = jax.lax.psum(swn, "cells")
        dterm = jax.lax.psum(dterm, "cells")
        return swn, shn, dterm

    return _smap(local, mesh,
                 in_specs=(P("cells"), P(None, None),
                           P(None, "cells")),
                 out_specs=(P(None, None), P(None, "cells"), P()))


def make_ml_sharded(mesh: Mesh):
    """(fused_h, fused_w) ML backends over a cell-sharded mesh.

    Per sweep each device reads only its (genes x local-cells) block:
    the H-update numerator and H itself stay local (no communication);
    the W-update numerator (n x r) and the scalar likelihood term are
    psum'd — the same O(n*r) per-sweep communication as the VB path.
    Each device runs the fused X-pass GPU kernel's ML phases.
    """
    from ..ops.pallas import xpass

    fh, fw = xpass.make_ml_backend()

    def local_h(x, w, h):
        hn, xlw = fh(x, w, h)
        return hn, jax.lax.psum(xlw, "cells")

    def local_w(x, w, h):
        return jax.lax.psum(fw(x, w, h), "cells")

    fused_h = _smap(local_h, mesh,
                    in_specs=(P(None, "cells"), P(None, None),
                              P(None, "cells")),
                    out_specs=(P(None, "cells"), P()))
    fused_w = _smap(local_w, mesh,
                    in_specs=(P(None, "cells"), P(None, None),
                              P(None, "cells")),
                    out_specs=P(None, None))
    return fused_h, fused_w
