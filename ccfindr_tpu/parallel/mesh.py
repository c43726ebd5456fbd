"""Device mesh construction and sharding helpers.

The distributed design (SURVEY.md §2.3/§5): within one factorization the
data-parallel axis is **cells** — X and H are column-sharded, W is
replicated, and XLA/GSPMD inserts the per-sweep all-reduces
(length-r ``rowSums(eh)``, n x r sufficient-stat partials, scalar ELBO)
over the device interconnect (NCCL on GPUs).  Independent restarts /
rank values form the **runs** batch axis (replacing the reference's
Rmpi restart farm, R/bayesian.R:262-263).  Multi-process runs
additionally call :func:`init_distributed` so every process joins the
same mesh.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(runs: int = 1, cells: int | None = None,
              genes: int = 1, devices=None) -> Mesh:
    """Build a ('runs', 'genes', 'cells') mesh over the devices.

    ``runs`` shards the restart/rank batch axis; ``cells`` the cell
    axis of X/H (the long data-parallel axis); ``genes`` the gene axis
    of X/W — the TP dual for huge gene/peak panels (multi-omic,
    100k+ rows) where replicating W per device wastes HBM and the
    gene-major kernel shards rows (SURVEY §2.3 TP row).  Defaults:
    genes=1 (replicated W), all remaining devices on cells.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if cells is None:
        if n % (runs * genes) != 0:
            raise ValueError(
                f"{n} devices not divisible by runs*genes="
                f"{runs * genes}")
        cells = n // (runs * genes)
    if runs * genes * cells != n:
        raise ValueError(f"runs*genes*cells = {runs * genes * cells} "
                         f"!= {n} devices")
    arr = np.asarray(devices).reshape(runs, genes, cells)
    return Mesh(arr, axis_names=("runs", "genes", "cells"))


def cell_sharding(mesh: Mesh, kind: str) -> NamedSharding:
    """Common shardings: 'x' (genes x cells), 'w' (replicated W-family),
    'h' (r x cells), plus batched 'bw'/'bh' with a leading runs axis."""
    g = "genes" if "genes" in mesh.axis_names else None
    specs = {
        "x": P(g, "cells"),
        "w": P(g, None),
        "h": P(None, "cells"),
        "bw": P("runs", g, None),
        "bh": P("runs", None, "cells"),
        "scalar": P(),
        "bscalar": P("runs"),
    }
    return NamedSharding(mesh, specs[kind])


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, local_device_ids=None):
    """Initialize multi-process JAX.

    Safe no-op when single-process.  Equivalent role to the reference's
    Rmpi initialization (DESCRIPTION:8), but collectives ride the mesh
    rather than a task queue.  ``local_device_ids`` pins this process
    to those local devices — when several processes share one GPU host,
    pass ``[process_id]`` (or any disjoint split) so each opens only
    its own card; a JAX process otherwise reserves memory on every
    visible card.
    """
    if num_processes is None or num_processes <= 1:
        return False
    kw = {}
    if local_device_ids is not None:
        kw["local_device_ids"] = list(local_device_ids)
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id, **kw)
    return True
