"""Atlas-scale end-to-end demo: the full ccfindR workflow at 100k cells.

BASELINE.json's configs row 4 analog (100k-cell sparse atlas,
rank-20 VB) as a SCIENCE run, not just a kernel benchmark: simulate a
12-type atlas (20,480 genes x 100,352 cells), then run the complete
pipeline on one GPU —

    QC (filter_cells/filter_genes) -> VB rank scan 2..20 (batched,
    int8 auto storage) -> optimal_rank -> cluster tree -> metagenes ->
    subsampled t-SNE

— printing wall-clock per phase and checking the planted structure is
recovered (ropt ~= 12, cluster assignments concordant with the planted
types).  The vignette does exactly this at 450 cells
(vignettes/ccfindR.Rmd:122-477); this demo is the
200x-scale version the reference's dense-R path cannot reach.

Usage: python examples/atlas_demo.py [--quick]
  --quick shrinks to 2,048 cells for a smoke run.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np


PLANT_RANK = 12


def simulate_atlas(n_genes=20480, n_cells=100352, rank=PLANT_RANK,
                   base_cells=2048, seed=0):
    """Planted-type atlas: per-type gamma gene programs, cells tiled
    from a base block (per-element Poisson sampling runs ~100
    Melem/min on host; tiling keeps generation O(base) with identical
    per-sweep device work).  Counts capped int8-safe so the driver's
    storage_dtype='auto' picks the compressed layout."""
    rng = np.random.default_rng(seed)
    tile = max(1, n_cells // base_cells)
    mb = n_cells // tile
    w = rng.gamma(0.35, 1.0, (n_genes, rank)).astype(np.float32)
    # unbalanced type proportions (realistic atlas)
    props = rng.dirichlet(np.full(rank, 1.5))
    types = rng.choice(rank, size=mb, p=props)
    h = np.zeros((rank, mb), np.float32)
    h[types, np.arange(mb)] = rng.gamma(3.0, 1.0, mb)
    h += rng.gamma(0.15, 0.3, (rank, mb))       # cross-type leakage
    # realistic sequencing depth: ~2,500 UMI/cell over 20k genes
    # (~8-10% nonzero — scRNA reality, and the density regime the
    # CSR container is designed for; a mean-2.0-per-element matrix
    # would be 86% dense and nonsensical as 10x data)
    scale = 2500.0 * mb / float(w.sum(axis=0) @ h.sum(axis=1))
    x = np.empty((n_genes, mb), np.int8)
    for i0 in range(0, n_genes, 2048):
        mu = (w[i0:i0 + 2048] @ h) * scale
        x[i0:i0 + 2048] = np.minimum(rng.poisson(mu), 127)
    x = np.tile(x, (1, tile))
    types = np.tile(types, tile)
    return x, types


def main():
    quick = "--quick" in sys.argv
    import ccfindr_tpu as cf
    from ccfindr_tpu.utils import enable_compile_cache

    enable_compile_cache()

    n_genes = 2048 if quick else 20480
    n_cells = 2048 if quick else 100352
    ranks = list(range(2, 9 if quick else 21))
    phases = {}

    t0 = time.perf_counter()
    x, types = simulate_atlas(n_genes=n_genes, n_cells=n_cells,
                              base_cells=1024 if quick else 2048)
    phases["simulate"] = time.perf_counter() - t0
    print(f"atlas: {x.shape[0]} genes x {x.shape[1]} cells, "
          f"{PLANT_RANK} planted types "
          f"[{phases['simulate']:.1f}s]", flush=True)

    t0 = time.perf_counter()
    s = cf.SCSet(count=x)
    ncells0 = s.n_cells
    s = cf.filter_cells(s, umi_min=1, plot=False)
    s = cf.filter_genes(s, vmr_min=1.05, min_cells_expressed=50,
                        plot=False, verbose=False)
    if s.n_cells != ncells0:
        # default colnames are original column indices — map the
        # planted types through the surviving cells
        types = types[np.asarray(s.colnames, dtype=np.int64)]
    phases["qc"] = time.perf_counter() - t0
    print(f"QC: {s.n_genes} genes x {s.n_cells} cells kept "
          f"[{phases['qc']:.1f}s]", flush=True)

    t0 = time.perf_counter()
    res = cf.vb_factorize(s, ranks=ranks, nrun=2, verbose=1,
                          Itmax=300, seed=0, backend="pallas")
    phases["rank_scan"] = time.perf_counter() - t0
    print(f"rank scan {ranks[0]}..{ranks[-1]} x 2 restarts "
          f"[{phases['rank_scan']:.1f}s]", flush=True)

    t0 = time.perf_counter()
    opt = cf.optimal_rank(res)
    phases["optimal_rank"] = time.perf_counter() - t0
    print(f"optimal rank: {opt['ropt']} (type {opt['type']}; "
          f"planted {PLANT_RANK})", flush=True)

    t0 = time.perf_counter()
    tree = cf.build_tree(res, rmax=opt["ropt"])
    newick = cf.newick(tree)
    phases["tree"] = time.perf_counter() - t0
    print(f"cluster tree to rank {opt['ropt']}: "
          f"{newick[:70]}... [{phases['tree']:.2f}s]", flush=True)

    t0 = time.perf_counter()
    meta = cf.meta_genes(res, rank=opt["ropt"], max_per_cluster=10)
    phases["metagenes"] = time.perf_counter() - t0

    # planted-type recovery at the planted rank (if scanned)
    concord = None
    if PLANT_RANK in res.ranks:
        cid = cf.cluster_id(res, rank=PLANT_RANK).to_numpy() - 1
        # permutation-free concordance: map each planted type to its
        # majority cluster and score the partition agreement
        remap = {}
        for t in range(PLANT_RANK):
            mask = types == t
            if mask.any():
                remap[t] = np.bincount(cid[mask],
                                       minlength=PLANT_RANK).argmax()
        concord = float(np.mean([remap[t] == c for t, c in
                                 zip(types, cid) if t in remap]))
        print(f"cluster concordance with planted types at "
              f"r={PLANT_RANK}: {concord:.3f}", flush=True)

    t0 = time.perf_counter()
    try:
        import matplotlib
        matplotlib.use("Agg")
        cf.visualize_clusters(res, rank=opt["ropt"],
                              max_cells=3000, seed=0)
        phases["tsne_3k"] = time.perf_counter() - t0
    except Exception as e:             # noqa: BLE001
        print("t-SNE skipped:", e)

    total = sum(phases.values())
    print(json.dumps({"metric": "atlas_workflow",
                      "n_cells": int(s.n_cells),
                      "ranks": f"{ranks[0]}..{ranks[-1]}",
                      "ropt": int(opt["ropt"]),
                      "concordance": concord,
                      "phases_s": {k: round(v, 1)
                                   for k, v in phases.items()},
                      "total_s": round(total, 1)}), flush=True)
    return opt["ropt"], concord, phases


if __name__ == "__main__":
    main()
