"""End-to-end PBMC workflow — the reference vignette replayed
(vignettes/ccfindR.Rmd:122-477) on a GPU.

Reads the bundled 10x PBMC subsample (1,030 genes x 450 cells drawn
from five purified immune subsets), QC-filters, runs the VB rank scan,
selects the optimal rank (ground truth: 5), extracts metagenes, builds
the cluster tree, and assigns cell types by marker-gene GSEA.

The rank scan runs on the fused X-pass GPU kernel
(``backend='pallas'``); without a GPU pass ``--backend=dense`` to run
the same math in plain XLA on the CPU.

Usage:  python examples/pbmc_workflow.py [--backend=NAME] [path/to/10x_dir]
"""

import sys
sys.path.insert(0, ".")
import time

import numpy as np

import ccfindr_tpu as cf

# vignette marker sets (reference R/gsea.R:33-37, ccfindR.Rmd:448)
MARKERS = {
    "B cell": ["CD74", "IG", "HLA"],
    "CD4+ T cell": ["CD3D", "CD3E", "IL7R", "LEF1"],
    "CD8+ T cell": ["CD8A", "CD8B", "GZMK", "CCR7", "LTB"],
    "Monocyte": ["S100A8", "S100A9", "LYZ", "CST3"],
    "NK cell": ["NKG7", "GNLY", "GZMB", "KLRD1"],
}


def main(tenx_dir=None, backend="pallas"):
    t0 = time.time()
    if tenx_dir is None:
        # real PBMC when the reference mount exists, else the bundled
        # synthetic analog (ccfindr_tpu/data) — self-contained
        import os
        ref = "/root/reference/inst/extdata"
        if os.path.isdir(ref):
            tenx_dir = ref
        else:
            from ccfindr_tpu.data import pbmc_sim_dir
            tenx_dir = pbmc_sim_dir()
    s = cf.read_10x(tenx_dir)
    print(f"loaded {s.n_genes} genes x {s.n_cells} cells "
          f"({s.counts.nnz} nonzeros)")

    # QC (vignette thresholds, ccfindR.Rmd:236-276; the bundled
    # synthetic set has a tighter UMI distribution)
    umi_min, umi_max = ((300, 10000) if "extdata" in tenx_dir
                        else (700, 8000))
    s = cf.filter_cells(s, umi_min=umi_min, umi_max=umi_max, plot=False)
    s = cf.filter_genes(s, vmr_min=1.2, min_cells_expressed=50,
                        plot=False)
    print(f"after QC: {s.n_genes} x {s.n_cells}")

    # VB rank scan — all (rank, restart) instances run as one batched
    # device loop on the fused X-pass kernel
    res = cf.vb_factorize(s, ranks=list(range(2, 9)), nrun=5,
                          verbose=1, Itmax=3000, backend=backend)
    opt = cf.optimal_rank(res)
    print(f"optimal rank: {opt['ropt']} (heterogeneity type "
          f"{opt['type']}; vignette ground truth: 5)")

    rank = opt["ropt"]
    cid = cf.cluster_id(res, rank=rank)
    print("cluster sizes:", np.bincount(np.asarray(cid))[1:])

    gene_names = res.row_data.iloc[:, 1].to_numpy()
    meta = cf.meta_genes(res, rank=rank, max_per_cluster=8,
                         gene_names=gene_names)
    for k, genes in enumerate(meta):
        print(f"  metagenes {k + 1}: {', '.join(map(str, genes[:8]))}")

    tree = cf.build_tree(res, rmax=rank)
    print("cluster hierarchy:", cf.newick(tree))

    es = cf.assign_celltype(res, rank=rank, gset=MARKERS,
                            gene_names=gene_names,
                            grp_prefix=("IG", "HLA"))
    print("\nGSEA enrichment (rows=cell types, cols=clusters):")
    print(es.round(3))
    best = es.idxmax(axis=0)
    for cl, ct in best.items():
        print(f"  cluster {cl}: {ct}")
    print(f"\ntotal {time.time() - t0:.1f}s")


if __name__ == "__main__":
    opts = [a for a in sys.argv[1:] if a.startswith("--backend=")]
    args = [a for a in sys.argv[1:] if not a.startswith("--backend=")]
    main(*args, **({"backend": opts[-1].split("=", 1)[1]}
                   if opts else {}))
