"""Secondary analysis orchestrator — the SC_RNA_ANALYZER pipeline analog
(mro/rna/sc_rna_analyzer.mro:12): PCA -> kmeans K=2..10 + graph clustering
-> differential expression -> t-SNE + UMAP, written in the reference's
analysis/ directory layout (analysis/pca/10_components/projection.csv,
clustering/*/clusters.csv, diffexp/*/differential_expression.csv,
tsne/2_components/projection.csv, umap/2_components/projection.csv).
"""

from __future__ import annotations

import os

import numpy as np

from ..io.matrix_io import CountMatrix
from . import diffexp as de
from .graphclust import run_graph_clustering
from .kmeans import run_kmeans
from .pca import N_COMPONENTS_DEFAULT, run_pca
from .preprocess import log_normalize_dense, select_features
from .tsne import run_tsne
from .umap import run_umap

KMEANS_RANGE = range(2, 11)  # reference: K=2..10


def _write_csv(path, header, rows):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(",".join(header) + "\n")
        for r in rows:
            f.write(",".join(str(x) for x in r) + "\n")


def run_secondary_analysis(matrix: CountMatrix, out_dir: str,
                           n_components: int = N_COMPONENTS_DEFAULT,
                           max_cells_tsne: int = 20000,
                           skip_embeddings: bool = False,
                           num_features: int = 2000,
                           batch_labels=None) -> dict:
    """Filtered matrix -> analysis/ outputs; returns in-memory results."""
    os.makedirs(out_dir, exist_ok=True)
    bcs = [b.decode() for b in matrix.barcodes]
    n_cells = len(bcs)
    results: dict = {}
    if n_cells < 2:
        return results

    features = select_features(matrix.m, num_features)
    if len(features) == 0:
        return results
    x = log_normalize_dense(matrix.m, features)
    pca = run_pca(x, n_components=min(n_components, max(1, min(x.shape) - 1)))
    proj = pca["transformed_pca_matrix"]
    if batch_labels is not None and len(set(batch_labels)) > 1:
        # CORRECT_CHEMISTRY_BATCH analog: MNN alignment of batches in PCA
        # space before clustering/embedding
        from .batch_correction import correct_batches
        proj = correct_batches(proj, np.asarray(batch_labels))
        pca["transformed_pca_matrix"] = proj
        results["batch_corrected"] = True
    results["pca"] = pca
    k_str = f"{proj.shape[1]}_components"
    _write_csv(os.path.join(out_dir, "pca", k_str, "projection.csv"),
               ["Barcode"] + [f"PC-{i+1}" for i in range(proj.shape[1])],
               [[bcs[i]] + list(np.round(proj[i], 6)) for i in range(n_cells)])
    _write_csv(os.path.join(out_dir, "pca", k_str, "variance.csv"),
               ["PC", "Variance.Explained"],
               [[i + 1, v] for i, v in enumerate(pca["variance_explained"])])

    # clustering
    clusterings = {}
    for k in KMEANS_RANGE:
        if k >= n_cells:
            break
        labels, _, _ = run_kmeans(proj, k)
        key = f"kmeans_{k}_clusters"
        clusterings[key] = labels
        _write_csv(os.path.join(out_dir, "clustering", key, "clusters.csv"),
                   ["Barcode", "Cluster"],
                   [[bcs[i], int(labels[i])] for i in range(n_cells)])
    glabels = run_graph_clustering(proj)
    clusterings["graphclust"] = glabels
    _write_csv(os.path.join(out_dir, "clustering", "graphclust", "clusters.csv"),
               ["Barcode", "Cluster"],
               [[bcs[i], int(glabels[i])] for i in range(n_cells)])
    results["clusterings"] = clusterings

    # hierarchical clustering of the graph clusters
    from .hclust import run_hierarchical_clustering
    hc = run_hierarchical_clustering(matrix.m, glabels)
    results["hclust"] = hc
    import json as _json
    os.makedirs(os.path.join(out_dir, "clustering", "graphclust"), exist_ok=True)
    with open(os.path.join(out_dir, "clustering", "graphclust",
                           "hierarchy.json"), "w") as f:
        _json.dump(hc, f)

    # differential expression per clustering
    results["diffexp"] = {}
    for key in ("graphclust",):
        d = de.run_differential_expression(matrix.m, clusterings[key])
        results["diffexp"][key] = d
        ids = matrix.features.ids
        names = [f.name for f in matrix.features.feature_defs]
        header = ["Feature ID", "Feature Name"]
        for c in sorted(d):
            header += [f"Cluster {c} Mean Counts", f"Cluster {c} Log2 fold change",
                       f"Cluster {c} Adjusted p value"]
        rows = []
        for g in range(len(ids)):
            row = [ids[g], names[g]]
            for c in sorted(d):
                r = d[c]
                row += [round(r["norm_mean_a"][g], 6),
                        round(r["log2_fold_change"][g], 6),
                        r["adjusted_p_value"][g]]
            rows.append(row)
        _write_csv(os.path.join(out_dir, "diffexp", key,
                                "differential_expression.csv"), header, rows)

    # embeddings
    if not skip_embeddings and n_cells <= max_cells_tsne:
        ts = run_tsne(proj)
        results["tsne"] = ts
        _write_csv(os.path.join(out_dir, "tsne", "2_components", "projection.csv"),
                   ["Barcode", "TSNE-1", "TSNE-2"],
                   [[bcs[i], round(ts[i, 0], 6), round(ts[i, 1], 6)]
                    for i in range(n_cells)])
        um = run_umap(proj)
        results["umap"] = um
        _write_csv(os.path.join(out_dir, "umap", "2_components", "projection.csv"),
                   ["Barcode", "UMAP-1", "UMAP-2"],
                   [[bcs[i], round(um[i, 0], 6), round(um[i, 1], 6)]
                    for i in range(n_cells)])
    return results
