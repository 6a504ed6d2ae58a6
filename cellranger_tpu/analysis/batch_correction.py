"""Chemistry/batch correction via mutual nearest neighbors
(CORRECT_CHEMISTRY_BATCH analog, lib/python/cellranger/analysis/
batch_correction.py — the fastMNN-style approach of Haghverdi et al. 2018).

Batches are aligned in PCA space: for each non-reference batch, mutual
nearest neighbor pairs against the merged reference define per-pair
correction vectors; each cell applies a Gaussian-kernel-weighted average of
nearby pair vectors. The O(N^2) neighbor searches run as device matmul
distance blocks at HIGHEST precision (the MNN pairs are discrete); the
kernel-weighted average is host float64."""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .graphclust import knn_graph


def _cross_knn(a: np.ndarray, b: np.ndarray, k: int):
    """indices [len(a), k] of b-rows nearest to each a-row."""
    import jax

    a_j = jnp.asarray(a, jnp.float32)
    b_j = jnp.asarray(b, jnp.float32)
    ab = jnp.matmul(a_j, b_j.T, precision=jax.lax.Precision.HIGHEST)
    d2 = (jnp.sum(a_j ** 2, 1)[:, None] - 2 * ab
          + jnp.sum(b_j ** 2, 1)[None, :])
    _, idx = jax.lax.top_k(-d2, min(k, b.shape[0]))
    return np.asarray(idx)


def find_mnn_pairs(ref: np.ndarray, target: np.ndarray, k: int = 20):
    """Mutual nearest neighbor (ref_idx, target_idx) pairs."""
    k = max(1, min(k, len(ref), len(target)))
    t2r = _cross_knn(target, ref, k)   # [T, k]
    r2t = _cross_knn(ref, target, k)   # [R, k]
    r_sets = [set(row) for row in r2t]
    pairs = []
    for t, row in enumerate(t2r):
        for r in row:
            if t in r_sets[r]:
                pairs.append((int(r), int(t)))
    return pairs


def correct_batches(proj: np.ndarray, batches: np.ndarray, k: int = 20,
                    sigma: float | None = None) -> np.ndarray:
    """proj [n, d] PCA coordinates, batches [n] labels. Returns corrected
    coordinates; the first (largest) batch anchors the reference."""
    proj = np.asarray(proj, np.float64).copy()
    labels, counts = np.unique(batches, return_counts=True)
    if len(labels) < 2:
        return proj
    order = labels[np.argsort(-counts)]
    ref_mask = batches == order[0]
    if sigma is None:
        sigma = float(np.median(np.linalg.norm(
            proj - proj.mean(0), axis=1))) / 2 + 1e-9
    for b in order[1:]:
        t_mask = batches == b
        # two passes: the first removes the bulk shift so the second pairs
        # cells within their true populations
        for _ in range(2):
            ref_pts = proj[ref_mask]
            t_pts = proj[t_mask]
            pairs = find_mnn_pairs(ref_pts, t_pts, k=k)
            if not pairs:
                break
            r_idx = np.asarray([p[0] for p in pairs])
            t_idx = np.asarray([p[1] for p in pairs])
            vecs = ref_pts[r_idx] - t_pts[t_idx]      # correction per pair
            anchors = t_pts[t_idx]
            # smooth: Gaussian-weighted vector average per target cell
            d2 = ((t_pts[:, None, :] - anchors[None, :, :]) ** 2).sum(-1)
            w = np.exp(-d2 / (2 * sigma ** 2)) + 1e-12
            corr = (w @ vecs) / w.sum(axis=1, keepdims=True)
            proj[t_mask] = t_pts + corr
        ref_mask = ref_mask | t_mask                   # merged becomes ref
    return proj
