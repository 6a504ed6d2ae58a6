"""Graph clustering: device kNN graph + host Louvain (RUN_GRAPH_CLUSTERING_NG
analog, lib/rust/cr_ana/src/stages/graph_clustering.rs:84 — kNN over PCA
space, then Louvain community detection; the reference's legacy path shells
out to a C++ louvain binary, analysis/graphclust.py:34,114).

The O(N^2) neighbor search runs as matmul distance blocks at HIGHEST
precision (the kNN edges decide the Louvain labels); Louvain's sequential
modularity sweeps are host python over the sparse kNN graph (communities
are data-dependent control flow, not a fixed-shape device computation)."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("k",))
def knn_graph(x: jnp.ndarray, k: int):
    """x [n, d] -> (indices int32 [n, k], dists [n, k]) excluding self."""
    d2 = (jnp.sum(x ** 2, axis=1, keepdims=True)
          - 2 * jnp.matmul(x, x.T, precision=jax.lax.Precision.HIGHEST)
          + jnp.sum(x ** 2, axis=1)[None, :])
    d2 = d2.at[jnp.arange(x.shape[0]), jnp.arange(x.shape[0])].set(jnp.inf)
    neg, idx = jax.lax.top_k(-d2, k)
    return idx.astype(jnp.int32), -neg


def default_knn_k(n: int) -> int:
    """The reference uses ceil(sqrt(n)/2) neighbors by default
    (cr_ana graph_clustering / python graphclust compute_nearest_neighbors)."""
    return max(2, int(np.ceil(np.sqrt(n) / 2)))


def louvain(edges_src, edges_dst, weights, n_nodes: int, seed: int = 0,
            max_levels: int = 10, max_sweeps: int = 50):
    """Louvain modularity clustering; returns int labels [n_nodes].

    Standard two-phase algorithm (Blondel et al. 2008): local move sweeps to
    a fixpoint, then graph aggregation, repeated while modularity improves.
    Deterministic given the seed (node visitation order is a seeded
    permutation per sweep).
    """
    rng = np.random.RandomState(seed)
    # symmetrize
    src = np.concatenate([edges_src, edges_dst])
    dst = np.concatenate([edges_dst, edges_src])
    w = np.concatenate([weights, weights]).astype(np.float64)

    node_map = np.arange(n_nodes)

    for _level in range(max_levels):
        n = int(node_map.max()) + 1 if len(node_map) else 0
        # adjacency in CSR-ish form
        order = np.argsort(src, kind="stable")
        s, d, ww = src[order], dst[order], w[order]
        starts = np.searchsorted(s, np.arange(n + 1))
        degree = np.bincount(s, weights=ww, minlength=n)
        total_w = ww.sum() / 2.0
        if total_w <= 0:
            break
        comm = np.arange(n)
        comm_deg = degree.copy()

        improved_any = False
        for _sweep in range(max_sweeps):
            moved = 0
            for u in rng.permutation(n):
                cu = comm[u]
                lo, hi = starts[u], starts[u + 1]
                nbr_c = comm[d[lo:hi]]
                nbr_w = ww[lo:hi]
                # weight from u to each neighboring community
                uniq, inv = np.unique(nbr_c, return_inverse=True)
                w_to = np.bincount(inv, weights=nbr_w)
                ku = degree[u]
                comm_deg[cu] -= ku
                # self-links to own community (excluding u itself)
                base = 0.0
                gains = w_to - ku * comm_deg[uniq] / (2 * total_w)
                if cu in uniq:
                    base = gains[np.searchsorted(uniq, cu)]
                best = int(np.argmax(gains))
                if gains[best] > base + 1e-12 and uniq[best] != cu:
                    comm[u] = uniq[best]
                    comm_deg[uniq[best]] += ku
                    moved += 1
                else:
                    comm_deg[cu] += ku
            if moved == 0:
                break
            improved_any = True
        # relabel communities compactly
        uniq, comm = np.unique(comm, return_inverse=True)
        node_map = comm[node_map]
        if not improved_any or len(uniq) == n:
            break
        # aggregate graph
        src = comm[src]
        dst = comm[dst]
        agg = {}
        for a, b, x in zip(src, dst, w):
            agg[(a, b)] = agg.get((a, b), 0.0) + x
        src = np.fromiter((k1 for k1, _ in agg), int, len(agg))
        dst = np.fromiter((k2 for _, k2 in agg), int, len(agg))
        w = np.fromiter(agg.values(), float, len(agg))
    return node_map


def run_graph_clustering(proj: np.ndarray, k: int | None = None,
                         seed: int = 0) -> np.ndarray:
    """PCA projection -> 1-based cluster labels via kNN + Louvain."""
    n = proj.shape[0]
    if n < 3:
        return np.ones(n, int)
    k = k or min(default_knn_k(n), n - 1)
    idx, dists = knn_graph(jnp.asarray(proj, jnp.float32), k)
    idx = np.asarray(idx)
    src = np.repeat(np.arange(n), k)
    dst = idx.ravel()
    # shared-neighbor weighting: unweighted kNN edges (the reference's NN
    # graph is unweighted, graph_clustering.rs builds a binary adjacency)
    wts = np.ones(len(src))
    labels = louvain(src, dst, wts, n, seed=seed)
    # order clusters by size (largest first), 1-based — matches reference
    # output convention
    uniq, counts = np.unique(labels, return_counts=True)
    order = uniq[np.argsort(-counts)]
    remap = {c: i + 1 for i, c in enumerate(order)}
    return np.asarray([remap[c] for c in labels])
