"""UMAP (RUN_UMAP analog, cr_ana/stages/umap.rs via umap-rs).

Device formulation: fuzzy simplicial set from the exact kNN graph (matmul
distance blocks), then layout optimization by minimizing the UMAP
cross-entropy with DENSE attraction/repulsion — O(N^2) matmul-shaped work
(HIGHEST precision) instead of the reference's per-edge SGD with negative
sampling, which is irregular scatter work. Defaults mirror the
reference (n_neighbors=30, min_dist=0.3, 2 components;
analysis/constants.py:29-37).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .graphclust import knn_graph

UMAP_N_NEIGHBORS = 30
UMAP_MIN_DIST = 0.3
UMAP_COMPONENTS = 2
UMAP_EPOCHS = 500


def _fit_ab(min_dist: float, spread: float = 1.0):
    """Least-squares fit of the UMAP low-dim curve 1/(1+a d^(2b))."""
    from scipy.optimize import curve_fit

    xs = np.linspace(0, spread * 3, 300)
    ys = np.where(xs < min_dist, 1.0, np.exp(-(xs - min_dist) / spread))
    (a, b), _ = curve_fit(lambda x, a, b: 1.0 / (1.0 + a * x ** (2 * b)),
                          xs, ys, p0=(1.0, 1.0), maxfev=5000)
    return float(a), float(b)


def _fuzzy_graph(idx: np.ndarray, dists: np.ndarray, n: int):
    """kNN -> symmetric fuzzy membership matrix (dense [n, n] float32)."""
    k = idx.shape[1]
    rho = dists[:, 0]
    # binary search sigma_i so sum exp(-(d-rho)/sigma) = log2(k)
    target = np.log2(k)
    lo = np.full(n, 1e-6)
    hi = np.full(n, 1e3)
    for _ in range(40):
        mid = (lo + hi) / 2
        val = np.exp(-(np.maximum(dists - rho[:, None], 0)) / mid[:, None]).sum(1)
        hi = np.where(val > target, mid, hi)
        lo = np.where(val > target, lo, mid)
    sigma = (lo + hi) / 2
    w = np.exp(-np.maximum(dists - rho[:, None], 0) / sigma[:, None])
    m = np.zeros((n, n), np.float32)
    rows = np.repeat(np.arange(n), k)
    m[rows, idx.ravel()] = w.ravel()
    # fuzzy union: a + b - a*b
    return m + m.T - m * m.T


@functools.partial(jax.jit, static_argnames=("n_epochs",))
def _optimize(p, y0, a, b, n_epochs: int = UMAP_EPOCHS):
    n = p.shape[0]
    eye = jnp.eye(n, dtype=bool)

    def body(i, y):
        lr = 1.0 * (1.0 - i / n_epochs)
        diff = y[:, None, :] - y[None, :, :]
        d2 = jnp.maximum(jnp.sum(diff ** 2, axis=-1), 1e-10)
        # attractive: -2ab d^(2b-2) / (1 + a d^2b) * p
        pow_term = a * d2 ** b
        attr_coef = (-2.0 * a * b * d2 ** (b - 1.0)) / (1.0 + pow_term)
        # repulsive: 2b / (d2 (1 + a d^2b)) * (1 - p)
        rep_coef = (2.0 * b) / (d2 * (1.0 + pow_term))
        coef = p * attr_coef + (1.0 - p) * rep_coef * 0.005
        coef = jnp.where(eye, 0.0, coef)
        g = jnp.einsum("ij,ijk->ik", coef, -diff,
                       precision=jax.lax.Precision.HIGHEST)
        y = y - lr * jnp.clip(g, -4.0, 4.0)
        return y - y.mean(axis=0)

    return jax.lax.fori_loop(0, n_epochs, body, y0)


def run_umap(proj: np.ndarray, n_neighbors: int = UMAP_N_NEIGHBORS,
             min_dist: float = UMAP_MIN_DIST,
             n_components: int = UMAP_COMPONENTS, seed: int = 0,
             n_epochs: int = UMAP_EPOCHS) -> np.ndarray:
    n = proj.shape[0]
    if n <= 2:
        return np.zeros((n, n_components))
    k = min(n_neighbors, n - 1)
    idx, d = knn_graph(jnp.asarray(proj, jnp.float32), k)
    p = _fuzzy_graph(np.asarray(idx), np.sqrt(np.maximum(np.asarray(d), 0)), n)
    a, b = _fit_ab(min_dist)
    # spectral-ish init: PCA of the graph via random projection of P
    rng = np.random.RandomState(seed)
    y0 = (p @ rng.normal(size=(n, n_components))).astype(np.float32)
    y0 = 10.0 * y0 / (np.abs(y0).max() + 1e-9)
    y = _optimize(jnp.asarray(p), jnp.asarray(y0), a, b, n_epochs)
    return np.asarray(y, np.float64)
