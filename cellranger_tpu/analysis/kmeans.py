"""K-means (RUN_KMEANS analog, analysis/kmeans.py).

Lloyd iterations as dense matmuls: distances via |x|^2 - 2 x.c + |c|^2
(HIGHEST precision: the argmin labels are discrete), argmin per cell,
segment-sum centroid update. kmeans++-style
seeding with a fixed seed (the reference seeds sklearn KMeans with
random_state=0).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np



@functools.partial(jax.jit, static_argnames=("k", "n_iter"))
def kmeans_fit(x: jnp.ndarray, k: int, n_iter: int = 100, seed: int = 0):
    """x [n, d] float32 -> (labels int32 [n], centers [k, d], inertia)."""
    n, d = x.shape
    key = jax.random.PRNGKey(seed)

    # k-means++ seeding
    def seed_body(carry, _):
        centers, n_chosen, key = carry
        d2 = jnp.min(
            jnp.sum((x[:, None, :] - centers[None, :, :]) ** 2, axis=-1)
            + jnp.where(jnp.arange(k)[None, :] < n_chosen, 0.0, jnp.inf),
            axis=1)
        key, sub = jax.random.split(key)
        p = d2 / jnp.maximum(d2.sum(), 1e-12)
        idx = jax.random.choice(sub, n, p=p)
        centers = centers.at[n_chosen].set(x[idx])
        return (centers, n_chosen + 1, key), None

    key, sub = jax.random.split(key)
    first = x[jax.random.choice(sub, n)]
    centers0 = jnp.zeros((k, d), x.dtype).at[0].set(first)
    (centers, _, _), _ = jax.lax.scan(
        seed_body, (centers0, 1, key), None, length=k - 1)

    def sq_dists(centers):
        xc = jnp.matmul(x, centers.T, precision=jax.lax.Precision.HIGHEST)
        return (jnp.sum(x ** 2, axis=1, keepdims=True) - 2 * xc
                + jnp.sum(centers ** 2, axis=1)[None, :])

    def lloyd(_, carry):
        centers, _ = carry
        d2 = sq_dists(centers)
        labels = jnp.argmin(d2, axis=1).astype(jnp.int32)
        sums = jax.ops.segment_sum(x, labels, num_segments=k)
        counts = jax.ops.segment_sum(jnp.ones(n, x.dtype), labels, num_segments=k)
        new_centers = jnp.where(counts[:, None] > 0,
                                sums / jnp.maximum(counts[:, None], 1), centers)
        return new_centers, labels

    centers, labels = jax.lax.fori_loop(
        0, n_iter, lloyd, (centers, jnp.zeros(n, jnp.int32)))
    d2 = sq_dists(centers)
    inertia = jnp.sum(jnp.min(d2, axis=1))
    return labels, centers, inertia


def run_kmeans(proj: np.ndarray, k: int, seed: int = 0):
    labels, centers, inertia = kmeans_fit(
        jnp.asarray(proj, jnp.float32), k, seed=seed)
    return (np.asarray(labels) + 1,  # reference clusters are 1-based
            np.asarray(centers), float(inertia))
