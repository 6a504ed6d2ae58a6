"""PCA: randomized subspace-iteration SVD (RUN_PCA_NG analog,
lib/rust/cr_ana/src/stages/pca2.rs via scan-rs; python twin analysis/pca.py).

The reference runs IRLBA on CPU; the device form is randomized SVD — three
dense matmuls per power iteration. For cells x features matrices at
single-cell scale (<=1e5 x 3e4) the dense form fits in device memory in
f32; inputs arrive already log-normalized/standardized
(analysis.preprocess). Matmuls run at HIGHEST precision: the projection
feeds k-means and graph clustering, whose labels are discrete.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

N_COMPONENTS_DEFAULT = 10  # analysis/constants.py:53


@functools.partial(jax.jit, static_argnames=("n_components", "n_iter"))
def randomized_svd(x: jnp.ndarray, n_components: int = N_COMPONENTS_DEFAULT,
                   n_iter: int = 7, seed: int = 0):
    """x [n, f] float32 -> (u [n,k], s [k], vt [k,f])."""
    n, f = x.shape
    k = min(n_components + 10, min(n, f))  # oversampling
    key = jax.random.PRNGKey(seed)
    q = jax.random.normal(key, (f, k), dtype=jnp.float32)
    mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
    y = mm(x, q)
    for _ in range(n_iter):
        q, _ = jnp.linalg.qr(y)
        y = mm(x, mm(x.T, q))
    q, _ = jnp.linalg.qr(y)
    b = mm(q.T, x)                    # [k, f]
    ub, s, vt = jnp.linalg.svd(b, full_matrices=False)
    u = mm(q, ub)
    kk = n_components
    return u[:, :kk], s[:kk], vt[:kk]


def run_pca(x_dense: np.ndarray, n_components: int = N_COMPONENTS_DEFAULT):
    """x_dense [cells, features] standardized -> dict with the reference's
    PCA output fields (transformed_pca_matrix, components, variance
    explained, dispersion/feature bookkeeping left to caller)."""
    n, f = x_dense.shape
    k = min(n_components, max(1, min(n, f) - 1))
    u, s, vt = randomized_svd(jnp.asarray(x_dense, jnp.float32), k)
    proj = np.asarray(u * s[None, :], np.float64)
    total_var = float(np.sum(x_dense.astype(np.float64) ** 2) / max(n - 1, 1))
    var_explained = np.asarray(s, np.float64) ** 2 / max(n - 1, 1)
    return dict(
        transformed_pca_matrix=proj,
        components=np.asarray(vt, np.float64),
        variance_explained=var_explained,
        variance_explained_ratio=var_explained / max(total_var, 1e-12),
    )
