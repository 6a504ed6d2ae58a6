"""t-SNE (RUN_TSNE_NG analog, cr_ana/stages/tsne.rs via bhtsne).

The reference uses Barnes-Hut t-SNE (O(N log N), pointer quadtrees — hostile
to SIMD). The device form is exact t-SNE: the [N, N] affinity and repulsion
matrices are dense matmul work, bounded by analysis/run.py's cell cap.
Matmuls run at HIGHEST precision, so the embedding does not depend on the
backend's default float32 matmul mode. Perplexity calibration is a
vectorized binary search on beta.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

TSNE_DEFAULT_PERPLEXITY = 30   # analysis/constants.py:19
TSNE_DEFAULT_COMPONENTS = 2
TSNE_THETA = 0.5
TSNE_MAX_ITER = 1000
TSNE_STOP_LYING_ITER = 250
TSNE_MOM_SWITCH_ITER = 250
_HP = jax.lax.Precision.HIGHEST


def _pairwise_sq_dists(x):
    s = jnp.sum(x ** 2, axis=1)
    return (s[:, None] - 2 * jnp.matmul(x, x.T, precision=_HP)
            + s[None, :])


@functools.partial(jax.jit, static_argnames=("perplexity",))
def _calibrated_p(x, perplexity: int = TSNE_DEFAULT_PERPLEXITY):
    """Binary-search per-point beta so conditional entropy = log(perplexity);
    returns symmetrized, normalized P."""
    n = x.shape[0]
    d2 = _pairwise_sq_dists(x)
    d2 = d2.at[jnp.arange(n), jnp.arange(n)].set(0.0)
    eye = jnp.eye(n, dtype=bool)
    target = jnp.log(jnp.float32(perplexity))

    def entropy_p(beta):
        w = jnp.exp(-d2 * beta[:, None])
        w = jnp.where(eye, 0.0, w)
        sw = jnp.maximum(w.sum(axis=1), 1e-12)
        p = w / sw[:, None]
        h = -jnp.sum(jnp.where(p > 0, p * jnp.log(p), 0.0), axis=1)
        return h, p

    def body(_, carry):
        lo, hi, beta = carry
        h, _ = entropy_p(beta)
        too_high = h > target          # entropy too high -> increase beta
        lo = jnp.where(too_high, beta, lo)
        hi = jnp.where(too_high, hi, beta)
        beta = jnp.where(jnp.isinf(hi), beta * 2, (lo + hi) / 2)
        return lo, hi, beta

    beta0 = jnp.ones(n, jnp.float32)
    lo = jnp.zeros(n, jnp.float32)
    hi = jnp.full(n, jnp.inf, jnp.float32)
    _, _, beta = jax.lax.fori_loop(0, 50, body, (lo, hi, beta0))
    _, p = entropy_p(beta)
    p = (p + p.T) / (2.0 * n)
    return jnp.maximum(p, 1e-12)


@functools.partial(jax.jit, static_argnames=("n_iter",), donate_argnums=())
def _tsne_optimize(p, y0, n_iter: int = TSNE_MAX_ITER):
    n = p.shape[0]
    eye = jnp.eye(n, dtype=bool)

    def grad(y, pp):
        d2 = _pairwise_sq_dists(y)
        q_num = 1.0 / (1.0 + d2)
        q_num = jnp.where(eye, 0.0, q_num)
        z = jnp.maximum(q_num.sum(), 1e-12)
        q = jnp.maximum(q_num / z, 1e-12)
        mult = (pp - q) * q_num
        return 4.0 * jnp.matmul(jnp.diag(mult.sum(axis=1)) - mult, y,
                                precision=_HP)

    def body(i, carry):
        y, vel, gains = carry
        exag = jnp.where(i < TSNE_STOP_LYING_ITER, 12.0, 1.0)
        mom = jnp.where(i < TSNE_MOM_SWITCH_ITER, 0.5, 0.8)
        g = grad(y, p * exag)
        gains = jnp.where(jnp.sign(g) != jnp.sign(vel),
                          gains + 0.2, gains * 0.8)
        gains = jnp.maximum(gains, 0.01)
        vel = mom * vel - 200.0 * gains * g
        y = y + vel
        y = y - y.mean(axis=0)
        return y, vel, gains

    vel = jnp.zeros_like(y0)
    gains = jnp.ones_like(y0)
    y, _, _ = jax.lax.fori_loop(0, n_iter, body, (y0, vel, gains))
    return y


def run_tsne(proj: np.ndarray, n_components: int = TSNE_DEFAULT_COMPONENTS,
             perplexity: int = TSNE_DEFAULT_PERPLEXITY, seed: int = 0,
             n_iter: int = TSNE_MAX_ITER) -> np.ndarray:
    """PCA projection [n, d] -> t-SNE embedding [n, n_components]."""
    n = proj.shape[0]
    if n <= 2:
        return np.zeros((n, n_components))
    perplexity = int(min(perplexity, max(2, (n - 1) // 3)))
    x = jnp.asarray(proj, jnp.float32)
    p = _calibrated_p(x, perplexity)
    key = jax.random.PRNGKey(seed)
    y0 = 1e-4 * jax.random.normal(key, (n, n_components), jnp.float32)
    y = _tsne_optimize(p, y0, n_iter)
    return np.asarray(y, np.float64)
