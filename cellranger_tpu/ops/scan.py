"""Running maximum by log-doubling, the form device code uses.

Inside the fused count step, `lax.cummax` returned other values on an H100
than on the CPU (the rich golden fixture's novel-junction reads lost their
split alignment), while the same call alone agreed. This form is
ceil(log2 n) shifted elementwise maxima, with the same results on every
backend; PERF.md has the measurement.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def cummax(x, axis: int = 0, reverse: bool = False):
    """Inclusive running maximum of `x` along `axis`."""
    axis = axis % x.ndim
    if reverse:
        return jnp.flip(cummax(jnp.flip(x, axis), axis), axis)
    lowest = (jnp.iinfo(x.dtype).min if jnp.issubdtype(x.dtype, jnp.integer)
              else -jnp.inf)
    fill = jnp.asarray(lowest, x.dtype)
    n, shift = x.shape[axis], 1
    while shift < n:
        cfg = [(0, 0, 0)] * x.ndim
        cfg[axis] = (shift, -shift, 0)      # shift right by `shift` along axis
        x = jnp.maximum(x, jax.lax.pad(x, fill, cfg))
        shift *= 2
    return x
