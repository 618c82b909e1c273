"""Centroid initialization: uniform random selection and k-means++.

Reference (/root/reference/lib/clustering_phases/initialization.hpp):
* rand_selection — k distinct uniform picks with resample-on-collision
  (:40-68); here a single `jax.random.choice(replace=False)`;
* k_means_pp — D^2 sampling: per new centroid, every point's min distance to
  the chosen set, normalized by the max, squared, prefix-summed, then a
  uniform draw located by binary search (:72-156).  Normalize-then-square
  keeps the same sampling distribution as plain D^2 (the max cancels), so
  this IS standard k-means++.

Batched form: the reference recomputes (with a string-keyed memo map) every
point-to-centroid distance each round — O(n * k^2) distance evaluations.  We
keep a running elementwise min, so each round is ONE [n, d] x [d, 1] distance
computation: O(n * k) total, fully fused under one jit with a fori_loop.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from crypto_rec_tpu.ops.distances import pairwise_distances


def random_init(key: jax.Array, n: int, k: int) -> jax.Array:
    """k distinct row indexes (initialization.hpp:40-68)."""
    return jax.random.choice(key, n, shape=(k,), replace=False)


@functools.partial(jax.jit, static_argnames=("k", "metric"))
def kmeans_pp_init(
    key: jax.Array, x: jax.Array, k: int, metric: str
) -> jax.Array:
    """k-means++ D^2-sampled row indexes (initialization.hpp:72-156)."""
    n = x.shape[0]
    key, kfirst = jax.random.split(key)
    first = jax.random.randint(kfirst, (), 0, n)

    def body(i, state):
        chosen, min_d, key = state
        last = jax.lax.dynamic_index_in_dim(x, chosen[i - 1], keepdims=True)
        d = pairwise_distances(
            x, last, metric, precision=jax.lax.Precision.HIGHEST)[:, 0]
        min_d = jnp.minimum(min_d, d)
        # Normalize by max, square, prefix-sum, uniform draw, binary search
        # (initialization.hpp:118-152).
        w = jnp.square(min_d / jnp.maximum(jnp.max(min_d), 1e-30))
        cum = jnp.cumsum(w)
        key, kdraw = jax.random.split(key)
        r = jax.random.uniform(kdraw, (), minval=0.0, maxval=cum[-1])
        pick = jnp.searchsorted(cum, r, side="left").astype(jnp.int32)
        pick = jnp.minimum(pick, n - 1)
        return chosen.at[i].set(pick), min_d, key

    chosen0 = jnp.zeros((k,), jnp.int32).at[0].set(first)
    min_d0 = jnp.full((n,), jnp.inf, jnp.float32)
    chosen, _, _ = jax.lax.fori_loop(1, k, body, (chosen0, min_d0, key))
    return chosen
