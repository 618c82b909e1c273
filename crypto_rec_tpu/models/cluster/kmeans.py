"""Full k-means driver: init -> (assign -> update) loop -> labels.

Mirrors the reference's driver loop (/root/reference/main.cpp:96-103,
246-256): initialize (random or k-means++), then alternate Lloyd assignment
and k-means update until the update reports convergence (no centroid moved
more than min_dist) or max_algo_iterations is hit.

Batched form: the whole loop is ONE jit — a lax.while_loop whose body is a
distance matmul + argmin + segment-sum.  Nothing crosses back to host until
the final labels.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from crypto_rec_tpu.models.cluster.init import kmeans_pp_init, random_init
from crypto_rec_tpu.models.cluster.assign import lloyd_assign
from crypto_rec_tpu.models.cluster.update import kmeans_update


class KMeansResult(NamedTuple):
    centroids: jax.Array   # [k, d]
    labels: jax.Array      # [n] int32
    dists: jax.Array       # [n] distance to own centroid
    iterations: jax.Array  # scalar int32


@functools.partial(
    jax.jit, static_argnames=("k", "metric", "max_iterations", "init")
)
def kmeans(
    key: jax.Array,
    x: jax.Array,
    k: int,
    metric: str,
    max_iterations: int = 30,
    min_dist: float = 0.05,
    init: str = "kmeans++",
) -> KMeansResult:
    if init == "kmeans++":
        idx = kmeans_pp_init(key, x, k, metric)
    elif init == "random":
        idx = random_init(key, x.shape[0], k)
    else:
        raise ValueError(f"unknown init {init!r}")
    c0 = x[idx]

    def cond(state):
        _c, _labels, _dists, cont, it = state
        return cont & (it < max_iterations)

    def body(state):
        c, _labels, _dists, _cont, it = state
        labels, dists = lloyd_assign(x, c, metric)
        c_new, cont = kmeans_update(x, labels, c, k, metric, min_dist)
        return c_new, labels, dists, cont, it + 1

    labels0 = jnp.zeros((x.shape[0],), jnp.int32)
    dists0 = jnp.zeros((x.shape[0],), jnp.float32)
    state = (c0, labels0, dists0, jnp.bool_(True), jnp.int32(0))
    c, labels, dists, _cont, it = jax.lax.while_loop(cond, body, state)
    # Final assignment against the final centroids (the loop's last labels
    # were computed against the pre-update centroids, same as the reference's
    # post-loop state after its assignment/update ordering).
    labels, dists = lloyd_assign(x, c, metric)
    return KMeansResult(centroids=c, labels=labels, dists=dists, iterations=it)
