"""Centroid update: k-means mean update and PAM medoid swap.

Reference (/root/reference/lib/clustering_phases/update.hpp):
* k_means — new center = mean of its members (:42-58); clustering continues
  iff at least one center moved more than `min_dist`, in which case ALL
  centers swap to the new means; otherwise the old centers are kept
  (:63-85);
* pam_lloyds — per cluster, medoid = member minimizing the summed
  intra-cluster distance; swap if it differs from the current centroid
  (:90-142).

Batched form: the member-mean is a segment_sum (one scatter-add) instead of a
pointer walk; the PAM cost matrix is a blocked [n, n] distance product
against a one-hot label matrix, so per-cluster sums are one matmul.
Deviation: an empty cluster keeps its previous centroid — the reference's
divDimensionsByD guards division by zero and leaves the zero vector
(cust_vector.hpp:187-194), a quirk we fix.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from crypto_rec_tpu.ops.distances import pairwise_distances

# cluster membership is decided by comparing distances: HIGHEST keeps a
# GPU from deciding it in TF32 (see cluster/assign.py)
HIGHEST = jax.lax.Precision.HIGHEST


@functools.partial(jax.jit, static_argnames=("k", "metric"))
def kmeans_update(
    x: jax.Array,
    labels: jax.Array,
    old_centroids: jax.Array,
    k: int,
    metric: str,
    min_dist: float,
) -> Tuple[jax.Array, jax.Array]:
    """-> (centroids, continue_clustering) per update.hpp:37-86."""
    sums = jax.ops.segment_sum(x, labels, num_segments=k)
    counts = jax.ops.segment_sum(jnp.ones((x.shape[0],), x.dtype), labels, num_segments=k)
    means = sums / jnp.maximum(counts, 1.0)[:, None]
    new_c = jnp.where((counts > 0)[:, None], means, old_centroids)

    # Per-centroid movement: diagonal of the pairwise metric.
    moved = jax.vmap(
        lambda a, b: pairwise_distances(
            a[None], b[None], metric, precision=HIGHEST)[0, 0]
    )(new_c, old_centroids)
    cont = jnp.any(moved > min_dist)
    # Reference: if any center moved, swap all; else keep old and stop.
    centroids = jnp.where(cont, new_c, old_centroids)
    return centroids, cont


@functools.partial(jax.jit, static_argnames=("k", "metric", "block_rows"))
def pam_update(
    x: jax.Array,
    labels: jax.Array,
    medoid_idx: jax.Array,  # [k] current medoid row indexes
    k: int,
    metric: str,
    block_rows: int = 1024,
) -> Tuple[jax.Array, jax.Array]:
    """PAM-Lloyd medoid update (update.hpp:90-142).

    -> (new medoid row indexes [k], any_swapped bool).  cost[i] = sum of
    distances from i to its co-members, computed blockwise as
    D[block, n] @ onehot(labels) then picking each row's own-cluster column.
    """
    n = x.shape[0]
    onehot = jax.nn.one_hot(labels, k, dtype=jnp.float32)     # [n, k]

    pad = (-n) % block_rows
    xp = jnp.pad(x, ((0, pad), (0, 0)))
    blocks = xp.reshape(-1, block_rows, x.shape[1])

    def block_cost(blk):
        d = pairwise_distances(blk, x, metric, precision=HIGHEST)  # [b, n]
        return jnp.dot(d, onehot, precision=HIGHEST,
                       preferred_element_type=jnp.float32)      # [b, k]

    costs = jax.lax.map(block_cost, blocks).reshape(-1, k)[:n]
    own_cost = jnp.take_along_axis(costs, labels[:, None], axis=1)[:, 0]

    # argmin own_cost within each cluster — ties break to the lowest row
    # index, like the reference's "<" scan (update.hpp:121-125).
    big = jnp.float32(jnp.inf)
    per_cluster = jnp.where(onehot.astype(bool).T, own_cost[None, :], big)  # [k, n]
    new_medoids = jnp.argmin(per_cluster, axis=1).astype(jnp.int32)
    has_members = jnp.any(onehot.astype(bool).T, axis=1)
    new_medoids = jnp.where(has_members, new_medoids, medoid_idx)
    swapped = jnp.any(new_medoids != medoid_idx)
    return new_medoids, swapped
