"""Silhouette cluster evaluation.

Reference (/root/reference/lib/clustering_phases/silhouette.hpp):
* per centroid, find its nearest other centroid (:36-58);
* per point i: a(i) = mean distance to co-members (divided by count-1 when
  the cluster has more than one member, :89-112), b(i) = mean distance to
  the members of the neighbor cluster (:114-136), s = (b - a) / max(a, b);
* returns per-cluster mean silhouettes plus the global mean in the last
  slot (:64-80).

Batched form: the reference's memoized O(n^2) pair loops become blocked
[block, n] distance matmuls; per-cluster sums are one [block, n] x [n, k]
one-hot matmul per block — HBM-streaming, no distance is stored twice.
This is the "blockwise distance computation over a sharded candidate axis"
pattern called out in SURVEY.md §5 (long-context analog).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from crypto_rec_tpu.ops.distances import pairwise_distances


@functools.partial(jax.jit, static_argnames=("k", "metric", "block_rows"))
def silhouette(
    x: jax.Array,
    labels: jax.Array,
    centroids: jax.Array,
    k: int,
    metric: str,
    block_rows: int = 1024,
) -> jax.Array:
    """-> [k + 1] per-cluster mean silhouettes, global mean last."""
    n = x.shape[0]
    onehot = jax.nn.one_hot(labels, k, dtype=jnp.float32)

    # Nearest other centroid (silhouette.hpp:36-58).
    dcc = pairwise_distances(centroids, centroids, metric)
    dcc = jnp.where(jnp.eye(k, dtype=bool), jnp.inf, dcc)
    nearest = jnp.argmin(dcc, axis=1)                       # [k]

    counts = jnp.sum(onehot, axis=0)                        # [k]

    pad = (-n) % block_rows
    xp = jnp.pad(x, ((0, pad), (0, 0)))
    lp = jnp.pad(labels, (0, pad))
    xblocks = xp.reshape(-1, block_rows, x.shape[1])
    lblocks = lp.reshape(-1, block_rows)

    def per_block(args):
        xb, lb = args
        d = pairwise_distances(xb, x, metric)               # [b, n]
        sums = jnp.dot(d, onehot, preferred_element_type=jnp.float32)  # [b, k]
        own = jnp.take_along_axis(sums, lb[:, None], axis=1)[:, 0]
        own_count = counts[lb]
        a_i = own / jnp.maximum(own_count - 1.0, 1.0)       # :109-111
        neigh = nearest[lb]
        b_sum = jnp.take_along_axis(sums, neigh[:, None], axis=1)[:, 0]
        b_i = b_sum / jnp.maximum(counts[neigh], 1.0)
        s = (b_i - a_i) / jnp.maximum(jnp.maximum(a_i, b_i), 1e-30)
        return s

    s = jax.lax.map(per_block, (xblocks, lblocks)).reshape(-1)[:n]
    per_cluster = jax.ops.segment_sum(s, labels, num_segments=k) / jnp.maximum(
        counts, 1.0
    )
    overall = jnp.mean(s)
    return jnp.concatenate([per_cluster, overall[None]])
