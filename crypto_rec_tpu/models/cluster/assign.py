"""Cluster assignment: Lloyd argmin and LSH/hypercube reverse range search.

Reference (/root/reference/lib/clustering_phases/assignment.hpp):
* lloyds_assignment — per point, argmin distance over centroids (:54-80);
* lloyds_for_remaining — same, but only for still-unassigned points (:83-105);
* lsh_range_assignment / cube_range_assignment — "reverse" assignment: each
  centroid queries the index for its candidate bucket union, then a
  doubling-radius ball-growing pass assigns/steals points, and Lloyd's mops
  up the leftovers (:108-152);
* range_assignment — radius starts at (min pairwise centroid distance) / 2
  and doubles until a round assigns nothing (:155-217).  Quirk not copied:
  the reference doubles the radius once per *centroid* per round
  (:211-212 sit inside the centroid loop), so later centroids search wider
  windows in the same round; we double once per round.

Batched form: Lloyd is one [n, d] x [d, k] distance matmul + argmin.  Range
assignment is a lax.while_loop whose body does one dense masked window
update per round — no per-point loops, distances computed once up front.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from crypto_rec_tpu.ops.distances import pairwise_distances

# numpy scalar, NOT jnp: module-level jnp constants initialize the XLA
# backend at import, breaking jax.distributed.initialize (multi-host)
UNASSIGNED = np.int32(-1)

# assignment is an argmin over distances: at DEFAULT precision a GPU may
# compute them in TF32 and flip near-tied points between clusters, which
# changes recommendations by device (ops/distances.py)
HIGHEST = jax.lax.Precision.HIGHEST


@functools.partial(jax.jit, static_argnames=("metric",))
def lloyd_assign(
    x: jax.Array, centroids: jax.Array, metric: str
) -> Tuple[jax.Array, jax.Array]:
    """[n, d] x [k, d] -> (labels [n] int32, dist-to-centroid [n])."""
    d = pairwise_distances(x, centroids, metric, precision=HIGHEST)
    labels = jnp.argmin(d, axis=1).astype(jnp.int32)
    dists = jnp.min(d, axis=1)
    return labels, dists


@functools.partial(jax.jit, static_argnames=("metric",))
def lloyd_for_remaining(
    x: jax.Array,
    centroids: jax.Array,
    labels: jax.Array,
    dists: jax.Array,
    metric: str,
) -> Tuple[jax.Array, jax.Array]:
    """Assign only points with label == -1 (assignment.hpp:83-105)."""
    new_labels, new_dists = lloyd_assign(x, centroids, metric)
    todo = labels == UNASSIGNED
    return (
        jnp.where(todo, new_labels, labels),
        jnp.where(todo, new_dists, dists),
    )


@functools.partial(jax.jit, static_argnames=("metric", "max_rounds"))
def range_assign(
    x: jax.Array,
    centroids: jax.Array,
    cand_mask: jax.Array,  # [k, n] bool — centroid c's combined bucket
    metric: str,
    max_rounds: int = 64,
) -> Tuple[jax.Array, jax.Array]:
    """Doubling-radius reverse assignment (assignment.hpp:155-217).

    Per round, a point inside some centroid's [min_radius, radius) window
    (and in its candidate bucket) is assigned to the nearest such centroid if
    unassigned, or stolen if strictly closer than its current distance.
    Returns (labels, dists) with -1 labels for never-reached points.
    """
    n = x.shape[0]
    d = pairwise_distances(centroids, x, metric, precision=HIGHEST)  # [k, n]
    d_masked = jnp.where(cand_mask, d, jnp.inf)

    # Initial radius: min pairwise centroid distance / 2
    # (find_min_vector_distance, utils.hpp:161-178).
    dcc = pairwise_distances(centroids, centroids, metric, precision=HIGHEST)
    k = centroids.shape[0]
    dcc = jnp.where(jnp.eye(k, dtype=bool), jnp.inf, dcc)
    r0 = jnp.min(dcc) / 2.0

    def cond(state):
        _labels, _dists, _minr, _r, assigned, rounds = state
        return (assigned > 0) & (rounds < max_rounds)

    def body(state):
        labels, dists, min_r, r, _assigned, rounds = state
        in_window = (d_masked >= min_r) & (d_masked < r)   # [k, n]
        window_d = jnp.where(in_window, d_masked, jnp.inf)
        best_c = jnp.argmin(window_d, axis=0).astype(jnp.int32)  # [n]
        best_d = jnp.min(window_d, axis=0)
        reachable = jnp.isfinite(best_d)
        take = reachable & ((labels == UNASSIGNED) | (best_d < dists))
        new_labels = jnp.where(take, best_c, labels)
        new_dists = jnp.where(take, best_d, dists)
        return (
            new_labels,
            new_dists,
            r,
            r * 2.0,
            jnp.sum(take.astype(jnp.int32)),
            rounds + 1,
        )

    labels0 = jnp.full((n,), UNASSIGNED)
    dists0 = jnp.full((n,), jnp.inf, jnp.float32)
    state = (labels0, dists0, jnp.float32(0.0), r0, jnp.int32(1), jnp.int32(0))
    labels, dists, *_ = jax.lax.while_loop(cond, body, state)
    return labels, dists


def index_range_assign(
    x: jax.Array,
    centroids: jax.Array,
    cand_mask: jax.Array,
    metric: str,
) -> Tuple[jax.Array, jax.Array]:
    """lsh_range_assignment / cube_range_assignment (assignment.hpp:108-152):
    range-assign from the index's candidate masks, Lloyd for leftovers.

    `cand_mask` comes from models.lsh.index.candidate_mask (centroids as
    queries, unfiltered — the reference uses get_LSH_combined_buckets here)
    or models.lsh.hypercube.cube_candidate_mask.
    """
    labels, dists = range_assign(x, centroids, cand_mask, metric)
    return lloyd_for_remaining(x, centroids, labels, dists, metric)
