"""IVF (inverted-file) retrieval: k-means partition + cluster-pruned scoring.

The "clustered re-ranking" leg of BASELINE.json config 5.  Where LSH gathers
scattered bucket members (random-access HBM reads), IVF reorders the corpus
so each cluster is one CONTIGUOUS block of rows — a probe reads whole blocks
at streaming bandwidth.  The clustering
engine is this framework's own k-means (models/cluster/kmeans.py), i.e. the
reference's clustering capability redeployed as an index structure.

Build: k-means over the corpus (optionally on a subsample), assign every
row, sort rows by cluster, pad each cluster block to a fixed capacity
(static shapes; the capacity covers the largest cluster, fill rows point at
sentinel and score -inf).

Query: one [q, d] x [d, K] centroid matmul -> top-nprobe clusters ->
dynamic-slice their blocks -> one fused score + top-k over
[q, nprobe * capacity] candidates.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from crypto_rec_tpu.models.cluster.kmeans import kmeans
from crypto_rec_tpu.ops.distances import pairwise_distances


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=("centroids", "blocks", "block_rows", "row_ids"),
    meta_fields=("metric", "n_clusters", "capacity", "n_rows", "dropped_rows"),
)
@dataclasses.dataclass
class IvfIndex:
    """Cluster-blocked corpus.

    blocks:      [n_clusters, capacity, d] — rows grouped by cluster, padded.
    row_ids:     [n_clusters, capacity] int32 — original row id, -1 for pad.
    block_rows:  [n_clusters] int32 — true member count per cluster.
    dropped_rows — members beyond a cluster's capacity are NOT indexed;
                   this counts them (no silent truncation — the recall
                   oracle sees exactly what the index can return).
    """

    metric: str
    n_clusters: int
    capacity: int
    n_rows: int
    dropped_rows: int
    centroids: jax.Array
    blocks: jax.Array
    block_rows: jax.Array
    row_ids: jax.Array


@functools.partial(
    jax.jit, static_argnames=("n_clusters", "capacity", "dtype")
)
def _pack_blocks(corpus, labels, n_clusters: int, capacity: int, dtype=None):
    """Device-side block packing under ONE jit dispatch: sort rows by
    cluster, scatter into capacity-padded slots (overflow to a dump slot
    past the table), one gather to fill the blocks."""
    n = corpus.shape[0]
    sorted_labels, order = jax.lax.sort(
        (labels, jnp.arange(n, dtype=jnp.int32)), num_keys=1
    )
    starts = jnp.searchsorted(
        sorted_labels, jnp.arange(n_clusters, dtype=labels.dtype)
    )
    pos = jnp.arange(n, dtype=jnp.int32) - starts[sorted_labels]
    keep = pos < capacity
    slot = jnp.where(
        keep, sorted_labels * capacity + pos, n_clusters * capacity
    )
    flat = jnp.full((n_clusters * capacity + 1,), -1, jnp.int32)
    flat = flat.at[slot].set(order)
    row_ids = flat[:-1].reshape(n_clusters, capacity)

    safe = jnp.maximum(row_ids, 0)
    blocks = corpus[safe]                            # [K, cap, d] device gather
    blocks = jnp.where(row_ids[:, :, None] >= 0, blocks, 0.0)
    if dtype is not None:
        # cast fuses into the gather under jit, so the f32 block tensor
        # never materializes (10 GB at 10M rows)
        blocks = blocks.astype(dtype)
    return row_ids, blocks


def build_ivf(
    key: jax.Array,
    corpus: jax.Array,
    n_clusters: int,
    metric: str = "cosine",
    max_iterations: int = 10,
    train_rows: int = 0,
    capacity: int = 0,
    block_dtype=None,
) -> IvfIndex:
    """k-means partition + host-side block packing.

    train_rows > 0 trains k-means on that many leading rows (cheaper at
    10M+ scale); assignment always covers the full corpus.  capacity
    defaults to the largest cluster (rounded up to a lane multiple).
    """
    n, d = corpus.shape
    train = corpus[:train_rows] if 0 < train_rows < n else corpus
    km = kmeans(
        key, train, n_clusters, metric,
        max_iterations=max_iterations, min_dist=0.0, init="kmeans++",
    )
    from crypto_rec_tpu.models.cluster.assign import lloyd_assign

    labels, _ = lloyd_assign(corpus, km.centroids, metric)

    # Device-side block packing (a host loop with fancy indexing pulled the
    # whole corpus through host memory and took minutes at 2M rows): one
    # argsort + scatter builds the slot table, one gather fills the blocks.
    counts_dev = jax.ops.segment_sum(
        jnp.ones_like(labels, jnp.int32), labels, num_segments=n_clusters
    )
    counts = np.asarray(counts_dev)
    if capacity <= 0:
        # cap at 4x the average: one pathological cluster must not inflate
        # every probe's read volume; overflow is counted, never silent
        avg = max(1, n // n_clusters)
        capacity = int(min(counts.max(), 4 * avg))
        capacity = -(-capacity // 8) * 8
    dropped = int(np.maximum(counts - capacity, 0).sum())

    row_ids, blocks = _pack_blocks(
        corpus, labels, n_clusters, capacity, block_dtype
    )
    return IvfIndex(
        metric=metric,
        n_clusters=n_clusters,
        capacity=capacity,
        n_rows=n,
        dropped_rows=dropped,
        centroids=km.centroids,
        blocks=blocks,
        block_rows=jnp.asarray(np.minimum(counts, capacity).astype(np.int32)),
        row_ids=jnp.asarray(row_ids),
    )


@functools.partial(
    jax.jit, static_argnames=("nprobe", "top_k", "q_block")
)
def ivf_retrieve_topk(
    index: IvfIndex,
    queries: jax.Array,
    nprobe: int,
    top_k: int,
    q_block: int = 256,
) -> Tuple[jax.Array, jax.Array]:
    """-> (scores [q, top_k] descending, row ids [q, top_k], -1 pad)."""
    q = queries.shape[0]
    pad_q = (-q) % q_block
    qp = jnp.pad(queries, ((0, pad_q), (0, 0)))

    def block_fn(q_blk):
        return _ivf_block(index, q_blk, nprobe, top_k)

    vals, ids = jax.lax.map(block_fn, qp.reshape(-1, q_block, queries.shape[1]))
    return vals.reshape(-1, top_k)[:q], ids.reshape(-1, top_k)[:q]


def _ivf_block(index: IvfIndex, queries: jax.Array, nprobe: int, top_k: int):
    metric = index.metric
    dc = pairwise_distances(queries, index.centroids, metric)  # [qb, K]
    _probe_d, probe_c = jax.lax.top_k(-dc, nprobe)             # [qb, nprobe]

    cand = index.blocks[probe_c]          # [qb, nprobe, cap, d]
    cand_ids = index.row_ids[probe_c]     # [qb, nprobe, cap]
    qb = queries.shape[0]
    cand = cand.reshape(qb, -1, queries.shape[1])
    cand_ids = cand_ids.reshape(qb, -1)

    if metric == "cosine":
        dots = jnp.einsum(
            "qd,qmd->qm", queries, cand, preferred_element_type=jnp.float32
        )
        qn = jnp.linalg.norm(queries, axis=1, keepdims=True)
        cn = jnp.linalg.norm(cand.astype(jnp.float32), axis=2)
        score = dots / jnp.maximum(qn * cn, 1e-30)
    else:
        diff = cand.astype(jnp.float32) - queries[:, None, :]
        score = -jnp.sqrt(jnp.maximum(jnp.sum(diff * diff, axis=2), 0.0))
    score = jnp.where(cand_ids >= 0, score, -jnp.inf)
    vals, pos = jax.lax.top_k(score, top_k)
    ids = jnp.take_along_axis(cand_ids, pos, axis=1)
    return vals, jnp.where(vals > -jnp.inf, ids, -1)
