"""Brute-force exact nearest-neighbor oracle + recall.

The reference ships exhaustive-search oracles that `main` never calls
(min_vector_euclidean_dist / min_vector_cosine_dist,
/root/reference/lib/utils.hpp:107-140).  Here they are first-class: the
batched exact-NN sweep is the ground truth for every recall@k measurement
(BASELINE.json north star: recall@10 >= 0.95 vs exact NN).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from crypto_rec_tpu.ops.distances import pairwise_distances


@functools.partial(jax.jit, static_argnames=("metric", "k", "block_rows"))
def exact_nearest(
    queries: jax.Array,
    index: jax.Array,
    metric: str,
    k: int,
    block_rows: int = 1024,
) -> Tuple[jax.Array, jax.Array]:
    """Exact k-NN: [q, d] vs [n, d] -> (dists [q, k], idx [q, k]) ascending.

    Streams query blocks so the [q, n] distance matrix never materializes.
    The distance matmul runs at HIGHEST precision: this is the ground
    truth every recall is measured against, so it must not run in TF32.
    """
    q = queries.shape[0]
    pad = (-q) % block_rows
    qp = jnp.pad(queries, ((0, pad), (0, 0)))
    blocks = qp.reshape(-1, block_rows, queries.shape[1])

    def one_block(blk):
        d = pairwise_distances(
            blk, index, metric, precision=jax.lax.Precision.HIGHEST)
        negd, idx = jax.lax.top_k(-d, k)
        return -negd, idx

    dists, idx = jax.lax.map(one_block, blocks)
    return (
        dists.reshape(-1, k)[:q],
        idx.reshape(-1, k)[:q],
    )


def exact_nearest_streamed(
    queries: jax.Array,
    index_host,          # numpy [n, d] on HOST — never fully device-resident
    metric: str,
    k: int,
    corpus_block: int = 1 << 20,
) -> Tuple[jax.Array, jax.Array]:
    """Exact k-NN streaming the CORPUS from host memory block by block.

    The oracle is a one-time verification, not the timed path — at 10M+
    rows a device-resident [n, d] f32 oracle corpus competes with the
    packed slabs for device memory.
    This form holds only one [corpus_block, d] slice on
    device at a time and maintains a running (dist, global idx) top-k.

    -> (dists [q, k] ascending, idx [q, k]), identical to exact_nearest.
    """
    import numpy as np

    q = queries.shape[0]
    best_d = jnp.full((q, k), jnp.inf, jnp.float32)
    best_i = jnp.full((q, k), -1, jnp.int32)

    @functools.partial(jax.jit, static_argnames=("k",))
    def merge(best_d, best_i, blk_d, blk_i, base, k):
        cand_d = jnp.concatenate([best_d, blk_d], axis=1)
        cand_i = jnp.concatenate([best_i, blk_i + base], axis=1)
        nd, pos = jax.lax.top_k(-cand_d, k)
        return -nd, jnp.take_along_axis(cand_i, pos, axis=1)

    n = index_host.shape[0]
    for s in range(0, n, corpus_block):
        blk = jnp.asarray(
            np.ascontiguousarray(index_host[s:s + corpus_block],
                                 dtype=np.float32)
        )
        # exact_nearest streams QUERY blocks, so the wide top_k runs on
        # [64, B] rows — the shape XLA's variadic sort handles well
        blk_d, blk_i = exact_nearest(
            queries, blk, metric, min(k, blk.shape[0]), block_rows=64)
        best_d, best_i = merge(
            best_d, best_i, blk_d, blk_i, jnp.int32(s), k)
        best_d.block_until_ready()
        del blk, blk_d, blk_i
    return best_d, best_i


def recall_at_k(retrieved_idx: jax.Array, true_idx: jax.Array) -> jax.Array:
    """Mean fraction of true_idx [q, k] found in retrieved_idx [q, m].

    Negative entries in retrieved_idx are padding and never match.
    """
    matches = retrieved_idx[:, None, :] == true_idx[:, :, None]
    hit = jnp.any(matches & (retrieved_idx[:, None, :] >= 0), axis=-1)
    return jnp.mean(hit.astype(jnp.float32))
