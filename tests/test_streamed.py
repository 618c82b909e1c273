"""Shard-serialized serving (models/lsh/streamed.py): the host-built
chunk-streamed index must match resident-index retrieval semantics."""

import numpy as np
import jax
import jax.numpy as jnp

from crypto_rec_tpu.models.lsh.streamed import (
    build_streamed_index,
    streamed_retrieve_topk,
)
from crypto_rec_tpu.ops.oracle import exact_nearest, recall_at_k

RNG = np.random.default_rng(57)


def _clustered(n, d, n_centers=32):
    # cluster spread sized so same-cluster cosine margins (~0.03) dominate
    # the int8 slab quantization band (~0.005) — the bench corpus protocol
    # (io/synth.planted_clustered_corpus) has the same property
    centers = RNG.normal(size=(n_centers, d)).astype(np.float32) * 2
    return (
        centers[RNG.integers(0, n_centers, n)]
        + 0.5 * RNG.normal(size=(n, d))
    ).astype(np.float32)


def test_streamed_matches_oracle_recall():
    """Planted-truth protocol (the bench's): each query gets tk planted
    near-copies SCATTERED across all chunks, so recall exercises both the
    per-chunk retrieval and the cross-chunk merge."""
    n, d, q, tk = 8192, 128, 64, 10
    base = _clustered(n, d)
    queries = _clustered(q, d)
    stride = n // (q * tk)
    planted_pos = (np.arange(q * tk) * stride + RNG.integers(0, stride)
                   ) % n
    assert len(set(planted_pos.tolist())) == q * tk
    base[planted_pos] = (
        np.repeat(queries, tk, axis=0)
        + 0.05 * RNG.normal(size=(q * tk, d)).astype(np.float32)
    )
    true_idx = planted_pos.reshape(q, tk)

    sidx = build_streamed_index(
        jax.random.PRNGKey(5),
        chunk_source=lambda ci: base[ci * 2048:(ci + 1) * 2048],
        n_rows=n, dim=d, k=6, L=6, n_chunks=4,
    )
    assert sidx.n_chunks == 4
    stats = {}
    vals, ids = streamed_retrieve_topk(
        sidx, jnp.asarray(queries), top_k=tk, per_table=256, stats=stats,
    )
    vals, ids = np.asarray(vals), np.asarray(ids)
    assert ids.max() < n
    for row in ids:
        real = row[row >= 0]
        assert len(set(real.tolist())) == len(real)
    # scores descending
    assert (np.diff(np.where(ids >= 0, vals, -1e9), axis=1) <= 1e-6).all()
    r = float(recall_at_k(jnp.asarray(ids), jnp.asarray(true_idx)))
    assert r > 0.95, r
    # spot-check the oracle agrees with the planted construction
    _d, oidx = exact_nearest(
        jnp.asarray(queries), jnp.asarray(base), "cosine", tk)
    assert float(recall_at_k(oidx, jnp.asarray(true_idx))) > 0.99
    assert stats["chunks"] == 4 and stats["bytes_streamed"] > 0


def test_streamed_short_last_chunk_and_determinism():
    n, d, q, tk = 5000, 128, 16, 5
    base = _clustered(n, d)
    cr = -(-n // 3)

    def src(ci):
        return base[ci * cr:(ci + 1) * cr]

    sidx = build_streamed_index(
        jax.random.PRNGKey(9), src, n_rows=n, dim=d, k=5, L=4, n_chunks=3,
    )
    queries = jnp.asarray(base[:q])
    v1, i1 = streamed_retrieve_topk(sidx, queries, top_k=tk, per_table=128)
    v2, i2 = streamed_retrieve_topk(sidx, queries, top_k=tk, per_table=128)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    # self-query: the row itself must come back first with sim ~1
    assert (np.asarray(i1)[:, 0] == np.arange(q)).all()
    assert (np.abs(np.asarray(v1)[:, 0] - 1.0) < 0.02).all()
    # no id can point into the padded tail of the last chunk
    assert np.asarray(i1).max() < n
