"""Shard-serialized serving: indexes LARGER than device memory on one card.

docs/SCALE.md does the 1B-row arithmetic; this module is the executable
mechanism for the single-card end of that story: the corpus is partitioned
into R contiguous row-range chunks, each chunk carries its OWN CSR bucket
tables + packed int8 slabs built entirely HOST-side (numpy — no device
memory during the build), and a query batch is served by streaming one
chunk's slabs host->device at a time, running the windowed slab dots per
chunk, and merging the per-chunk top-k on device.  Identical retrieval
semantics to a `pack_sharded_index` mp=R mesh, time-multiplexed over one
card.

Transfer/compute overlap: chunk i+1's host->device copy is dispatched
(async `jax.device_put`) BEFORE chunk i's kernel result is consumed, so
the PCIe copy rides under the chunk's compute.  The per-chunk shapes are
identical, so the kernel and the merge compile exactly once.

Reference analog: none — the reference is a single-process in-memory
C++ program (/root/reference/main.cpp:36); this is this build's own
scale axis (BASELINE.json config 5).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp


@dataclasses.dataclass
class StreamedLshIndex:
    """Host-resident chunked index (cosine, global-scale int8 slabs)."""

    metric: str
    k: int
    L: int
    n_rows: int
    n_buckets: int
    chunk_rows: int              # rows per chunk (last chunk padded)
    chunk_pad: int               # slab rows per chunk (aligned)
    gscale: float                # one global dequant scalar
    proj: np.ndarray             # [d, L*k] hash family (host copy)
    slabs: List[np.ndarray]      # per chunk: [L, chunk_pad, d] int8
    rows: List[np.ndarray]       # per chunk: [L, chunk_pad] int32 local ids
    starts: List[np.ndarray]     # per chunk: [L, n_buckets + 1] int32

    @property
    def n_chunks(self) -> int:
        return len(self.slabs)

    def host_bytes(self) -> int:
        return sum(
            s.nbytes + r.nbytes + st.nbytes
            for s, r, st in zip(self.slabs, self.rows, self.starts)
        )


def _host_bucket_ids(x: np.ndarray, proj: np.ndarray, k: int, L: int
                     ) -> np.ndarray:
    """Cosine bucket ids on the HOST: sign bits packed MSB-first per table
    (the numpy mirror of hyperplane.CosineLsh.bucket_ids)."""
    bits = (x.astype(np.float32) @ proj >= 0.0).astype(np.int64)
    bits = bits.reshape(x.shape[0], L, k)
    weights = (1 << np.arange(k - 1, -1, -1, dtype=np.int64))
    return (bits * weights).sum(-1).astype(np.int32)


def build_streamed_index(
    key: jax.Array,
    chunk_source: Callable[[int], np.ndarray],
    n_rows: int,
    dim: int,
    k: int,
    L: int,
    n_chunks: int,
    align: int = 512,
    pad: int = 1024,
) -> StreamedLshIndex:
    """Build the chunked index entirely host-side.

    chunk_source(ci) must return the f32 rows of chunk ci
    ([chunk_rows, dim]; the LAST chunk may be shorter — it is zero-padded
    here and the pad rows are excluded from every bucket).  Nothing
    touches the device: hashing is a numpy matmul, CSR is argsort +
    bincount, slabs are normalized global-scale int8 (scale 1/127 — a
    normalized row's components are <= 1, so the fixed scale is exact
    enough and saves a second generation pass)."""
    from crypto_rec_tpu.models.lsh.hyperplane import CosineLsh

    fam = CosineLsh.create(key, dim, k, L)
    proj = np.asarray(jax.device_get(fam.proj))
    chunk_rows = -(-n_rows // n_chunks)
    # pad past the window reach (packed_retrieve_core requires pad >=
    # per_table + 2 blocks), aligned to the block grid — same rule as
    # pack_index
    chunk_pad = chunk_rows + (-(chunk_rows + pad) % align + pad)
    n_buckets = 1 << k
    gscale = 1.0 / 127.0

    slabs, rows_l, starts_l = [], [], []
    for ci in range(n_chunks):
        x = np.asarray(chunk_source(ci), dtype=np.float32)
        nc = x.shape[0]
        if nc < chunk_rows and ci != n_chunks - 1:
            raise ValueError("only the last chunk may be short")
        b = _host_bucket_ids(x, proj, k, L)              # [nc, L]
        norms = np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-30)
        xq = np.clip(np.round((x / norms) / gscale), -127, 127).astype(np.int8)
        slab = np.zeros((L, chunk_pad, dim), np.int8)
        rows = np.full((L, chunk_pad), chunk_rows, np.int32)  # sentinel
        starts = np.zeros((L, n_buckets + 1), np.int32)
        for l in range(L):
            order = np.argsort(b[:, l], kind="stable").astype(np.int32)
            slab[l, :nc] = xq[order]
            rows[l, :nc] = order
            counts = np.bincount(b[:, l], minlength=n_buckets)
            starts[l, 1:] = np.cumsum(counts).astype(np.int32)
        slabs.append(slab)
        rows_l.append(rows)
        starts_l.append(starts)
        del x, xq, b
    return StreamedLshIndex(
        metric="cosine", k=k, L=L, n_rows=n_rows, n_buckets=n_buckets,
        chunk_rows=chunk_rows, chunk_pad=chunk_pad, gscale=gscale,
        proj=proj, slabs=slabs, rows=rows_l, starts=starts_l,
    )


def streamed_retrieve_topk(
    index: StreamedLshIndex,
    queries: jax.Array,       # [q, d] (device)
    top_k: int,
    per_table: int = 256,
    stage1_width: int = 0,
    stats: Optional[dict] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Serve one query batch against the streamed index.

    -> (scores [q, top_k] descending cosine sims, GLOBAL row ids, -1 pad).

    Per chunk: async-upload the slabs, run the per-chunk fused retrieval
    (the exact packed_retrieve_pallas/XLA path a resident index uses),
    shift local ids by the chunk's row offset, and fold into the running
    top-k with one jitted merge.  Upload of chunk i+1 is dispatched before
    chunk i's compute is consumed, so transfer and compute overlap.
    `stats` (optional dict) receives transfer/compute accounting."""
    import time

    from crypto_rec_tpu.models.lsh.hyperplane import CosineLsh
    from crypto_rec_tpu.ops.pallas.slabscore import packed_retrieve_pallas

    q = queries.shape[0]
    L, k = index.L, index.k
    fam = CosineLsh(
        proj=jnp.asarray(index.proj), k=k, L=L
    )
    q_buckets = fam.bucket_ids(queries)

    @jax.jit
    def chunk_retrieve(slab, rows, starts, qs, qb):
        return packed_retrieve_pallas(
            slab, rows, None, starts, index.chunk_rows, qs, qb,
            top_k, per_table, stage1_width=stage1_width,
        )

    @jax.jit
    def merge(bv, bi, v, ids, offset):
        gids = jnp.where(ids >= 0, ids + offset, -1)
        cat_v = jnp.concatenate([bv, v], axis=1)
        cat_i = jnp.concatenate([bi, gids], axis=1)
        nv, pos = jax.lax.top_k(cat_v, top_k)
        return nv, jnp.take_along_axis(cat_i, pos, axis=1)

    def upload(ci):
        return (
            jax.device_put(index.slabs[ci]),
            jax.device_put(index.rows[ci]),
            jax.device_put(index.starts[ci]),
        )

    best_v = jnp.full((q, top_k), -jnp.inf, jnp.float32)
    best_i = jnp.full((q, top_k), -1, jnp.int32)
    t0 = time.perf_counter()
    dev = upload(0)
    for ci in range(index.n_chunks):
        nxt = upload(ci + 1) if ci + 1 < index.n_chunks else None
        v, ids = chunk_retrieve(*dev, queries, q_buckets)
        best_v, best_i = merge(
            best_v, best_i, v, ids, jnp.int32(ci * index.chunk_rows)
        )
        # Bound the transfer pipeline: device_put is async, so without a
        # per-chunk sync this loop dispatches EVERY chunk's upload before
        # the first kernel finishes — host staging buffers for the whole
        # index at once (measured: 130 GB RSS -> OOM-kill at 100M rows).
        # Blocking on the merge keeps at most two chunks (current +
        # prefetched) in flight; chunk ci+1's copy still rides under
        # chunk ci's compute because its device_put was dispatched above.
        best_v.block_until_ready()
        dev = nxt
    wall = time.perf_counter() - t0
    if stats is not None:
        bytes_streamed = index.host_bytes()
        stats.update(
            wall_s=round(wall, 3),
            chunks=index.n_chunks,
            bytes_streamed=bytes_streamed,
            stream_gb_per_s=round(bytes_streamed / wall / 1e9, 3),
            qps=round(q / wall, 1),
        )
    return best_v * index.gscale, best_i
