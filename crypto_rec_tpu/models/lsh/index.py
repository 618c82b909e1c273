"""LSH index structures: bucket tables, candidate retrieval, multi-table union.

The reference stores each table as pointer buckets (CustHashtable ->
VectorBucket -> CustVector*, /root/reference/lib/data_structures/
cust_hashtable.hpp, vector_bucket.hpp) and unions the query's bucket across
L tables through a std::set of pointers (lsh_cube.hpp:77-106).

Two query paths over the same index arrays:

1. **Dense mask path** (exact reference semantics, ideal for n up to ~10^5):
   candidate[q, i] = OR over tables of (bucket_id match AND, for euclidean,
   full k-tuple "detailed hash" match).  The set-union is the OR; dedup is
   free.  Everything is a broadcasted integer compare.

2. **CSR fixed-budget path** (for 10^6..10^9 rows, and the unit the sharded
   engine routes over): per table, rows sorted by bucket id + offset table
   (built with one sort per table); a query gathers a fixed-size window per
   table, dedups by sort, and pads to `budget` with -1.  Static shapes
   throughout — the price is truncation, which the recall oracle measures.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from crypto_rec_tpu.models.lsh.hyperplane import CosineLsh
from crypto_rec_tpu.models.lsh.pstable import PStableLsh


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=(
        "family", "bucket_ids", "detailed", "sorted_rows", "bucket_starts",
        "packed", "packed_rows", "packed_sqnorm", "packed_detailed",
        "packed_scale", "packed_gscale", "packed_aug_scale",
    ),
    meta_fields=("metric", "n_buckets", "n_rows"),
)
@dataclasses.dataclass
class LshIndex:
    """L hash tables over one set of indexed rows.

    bucket_ids:    [n, L] int32 — bucket of row i in table l.
    detailed:      [L, n] int32 h-tuple FINGERPRINTS (euclidean only, else
                   None).  One murmur-mixed int32 per (table, row) stands in
                   for the reference's k-tuple of h-values
                   (euclidean_phi_gen.hpp:83-94): fingerprint equality ==
                   tuple equality up to a ~2^-32 collision that can only
                   admit an extra candidate, never drop a true match (see
                   pstable.fingerprints_from_hashes).
    sorted_rows:   [L, n] int32 — row ids sorted by bucket id per table (CSR).
    bucket_starts: [L, n_buckets + 1] int32 — CSR offsets per table.

    Optional packed-slab layout (see pack_index): per-table copies of the
    corpus in CSR order so a query's bucket window is ONE contiguous slab —
    a streaming read instead of a random row gather per candidate.

    packed:          [L, n + pad, d] — CSR-ordered corpus per table
                     (cosine: rows L2-normalized; usually bfloat16).
    packed_rows:     [L, n + pad] int32 — sorted_rows padded with sentinel n.
    packed_sqnorm:   [L, n + pad] float32 |row|^2 (euclidean only).
    packed_detailed: [L, n + pad] int32 CSR-ordered fingerprints (euclidean).
    """

    metric: str
    n_buckets: int
    n_rows: int
    family: object  # CosineLsh | PStableLsh
    bucket_ids: jax.Array
    detailed: Optional[jax.Array]
    sorted_rows: jax.Array
    bucket_starts: jax.Array
    packed: Optional[jax.Array] = None
    packed_rows: Optional[jax.Array] = None
    packed_sqnorm: Optional[jax.Array] = None
    packed_detailed: Optional[jax.Array] = None
    # int8-quantized slabs only: per-row dequant scale [L, n + pad] f32
    # (row ≈ packed * scale; halves the query-time gather bytes vs bf16)
    packed_scale: Optional[jax.Array] = None
    # GLOBAL-scale int8 slabs only (scale_mode="global"): the one scalar
    # dequant scale.  Raw kernel dots × this scale ≈ true cosine sims,
    # which lets retrieval paths skip the exact rerank when the caller
    # opts out (retrieve_topk(int8_rerank=False) saves the rerank's
    # random-row gather; quantization noise can permute near-ties, so
    # reranking stays the default).
    packed_gscale: Optional[jax.Array] = None
    # Euclidean AUGMENTED slabs only (pack_index augment=True): rows are
    # stored as [x, -|x|^2/2, 0-pad] so the windowed slab dot IS the
    # monotone rank x.q - |x|^2/2 (dist^2 = |q|^2 - 2*rank) — euclidean
    # retrieval rides the same windowed dots as cosine.  The scalar is
    # the norm-column scale s: queries augment to [q, s, 0-pad] (int8
    # stores the norm column as -|x|^2/(2*g*s), see pack_index).
    packed_aug_scale: Optional[jax.Array] = None


def _csr_from_buckets(
    bucket_ids: jax.Array,
    n_buckets: int,
    secondary: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array]:
    """[n, L] -> (sorted_rows [L, n], starts [L, n_buckets + 1]).

    The per-table sort replaces pointer-bucket insertion
    (cust_hashtable.hpp:65-70): one `sort` + one `searchsorted` per table.
    lax.sort on the (bucket, row) pair with num_keys=1 returns the sorted
    keys AND the permutation in one pass, with no argsort + gather.

    `secondary` ([n, L] int32, euclidean fingerprints) adds a lexicographic
    second sort key: rows sharing a bucket are ordered by fingerprint, so
    every exact-tuple cell is a CONTIGUOUS run inside its bucket.  Query
    paths then binary-search the query's fingerprint (signed int32 order,
    matching this sort) and start their window at the run — each window
    slot is a true tuple match until the run ends, instead of a random
    sample of the bucket that the detailed filter mostly discards
    (measured at 2M clustered rows: recall 0.57 -> see bench).
    """
    n, L = bucket_ids.shape
    iota = jnp.arange(n, dtype=jnp.int32)

    def one_table(b, fp):  # b: [n], fp: [n] or dummy
        if secondary is None:
            sorted_b, order = jax.lax.sort((b, iota), num_keys=1)
        else:
            sorted_b, _, order = jax.lax.sort((b, fp, iota), num_keys=2)
        starts = jnp.searchsorted(
            sorted_b, jnp.arange(n_buckets + 1, dtype=b.dtype), side="left"
        ).astype(jnp.int32)
        return order, starts

    sec = (secondary if secondary is not None else bucket_ids).T
    rows, starts = jax.vmap(one_table)(bucket_ids.T, sec)
    return rows, starts


def _fp_run_starts(
    fp_at,                     # callable: positions [...] -> fingerprints [...]
    start: jax.Array,          # lower CSR bounds (bucket starts)
    end: jax.Array,            # upper CSR bounds (bucket ends)
    target: jax.Array,         # query fingerprints, same shape
    n: int,
) -> jax.Array:
    """First CSR position of `target` within the fingerprint-sorted bucket
    slice [start, end) — a fixed-depth branchless binary search (signed
    int32 order, matching _csr_from_buckets' secondary sort).  Returns
    `end` when the cell is absent (the window then holds no matching rows
    and the filter masks everything, exactly like an empty reference
    bucket fetch)."""
    lo, hi = start, end
    for _ in range(max(1, math.ceil(math.log2(max(2, n))))):
        active = lo < hi
        mid = (lo + hi) // 2
        go_right = fp_at(jnp.clip(mid, 0, n - 1)) < target
        lo = jnp.where(active & go_right, mid + 1, lo)
        hi = jnp.where(active & ~go_right, mid, hi)
    return lo


@functools.partial(
    jax.jit,
    static_argnames=(
        "metric", "k", "L", "lsh_bucket_div", "euclidean_h_w"
    ),
)
def build_index(
    key: jax.Array,
    vectors: jax.Array,
    metric: str,
    k: int,
    L: int,
    lsh_bucket_div: int,
    euclidean_h_w: float,
) -> LshIndex:
    """create_LSH_hashtables, batched (lsh_cube.hpp:44-74).

    Table sizing parity: euclidean tables have n / lsh_bucket_div buckets,
    cosine tables 2^k (lsh_cube.hpp:61-66).

    Hashing streams row chunks through lax.map so the [n, L*k] projection
    temporary never materializes (4+ GiB at 10M rows) — only the packed
    int32 outputs persist.  The whole build is one jitted program.
    """
    n = vectors.shape[0]
    d = vectors.shape[1]
    chunk = 1 << 18

    def chunked(fn, out_cols_shape):
        pad = (-n) % chunk
        xp = jnp.pad(vectors, ((0, pad), (0, 0)))
        out = jax.lax.map(fn, xp.reshape(-1, chunk, d))
        return out.reshape((xp.shape[0],) + out_cols_shape)[:n]

    if metric == "cosine":
        fam = CosineLsh.create(key, d, k, L)
        n_buckets = fam.n_buckets
        bucket_ids = chunked(fam.bucket_ids, (L,))
        detailed = None
    elif metric == "euclidean":
        fam = PStableLsh.create(key, d, k, L, euclidean_h_w)
        n_buckets = max(1, n // max(1, lsh_bucket_div))

        def hash_chunk(xc):
            h = fam.hash_values(xc)  # [chunk, L, k] — never materialized at n
            return jnp.stack(
                [
                    fam.bucket_ids_from_hashes(h, n_buckets),
                    fam.fingerprints_from_hashes(h),
                ],
                axis=1,
            )

        both = chunked(hash_chunk, (2, L))
        bucket_ids = both[:, 0, :]
        detailed = both[:, 1, :].T  # [L, n] fingerprint plane
    else:
        raise ValueError(f"unknown metric {metric!r}")

    # euclidean: order rows by (bucket, fingerprint) so each exact-tuple
    # cell is a contiguous run the query paths can jump to (_fp_run_starts)
    sorted_rows, starts = _csr_from_buckets(
        bucket_ids, n_buckets,
        secondary=None if detailed is None else detailed.T,
    )
    return LshIndex(
        metric=metric,
        n_buckets=n_buckets,
        n_rows=n,
        family=fam,
        bucket_ids=bucket_ids,
        detailed=detailed,
        sorted_rows=sorted_rows,
        bucket_starts=starts,
    )


@functools.partial(
    jax.jit, static_argnames=("dtype", "pad", "scale_mode", "augment")
)
def pack_index(
    index: LshIndex,
    corpus: jax.Array,
    dtype=jnp.bfloat16,
    pad: int = 4096,
    scale_mode: str = "auto",
    augment: bool = False,
) -> LshIndex:
    """Attach the packed-slab layout: per-table CSR-ordered corpus copies.

    The fused retrieve path's cost is the candidate gather — L*window random
    rows per query.  Packing rewrites each table's members CONTIGUOUSLY in
    bucket order (the IVF trick, models/ivf.py, applied per LSH table), so a
    query reads ONE contiguous [window, d] slab run per table.

    Cost: L extra corpus copies ([L, n + pad, d] in `dtype` — bf16 halves
    it) and a one-time build gather.  At n rows, d dims that is
    L*(n+pad)*d*itemsize bytes; callers gate on HBM.  Cosine rows are
    pre-normalized (query-side normalization happens in retrieve), so bf16
    rounding is the only scoring difference vs the unpacked path.

    `pad` trailing sentinel rows let any window start up to n without
    clamping; retrieve asserts per_table <= pad.

    dtype=jnp.int8 stores symmetric quantized slabs.  scale_mode picks the
    quantization granularity:

    * "global" (auto default for cosine): ONE scalar scale for the whole
      index — rows are pre-normalized, so a shared scale makes the raw
      int8 dot products ORDER-PRESERVING and no `packed_scale` plane or
      dequant epilogue is needed anywhere on the hot path (the exact f32
      rerank of the over-fetched survivors restores true scores).  The
      per-element rounding is bounded by the corpus-max amax instead of
      each row's own (<= 2x coarser for unit rows), which the 4x
      over-fetch + rerank absorbs.
    * "row" (auto default for euclidean, whose -(sq - 2·dot + |q|²) score
      mixes dots with true norms): per-row scales in `packed_scale`
      (row ≈ packed * scale), applied by the retrieval epilogue.

    augment=True (euclidean only): store each row as [x, -|x|²/2, 0-pad]
    in ceil((d+1)/128)*128 columns, so the windowed slab dots' plain dot
    against the augmented query [q, s, 0-pad] IS the monotone rank
    x·q - |x|²/2 (dist² = |q|² - 2·rank) — euclidean retrieval then rides
    the same windowed dots as cosine (retrieve_topk routes augmented
    indexes through slab_window_dots; the blocked XLA core cannot score
    them).
    int8 augmented: x columns share the global scale g, the norm column
    its own scale s = max(|x|²/2)/(127·g) stored in packed_aug_scale, and
    rank = kernel_dot · g stays order-preserving.
    """
    L, n = index.sorted_rows.shape
    d = corpus.shape[1]
    quantized = jnp.issubdtype(jnp.dtype(dtype), jnp.integer)
    if augment and index.metric != "euclidean":
        raise ValueError("augment=True is the euclidean rank layout")
    if scale_mode == "auto":
        if augment:
            scale_mode = "global" if quantized else "none"
        else:
            scale_mode = "global" if index.metric == "cosine" else "row"
    if scale_mode not in ("global", "row", "none"):
        raise ValueError(f"unknown scale_mode {scale_mode!r}")
    if augment and scale_mode == "row":
        raise ValueError("augmented slabs use one global scale, not per-row")
    d_aug = -(-(d + 1) // 128) * 128 if augment else d
    aug_scale = None
    if augment:
        norm_half_max = jnp.max(jnp.sum(corpus * corpus, axis=1)) / 2.0
    g_scale = None
    if quantized and scale_mode == "global":
        # amax over NORMALIZED rows without materializing them: per-row
        # max|.| / ||.|| (cosine packs normalized rows)
        if index.metric == "cosine":
            amax = jnp.max(
                jnp.max(jnp.abs(corpus), axis=1)
                / jnp.maximum(jnp.linalg.norm(corpus, axis=1), 1e-30)
            )
        else:
            amax = jnp.max(jnp.abs(corpus))
        g_scale = jnp.maximum(amax, 1e-30) / 127.0
    if augment:
        if quantized:
            aug_scale = jnp.maximum(norm_half_max, 1e-30) / (127.0 * g_scale)
        else:
            aug_scale = jnp.float32(1.0)

    def one_chunk(rows):
        g = corpus[rows].astype(jnp.float32)
        if index.metric == "cosine":
            g = g / jnp.maximum(
                jnp.linalg.norm(g, axis=1, keepdims=True), 1e-30
            )
            sq = jnp.zeros((rows.shape[0],), jnp.float32)
        else:
            sq = jnp.sum(g * g, axis=1)
        if augment:
            # [x, -|x|^2/2, 0-pad]: the kernel's dot against [q, s, 0-pad]
            # is the rank x.q - |x|^2/2 (int8: x cols scaled by g, norm
            # col by g*s, so dot*g recovers the rank)
            norm_col = (-sq / 2.0)[:, None]
            if quantized:
                gq = jnp.clip(jnp.round(g / g_scale), -127, 127)
                nq = jnp.clip(
                    jnp.round(norm_col / (g_scale * aug_scale)), -127, 0
                )
                row = jnp.concatenate([gq, nq], axis=1)
            else:
                row = jnp.concatenate([g, norm_col], axis=1)
            row = jnp.pad(row, ((0, 0), (0, d_aug - d - 1)))
            return (row.astype(dtype), sq,
                    jnp.ones((rows.shape[0],), jnp.float32))
        if quantized and scale_mode == "global":
            qg = jnp.clip(jnp.round(g / g_scale), -127, 127).astype(dtype)
            return qg, sq, jnp.ones((rows.shape[0],), jnp.float32)
        if quantized:
            amax = jnp.max(jnp.abs(g), axis=1, keepdims=True)
            scale = jnp.maximum(amax, 1e-30) / 127.0
            qg = jnp.clip(jnp.round(g / scale), -127, 127).astype(dtype)
            return qg, sq, scale[:, 0]
        return g.astype(dtype), sq, jnp.ones((rows.shape[0],), jnp.float32)

    # sequential over tables AND row chunks: bounds the f32 gather
    # intermediate to one [chunk, d] (a whole [n, d] f32 temp at 10M rows
    # is 5.1 GB per copy); clamped to the (512-aligned) table length so a
    # small corpus doesn't pad up to a 1M-row chunk and gather dead rows
    chunk = min(1 << 20, -(-n // 512) * 512)

    # round the padded length to a 512 multiple: the packed retrieve path
    # gathers W-row ALIGNED blocks (W in {128, 256, 512} dividing n + pad)
    pad = -(n + pad) % 512 + pad

    def one_table(rows):
        cpad = (-rows.shape[0]) % chunk
        rp = jnp.pad(rows, (0, cpad))
        qg, sq, sc = jax.lax.map(one_chunk, rp.reshape(-1, chunk))
        m = rows.shape[0]
        # sentinel-pad INSIDE the per-table map: padding the stacked
        # [L, n, d] output afterwards would materialize a second full
        # copy of the slabs (2 x 8 GB at 2M x 16-table augmented = OOM)
        return (
            jnp.pad(qg.reshape(-1, d_aug)[:m], ((0, pad), (0, 0))),
            jnp.pad(sq.reshape(-1)[:m], (0, pad)),
            jnp.pad(sc.reshape(-1)[:m], (0, pad), constant_values=1.0),
        )

    packed, sq, scale = jax.lax.map(one_table, index.sorted_rows)
    packed_rows = jnp.pad(
        index.sorted_rows, ((0, 0), (0, pad)), constant_values=n
    )
    kw: dict = {"packed": packed, "packed_rows": packed_rows}
    if quantized and scale_mode == "global":
        kw["packed_gscale"] = jnp.asarray(g_scale, jnp.float32)
    if augment:
        kw["packed_aug_scale"] = jnp.asarray(aug_scale, jnp.float32)
    if quantized and scale_mode == "row":
        kw["packed_scale"] = scale        # padded inside one_table
    if index.metric == "euclidean" and not augment:
        kw["packed_sqnorm"] = sq          # padded inside one_table
    if index.metric == "euclidean":
        if index.detailed is not None:
            # [L, n] fingerprints reordered per table into CSR order
            pd = jnp.take_along_axis(index.detailed, index.sorted_rows, axis=1)
            kw["packed_detailed"] = jnp.pad(pd, ((0, 0), (0, pad)))
    return dataclasses.replace(index, **kw)


def pack_index_host(
    index: LshIndex,
    corpus_host,                  # numpy [n, d] f32 on HOST
    dtype=jnp.int8,
    pad: int = 4096,
    augment: bool = False,
) -> LshIndex:
    """pack_index computed on the HOST, slabs uploaded table by table.

    When the device cannot hold the f32 corpus AND the slab copies during
    a device-side pack, the gather /
    normalize / quantize runs in numpy against a host corpus, the device
    corpus can be freed BEFORE packing, and device peak memory is just the
    finished slabs.  Global-scale layouts only (cosine, or euclidean
    augmented) — identical math to pack_index's scale_mode="global"/"none",
    so the retrieval paths cannot tell the layouts apart.
    """
    import numpy as np

    L, n = index.sorted_rows.shape
    d = corpus_host.shape[1]
    quantized = jnp.issubdtype(jnp.dtype(dtype), jnp.integer)
    if augment and index.metric != "euclidean":
        raise ValueError("augment=True is the euclidean rank layout")
    if not augment and index.metric != "cosine":
        raise ValueError(
            "pack_index_host covers global-scale layouts: cosine, or "
            "euclidean with augment=True"
        )
    d_aug = -(-(d + 1) // 128) * 128 if augment else d
    pad = -(n + pad) % 512 + pad
    n_pad = n + pad

    x = np.asarray(corpus_host, dtype=np.float32)
    g_scale = aug_scale = None
    if augment:
        sq_all = np.einsum("nd,nd->n", x, x)
        norm_half_max = float(sq_all.max()) / 2.0
        if quantized:
            g_scale = max(float(np.abs(x).max()), 1e-30) / 127.0
            aug_scale = max(norm_half_max, 1e-30) / (127.0 * g_scale)
        else:
            aug_scale = 1.0
    elif quantized:
        norms = np.maximum(np.linalg.norm(x, axis=1), 1e-30)
        amax = float((np.abs(x).max(axis=1) / norms).max())
        g_scale = max(amax, 1e-30) / 127.0

    # Normalize the dtype (np.int8 / jnp.int8 / "int8" are all the same
    # dtype) and pick the host staging dtype explicitly — a silent bf16
    # fallback would be lossy for any wider future dtype.
    dt = jnp.dtype(dtype)
    if dt == jnp.dtype(jnp.int8):
        np_dtype = np.int8
    elif dt == jnp.dtype(jnp.float32):
        np_dtype = np.float32
    elif dt == jnp.dtype(jnp.bfloat16):
        import ml_dtypes

        np_dtype = ml_dtypes.bfloat16
    else:
        raise ValueError(
            f"pack_index_host supports int8 | bfloat16 | float32 slabs, "
            f"got {dt.name}"
        )
    rows_host = np.asarray(jax.device_get(index.sorted_rows))
    # upload table by table into a preallocated DONATED device buffer:
    # one 10+ GB host->device transfer needs a contiguous device block
    # that a freshly-used allocator may not have, while L transfers of
    # slab/L bytes + in-place
    # dynamic_update_slice peak at slabs + one table of staging
    upd = jax.jit(
        lambda buf, t, l: jax.lax.dynamic_update_slice(
            buf, t[None].astype(buf.dtype), (l, 0, 0)),
        donate_argnums=0,
    )
    packed = jnp.zeros((L, n_pad, d_aug), dtype)
    for l in range(L):
        g = x[rows_host[l]]                       # [n, d] f32
        if index.metric == "cosine":
            g = g / np.maximum(
                np.linalg.norm(g, axis=1, keepdims=True), 1e-30)
        tbl = np.zeros((n_pad, d_aug), np_dtype)
        if augment:
            sq = sq_all[rows_host[l]]
            if quantized:
                tbl[:n, :d] = np.clip(np.round(g / g_scale), -127, 127)
                tbl[:n, d] = np.clip(
                    np.round((-sq / 2.0) / (g_scale * aug_scale)), -127, 0)
            else:
                tbl[:n, :d] = g
                tbl[:n, d] = (-sq / 2.0).astype(np_dtype)
        else:
            if quantized:
                tbl[:n] = np.clip(np.round(g / g_scale), -127, 127)
            else:
                tbl[:n] = g
        packed = upd(packed, jnp.asarray(tbl), jnp.int32(l))
        packed.block_until_ready()
        del g, tbl
    packed_rows = jnp.asarray(np.pad(
        rows_host, ((0, 0), (0, pad)), constant_values=n).astype(np.int32))
    kw: dict = {"packed": packed, "packed_rows": packed_rows}
    if quantized:
        kw["packed_gscale"] = jnp.asarray(g_scale, jnp.float32)
    if augment:
        kw["packed_aug_scale"] = jnp.asarray(aug_scale, jnp.float32)
        if index.detailed is not None:
            det_host = np.asarray(jax.device_get(index.detailed))
            pd = np.take_along_axis(det_host, rows_host, axis=1)
            kw["packed_detailed"] = jnp.asarray(np.pad(
                pd, ((0, 0), (0, pad))).astype(np.int32))
    return dataclasses.replace(index, **kw)


def query_hashes(index: LshIndex, queries: jax.Array) -> Tuple[jax.Array, Optional[jax.Array]]:
    """Hash queries with the index's family ->
    (bucket_ids [q, L], detailed fingerprints [q, L] or None)."""
    if index.metric == "cosine":
        return index.family.bucket_ids(queries), None
    qh = index.family.hash_values(queries)
    return (
        index.family.bucket_ids_from_hashes(qh, index.n_buckets),
        index.family.fingerprints_from_hashes(qh),
    )


def candidate_mask(
    index: LshIndex,
    queries: jax.Array,
    filtered: bool = True,
) -> jax.Array:
    """Dense [q, n] candidate mask == get_LSH_[filtered_]combined_buckets
    (lsh_cube.hpp:77-106).

    For cosine tables the bucket id IS the k-bit tuple, so the filtered and
    unfiltered paths coincide (getFilteredBucketFor falls back to the plain
    bucket when the generator has no detailed hashes,
    cust_hashtable.hpp:73-103).
    """
    q_buckets, q_detailed = query_hashes(index, queries)
    same_bucket = q_buckets[:, None, :] == index.bucket_ids[None, :, :]  # [q, n, L]
    if filtered and index.detailed is not None:
        # fingerprint equality == k-tuple equality (see LshIndex.detailed)
        same_tuple = q_detailed[:, None, :] == index.detailed.T[None, :, :]
        same_bucket = same_bucket & same_tuple
    return jnp.any(same_bucket, axis=-1)


def _dedup_fixed(ids: jax.Array, sentinel: int, budget: int) -> jax.Array:
    """Sort-unique within a fixed-size id list; pad with -1.

    The std::set union across tables (lsh_cube.hpp:80-89) as two small sorts:
    sort, mark duplicates as sentinel, sort again, truncate.
    """
    s = jnp.sort(ids)
    dup = jnp.concatenate([jnp.zeros((1,), bool), s[1:] == s[:-1]])
    s = jnp.where(dup, sentinel, s)
    s = jnp.sort(s)[:budget]
    return jnp.where(s == sentinel, -1, s)


def _dedup_rank_fixed(
    ids: jax.Array, sentinel: int, budget: int, n_tables: int,
    with_count: bool = False,
):
    """Dedup + rank by multi-table collision count, truncate to budget.

    When the union across tables exceeds the budget, keep the rows that
    collided with the query in the MOST tables first — collision
    multiplicity is a monotone proxy for similarity (the core multi-probe
    LSH ranking trick), so budget truncation discards the least-promising
    candidates instead of an arbitrary id-ordered suffix.
    """
    m = ids.shape[0]
    s = jnp.sort(ids)
    iota = jnp.arange(m, dtype=jnp.int32)
    first = jnp.concatenate([jnp.ones((1,), bool), s[1:] != s[:-1]])
    last = jnp.concatenate([s[:-1] != s[1:], jnp.ones((1,), bool)])
    # occurrences of each value by run length in the sorted array: the
    # run's span comes from two cumulative scans (start = running max of
    # first-positions, end = right-to-left running min of last-positions) —
    # no scatter (segment_sum) and no per-element binary search
    # (searchsorted)
    run_start = jax.lax.cummax(jnp.where(first, iota, 0))
    run_end = jax.lax.cummin(
        jnp.where(last, iota, m - 1), reverse=True
    )
    cnt = run_end - run_start + 1
    valid_first = first & (s != sentinel)
    # composite key: count desc, then row id asc.  Position in the
    # id-sorted array IS the id-ascending tiebreak, so ONE int32 key
    # ((n_tables - cnt) << 16 | position) carries the whole order AND the
    # payload gather — a single int32 sort instead of an f32 argsort +
    # gather.  Needs m < 2^16; wider unions keep the f32 form.
    if m < (1 << 16):
        big = jnp.int32(2**30)
        key = jnp.where(valid_first, ((n_tables - cnt) << 16) | iota, big)
        ksel = jnp.sort(key)[:budget]
        out = jnp.where(ksel < big, s[ksel & 0xFFFF], -1)
    else:
        keyf = jnp.where(
            valid_first,
            (n_tables - cnt).astype(jnp.float32)
            + s.astype(jnp.float32) / jnp.float32(sentinel + 1),
            jnp.inf,
        )
        order = jnp.argsort(keyf)[:budget]
        out = jnp.where(jnp.isfinite(keyf[order]), s[order], -1)
    if with_count:
        return out, jnp.sum(valid_first.astype(jnp.int32))
    return out


@functools.partial(
    jax.jit, static_argnames=("budget", "per_table")
)
def candidate_ids_scored(
    index: LshIndex,
    queries: jax.Array,
    budget: int,
    per_table: int = 256,
) -> jax.Array:
    """Score-ranked candidate sets off the windowed slab dots: [q, d] ->
    [q, budget] unique row ids (-1 pad), ranked by cosine similarity.

    candidate_ids' per-query dedup-rank runs two ~4k-wide sorts over the
    [L*W] window union.  Selecting candidates BY SCORE first inverts the
    costs: slab_window_dots (ops/pallas/slabscore.py) dots every window
    lane, a per-table approx_max_k keeps the ceil(budget/L) best lanes per
    window, and the dedup sorts shrink from the 4k-wide union to the
    [L * budget/L] ~ budget survivors.  The narrow form rides the same
    guarantee as slab_topk: >= kk distinct better rows in a window imply
    >= kk globally better rows, so the set provably contains the global
    score-top-ceil(budget/L).

    Score-ranked truncation is a strictly stronger rule than
    candidate_ids' collision-count ranking.  The count-ranked
    candidate_ids stays as the reference-semantics engine (whole-bucket
    unions, /root/reference/lib/lsh_cube.hpp:77-106).

    Requires a packed index with scale-free slabs: cosine (pack_index
    bf16 / global-int8 / f32), or euclidean with the AUGMENTED layout
    (pack_index augment=True) — the augmented slab dot x·q - |x|²/2 is the
    monotone euclidean rank, so euclidean sets ride the identical windowed
    dots + epilogue (per-row-scale int8 raises).
    """
    from crypto_rec_tpu.ops.pallas.slabscore import (
        slab_window_dots,
    )

    if index.packed is None:
        raise ValueError("candidate_ids_scored requires a packed index")
    euclid_aug = index.metric == "euclidean" and index.packed_aug_scale is not None
    if not (index.metric == "cosine" or euclid_aug) \
            or index.packed_scale is not None:
        raise ValueError(
            "candidate_ids_scored rides the windowed slab dots: cosine "
            "scale-free slabs or augmented euclidean slabs only (use "
            "candidate_ids for the general path)"
        )
    L = index.sorted_rows.shape[0]
    n = index.n_rows
    n_pad = index.packed_rows.shape[1]
    q = queries.shape[0]
    d = queries.shape[1]
    q_buckets, q_detailed = query_hashes(index, queries)
    l_idx = jnp.arange(L, dtype=jnp.int32)
    start = index.bucket_starts[l_idx[None, :], q_buckets]
    end = index.bucket_starts[l_idx[None, :], q_buckets + 1]
    size = end - start
    if euclid_aug and index.packed_detailed is not None:
        # (bucket, fingerprint)-sorted slabs: jump to the exact-tuple run
        # (same contract as packed_retrieve_pallas_euclid)
        flat_fp = index.packed_detailed.reshape(-1)
        base = l_idx[None, :] * n_pad
        s0 = _fp_run_starts(
            lambda p: flat_fp[base + p], start, end, q_detailed, n_pad
        )
    else:
        golden = jnp.int32(-1640531527)
        mix = (q_buckets * golden) ^ (l_idx[None, :] * jnp.int32(40503))
        s0 = start + jnp.remainder(
            jnp.abs(mix), jnp.maximum(size - per_table, 0) + 1
        )
    sizes = jnp.minimum(end - s0, per_table)
    qv = queries.astype(jnp.float32)
    if euclid_aug:
        d_aug = index.packed.shape[-1]
        qv = jnp.concatenate(
            [
                qv,
                jnp.broadcast_to(
                    jnp.asarray(index.packed_aug_scale, jnp.float32), (q, 1)
                ),
                jnp.zeros((q, d_aug - d - 1), jnp.float32),
            ],
            axis=1,
        )
    else:
        qv = qv / jnp.maximum(
            jnp.linalg.norm(qv, axis=1, keepdims=True), 1e-30)
    dots, a0 = slab_window_dots(
        index.packed, None, s0, sizes, qv, per_table=per_table, mask=False,
    )
    win = dots.shape[2]
    kk = min(-(-budget // L), win)
    rows = dots.reshape(q * L, win)
    s1, lane = jax.lax.approx_max_k(rows, kk, recall_target=0.9)
    s1 = s1.reshape(q, L * kk)
    lane = lane.reshape(q, L, kk)
    gpos = (
        l_idx[None, :, None] * n_pad
        + jnp.minimum(a0[:, :, None] + lane, n_pad - 1)
    ).reshape(q, L * kk)
    ids1 = index.packed_rows.reshape(-1)[gpos]
    ids1 = jnp.where(s1 > -jnp.inf, ids1, n)
    # dedup: sort by id (score rides the sort as a payload operand — no
    # take_along_axis gathers, see slabscore._dedup_topk_pairs), then
    # first-occurrence mask and score-rank to budget
    ids_s, sc_s = jax.lax.sort((ids1, s1), num_keys=1)
    dup = jnp.concatenate(
        [jnp.zeros((q, 1), bool), ids_s[:, 1:] == ids_s[:, :-1]], axis=1
    )
    sc_s = jnp.where(dup | (ids_s >= n), -jnp.inf, sc_s)
    s2, pos2 = jax.lax.top_k(sc_s, min(budget, L * kk))
    out = jnp.where(
        s2 > -jnp.inf, jnp.take_along_axis(ids_s, pos2, axis=1), -1
    )
    if out.shape[1] < budget:
        out = jnp.pad(out, ((0, 0), (0, budget - out.shape[1])),
                      constant_values=-1)
    return out


@functools.partial(
    jax.jit, static_argnames=("budget", "filtered", "per_table", "with_stats")
)
def candidate_ids(
    index: LshIndex,
    queries: jax.Array,
    budget: int,
    filtered: bool = True,
    per_table: int = 0,
    with_stats: bool = False,
) -> jax.Array:
    """CSR fixed-budget retrieval: [q, d] -> [q, budget] row ids (-1 pad).

    Per query and table: a window of up to `per_table` rows from the CSR
    bucket slice, then a sort-dedup union across tables truncated to
    `budget`.  per_table defaults to `budget` — matching the reference
    semantics where any single table's bucket may supply the entire
    candidate set (get_LSH_combined_buckets unions whole buckets,
    lsh_cube.hpp:77-106); pass a smaller per_table (e.g. budget // L) to
    trade recall for gather bandwidth at very large L.  Truncation beyond
    the window/budget is the static-shape tradeoff; recall-vs-budget is
    measured against the exact oracle.
    """
    q_buckets, q_detailed = query_hashes(index, queries)
    return gather_candidate_ids(
        index.sorted_rows, index.bucket_starts,
        index.detailed if filtered else None,
        index.n_rows, q_buckets, q_detailed, budget, per_table,
        with_stats=with_stats,
    )


def gather_candidate_ids(
    sorted_rows: jax.Array,     # [L, n] CSR member arrays
    bucket_starts: jax.Array,   # [L, nb + 1]
    detailed: Optional[jax.Array],   # [L, n] fingerprints or None (no filter)
    n_rows: int,
    q_buckets: jax.Array,       # [q, L]
    q_detailed: Optional[jax.Array],  # [q, L] fingerprints or None
    budget: int,
    per_table: int = 0,
    with_stats: bool = False,
):
    """Raw-array core of candidate_ids — shared by the local and the
    mp-sharded index (parallel/sharded_index.py runs it per shard inside a
    shard_map with shard-local arrays).

    with_stats=True additionally returns a truncation-accounting dict of
    per-query int32 vectors (the "no silent truncation" contract of
    models/ivf.py applied here):
      unique_candidates  — distinct rows gathered before the budget cut;
      budget_dropped     — distinct rows the budget discarded;
      window_dropped     — bucket members beyond the per-table window
                           (an upper bound for the filtered/euclidean path,
                           whose windows start at the exact-tuple run).
    """
    L = sorted_rows.shape[0]
    per_table = per_table or budget
    sentinel = n_rows

    def per_query(qb, qd):
        win_drop = jnp.int32(0)
        def per_table_gather(l, b):
            start = bucket_starts[l, b]
            end = bucket_starts[l, b + 1]
            size = end - start
            if detailed is not None:
                # rows are (bucket, fingerprint)-sorted: jump straight to
                # the query's exact-tuple run (every slot a true match
                # until the run ends) instead of sampling the bucket
                base = _fp_run_starts(
                    lambda p: detailed[l, sorted_rows[l, p]],
                    start, end, qd[l], n_rows,
                )
            else:
                # Buckets larger than the window are sampled at a
                # pseudo-random offset derived from (bucket, table).  A
                # fixed offset (e.g. always the head, or a per-table
                # stagger) would make a given row depend on ONE specific
                # table colliding — destroying the L-table redundancy LSH
                # relies on.  Random offsets keep per-table coverage
                # independent; buckets <= window are fully covered.
                max_off = jnp.maximum(size - per_table, 0)
                golden = jnp.int32(-1640531527)  # 0x9E3779B1 as signed int32
                mix = (b * golden) ^ (jnp.int32(l) * jnp.int32(40503))
                roff = jnp.remainder(jnp.abs(mix), max_off + 1)
                base = start + roff
            offs = base + jnp.arange(per_table, dtype=jnp.int32)
            valid = offs < end
            rows = sorted_rows[l, jnp.minimum(offs, n_rows - 1)]
            if detailed is not None:
                tuple_ok = detailed[l, rows] == qd[l]
                valid = valid & tuple_ok
            return jnp.where(valid, rows, sentinel), jnp.maximum(
                size - per_table, 0
            )

        per_l = [per_table_gather(l, qb[l]) for l in range(L)]
        gathered = jnp.stack([g for g, _ in per_l]).reshape(-1)
        if not with_stats:
            return _dedup_rank_fixed(gathered, sentinel, budget, L)
        win_drop = sum(d for _, d in per_l) + win_drop
        out, n_unique = _dedup_rank_fixed(
            gathered, sentinel, budget, L, with_count=True
        )
        return out, n_unique, win_drop

    if q_detailed is None:
        q_detailed = jnp.zeros((q_buckets.shape[0], L), jnp.int32)
    res = jax.vmap(per_query)(q_buckets, q_detailed)
    if not with_stats:
        return res
    ids, n_unique, win_drop = res
    stats = {
        "unique_candidates": n_unique,
        "budget_dropped": jnp.maximum(n_unique - budget, 0),
        "window_dropped": win_drop,
    }
    return ids, stats


@functools.partial(
    jax.jit,
    static_argnames=(
        "top_k", "per_table", "filtered", "q_block", "block_rows",
        "int8_rerank", "approx_stage1", "stage1_width", "stage1_per_table",
    ),
)
def retrieve_topk(
    index: LshIndex,
    queries: jax.Array,   # [q, d]
    corpus: jax.Array,    # [n, d] — the indexed rows themselves
    top_k: int,
    per_table: int = 256,
    filtered: bool = True,
    q_block: int = 256,
    block_rows: int = 128,
    int8_rerank: bool = True,
    approx_stage1: bool = False,
    stage1_width: int = 0,
    stage1_per_table: int = 0,
) -> Tuple[jax.Array, jax.Array]:
    """Fused end-to-end retrieval: bucket gather -> score -> top-k.

    approx_stage1 selects approximate stage-1 selection (approx_max_k);
    on a packed cosine index with scale-free slabs it also selects the
    maskless windows of the production form (packed_retrieve_pallas),
    whose windows are a recall superset of the reference's.  With
    approx_stage1=False retrieval keeps exact reference window semantics.

    stage1_width (windowed-dots path only) caps the stage-1 survivor count below
    the L*top_k dedup guarantee — see slabscore.slab_topk.

    -> (scores [q, top_k] descending, row ids [q, top_k], -1 pad).  Scores
    are cosine similarity / negated euclidean distance (nearest-first).

    Unlike candidate_ids (which must produce a deduplicated candidate SET
    for the CF engine's weighted sums), this path scores the raw per-table
    windows — duplicates included — and dedups only the top L*top_k
    survivors.  That removes the O(L * window * log) dedup sort per query,
    the QPS bottleneck of the set-producing path, while returning the
    identical top-k (a duplicate can only displace copies of itself).

    Queries stream through lax.map in blocks of `q_block` so the gathered
    candidate tensor ([block, L*per_table, d]) stays bounded regardless of
    the batch size (8192 queries x 8 tables x 976-window x 128-d f32 would
    otherwise be a 32 GiB allocation).
    """
    q = queries.shape[0]
    pad_q = (-q) % q_block
    queries_p = jnp.pad(queries, ((0, pad_q), (0, 0)))
    vals, ids = jax.lax.map(
        lambda blk: _retrieve_topk_block(
            index, blk, corpus, top_k, per_table, filtered, block_rows,
            int8_rerank, approx_stage1, stage1_width, stage1_per_table,
        ),
        queries_p.reshape(-1, q_block, queries.shape[1]),
    )
    return (
        vals.reshape(-1, top_k)[:q],
        ids.reshape(-1, top_k)[:q],
    )


def _retrieve_topk_block(
    index: LshIndex,
    queries: jax.Array,
    corpus: jax.Array,
    top_k: int,
    per_table: int,
    filtered: bool,
    block_rows: int = 128,
    int8_rerank: bool = True,
    approx_stage1: bool = False,
    stage1_width: int = 0,
    stage1_per_table: int = 0,
) -> Tuple[jax.Array, jax.Array]:
    if index.packed is not None:
        return _retrieve_topk_block_packed(
            index, queries, corpus, top_k, per_table, filtered, block_rows,
            int8_rerank, approx_stage1, stage1_width, stage1_per_table,
        )
    L = index.bucket_ids.shape[1]
    q_buckets, q_detailed = query_hashes(index, queries)
    sentinel = index.n_rows

    def per_query(qvec, qb, qd):
        def per_table_gather(l, b):
            start = index.bucket_starts[l, b]
            end = index.bucket_starts[l, b + 1]
            size = end - start
            if filtered and index.detailed is not None:
                # jump to the query's exact-tuple run (see _fp_run_starts)
                base = _fp_run_starts(
                    lambda p: index.detailed[l, index.sorted_rows[l, p]],
                    start, end, qd[l], index.n_rows,
                )
            else:
                max_off = jnp.maximum(size - per_table, 0)
                golden = jnp.int32(-1640531527)
                mix = (b * golden) ^ (jnp.int32(l) * jnp.int32(40503))
                roff = jnp.remainder(jnp.abs(mix), max_off + 1)
                base = start + roff
            offs = base + jnp.arange(per_table, dtype=jnp.int32)
            valid = offs < end
            rows = index.sorted_rows[l, jnp.minimum(offs, index.n_rows - 1)]
            if filtered and index.detailed is not None:
                ok = index.detailed[l, rows] == qd[l]
                valid = valid & ok
            return jnp.where(valid, rows, sentinel)

        ids = jnp.stack(
            [per_table_gather(l, qb[l]) for l in range(L)]
        ).reshape(-1)                                      # [L * per_table]
        valid = ids < sentinel
        safe = jnp.minimum(ids, index.n_rows - 1)
        cand = corpus[safe]                                # [m, d]
        if index.metric == "cosine":
            dots = cand @ qvec
            cn = jnp.sqrt(jnp.sum(cand * cand, axis=1))
            qn = jnp.sqrt(jnp.sum(qvec * qvec))
            score = dots / jnp.maximum(cn * qn, 1e-30)
        else:
            diff = cand - qvec[None, :]
            score = -jnp.sqrt(jnp.maximum(jnp.sum(diff * diff, axis=1), 0.0))
        score = jnp.where(valid, score, -jnp.inf)

        # stage 1: top L*top_k with duplicates; stage 2: dedup + final top-k
        m1 = min(L * top_k, score.shape[0])
        s1, pos1 = jax.lax.top_k(score, m1)
        ids1 = safe[pos1]
        order = jnp.argsort(ids1)
        ids_sorted = ids1[order]
        s_sorted = s1[order]
        dup = jnp.concatenate(
            [jnp.zeros((1,), bool), ids_sorted[1:] == ids_sorted[:-1]]
        )
        s_sorted = jnp.where(dup | ~jnp.isfinite(s_sorted), -jnp.inf, s_sorted)
        s2, pos2 = jax.lax.top_k(s_sorted, top_k)
        out_ids = jnp.where(s2 > -jnp.inf, ids_sorted[pos2], -1)
        return s2, out_ids

    if q_detailed is None:
        q_detailed = jnp.zeros((queries.shape[0], L), jnp.int32)
    return jax.vmap(per_query)(queries, q_buckets, q_detailed)


def _retrieve_topk_block_packed(
    index: LshIndex,
    queries: jax.Array,
    corpus: jax.Array,
    top_k: int,
    per_table: int,
    filtered: bool,
    block_rows: int = 128,
    int8_rerank: bool = True,
    approx_stage1: bool = False,
    stage1_width: int = 0,
    stage1_per_table: int = 0,
) -> Tuple[jax.Array, jax.Array]:
    quantized = jnp.issubdtype(index.packed.dtype, jnp.integer)
    if index.packed_aug_scale is not None:
        # augmented euclidean slabs ride the windowed dots only (their
        # d_aug columns cannot be scored by the blocked XLA core against
        # d-dim queries)
        from crypto_rec_tpu.ops.pallas.slabscore import (
            packed_retrieve_pallas_euclid,
        )

        q_buckets, q_detailed = query_hashes(index, queries)
        # the augmented rank's bf16/int8 band is ~0.4% of max|x|^2 —
        # oversample 2x and rescore the survivors exactly (a 2*top_k-row
        # gather), which restores true -distance scores and exact order.
        # int8_rerank=False returns the kernel's dequantized rank scores
        # directly (-sqrt(|q|^2 - 2*rank)) with NO corpus read — the mode
        # a host-oracle run uses, where the f32 corpus is freed after
        # packing (quantization can permute near-ties; recall is
        # measured against the exact oracle either way)
        core_k = 2 * top_k if int8_rerank else top_k
        s_, ids = packed_retrieve_pallas_euclid(
            index.packed, index.packed_rows,
            index.packed_detailed if filtered else None,
            index.bucket_starts, index.n_rows, queries.shape[1],
            queries, q_buckets, q_detailed if filtered else None,
            index.packed_gscale, index.packed_aug_scale,
            core_k, per_table,
        )
        if not int8_rerank:
            return s_, ids
        return rerank_exact(corpus, index.metric, queries, ids, top_k)
    # int8_rerank=False + global-scale slabs: rank the raw int8 dots and
    # dequant the SCORES with the stored scalar — no exact rerank and no
    # random-row gather.  Quantization noise (~1% of a unit dot) can
    # permute near-ties, so the default keeps the rerank; disable it when
    # the workload's margins dominate the noise.
    scale_free = (
        quantized and not int8_rerank and index.packed_gscale is not None
    )
    # cosine scale-free slabs (bf16/f32, or global-scale int8 whose raw
    # dots are order-preserving — pack_index scale_mode) ride the windowed
    # slab dots: approx_stage1 selects the production form (maskless
    # windows + approximate stage-1), otherwise the strict form keeps the
    # exact reference window semantics.  Per-row-scale int8 and
    # non-augmented euclidean keep the blocked XLA core below.
    if index.metric == "cosine" and index.packed_scale is None:
        from crypto_rec_tpu.ops.pallas.slabscore import packed_retrieve_pallas

        q_buckets, _ = query_hashes(index, queries)
        core_k = (
            min(4 * top_k, index.sorted_rows.shape[0] * top_k)
            if quantized and not scale_free else top_k
        )
        s, ids = packed_retrieve_pallas(
            index.packed, index.packed_rows, None, index.bucket_starts,
            index.n_rows, queries, q_buckets, core_k, per_table,
            strict=not approx_stage1, stage1_width=stage1_width,
            stage1_per_table=stage1_per_table,
        )
        if scale_free:
            return s * index.packed_gscale, ids
        if not quantized:
            return s, ids
        return rerank_exact(corpus, index.metric, queries, ids, top_k)
    q_buckets, q_detailed = query_hashes(index, queries)
    # per-row-scale int8 (and pre-round-3 global archives): over-fetch 4x,
    # then rescore the survivors exactly so quantization cannot permute
    # the final top-k (see rerank_exact)
    core_k = (
        min(4 * top_k, index.sorted_rows.shape[0] * top_k)
        if quantized and not scale_free else top_k
    )
    s, ids = packed_retrieve_core(
        index.packed, index.packed_rows, index.packed_sqnorm,
        index.packed_detailed if filtered else None,
        index.bucket_starts, index.n_rows, index.metric,
        queries, q_buckets, q_detailed, core_k, per_table, block_rows,
        packed_scale=index.packed_scale, approx_stage1=approx_stage1,
    )
    if scale_free:
        return s * index.packed_gscale, ids
    if not quantized:
        return s, ids
    return rerank_exact(corpus, index.metric, queries, ids, top_k)


def rerank_exact(
    corpus: jax.Array,    # [n, d] full-precision rows
    metric: str,
    queries: jax.Array,   # [q, d]
    ids: jax.Array,       # [q, m] candidate row ids, -1 pad
    top_k: int,
) -> Tuple[jax.Array, jax.Array]:
    """Exact rescoring of a small candidate list (the int8 slab path's
    second stage): one [q, m, d] row gather + one einsum — m is ~4*top_k,
    so this is noise next to the slab gather it corrects."""
    valid = ids >= 0
    safe = jnp.maximum(ids, 0)
    cand = corpus[safe].astype(jnp.float32)          # [q, m, d]
    qv = queries.astype(jnp.float32)
    if metric == "cosine":
        qn = qv / jnp.maximum(jnp.linalg.norm(qv, axis=1, keepdims=True), 1e-30)
        dots = jnp.einsum("qd,qmd->qm", qn, cand,
                          preferred_element_type=jnp.float32,
                          precision=jax.lax.Precision.HIGHEST)
        cn = jnp.linalg.norm(cand, axis=2)
        score = dots / jnp.maximum(cn, 1e-30)
    else:
        diff = cand - qv[:, None, :]
        score = -jnp.sqrt(jnp.maximum(jnp.sum(diff * diff, axis=2), 0.0))
    score = jnp.where(valid, score, -jnp.inf)
    s, pos = jax.lax.top_k(score, top_k)
    out = jnp.take_along_axis(ids, pos, axis=1)
    return s, jnp.where(s > -jnp.inf, out, -1)


def packed_retrieve_core(
    packed: jax.Array,           # [L, n_pad, d] CSR-ordered corpus copies
    packed_rows: jax.Array,      # [L, n_pad] int32, sentinel n past the end
    packed_sqnorm: Optional[jax.Array],    # [L, n_pad] f32 (euclidean)
    packed_detailed: Optional[jax.Array],  # [L, n_pad] fingerprints (or None)
    bucket_starts: jax.Array,    # [L, n_buckets + 1]
    n_rows: int,
    metric: str,
    queries: jax.Array,          # [q, d]
    q_buckets: jax.Array,        # [q, L]
    q_detailed: Optional[jax.Array],  # [q, L] fingerprints
    top_k: int,
    per_table: int,
    block_rows: int = 128,
    packed_scale: Optional[jax.Array] = None,  # [L, n_pad] f32 (int8 slabs)
    approx_stage1: bool = False,
) -> Tuple[jax.Array, jax.Array]:
    """retrieve_topk over the packed-slab layout (pack_index) — raw-array
    core shared by the local index and the mp-sharded index (which runs it
    per shard inside a shard_map with shard-local arrays).

    Each query/table window [s0, s0 + per_table) is covered by B ALIGNED
    W-row blocks of the CSR-ordered corpus copy, fetched with one batched
    `blocks[idx]` gather — the gather-of-aligned-slices form XLA turns into
    wide contiguous reads (the layout trick of models/ivf.py, applied per LSH
    table).  Rows outside [s0, min(s0 + per_table, bucket_end)) are masked; scores
    and the two-stage dedup top-k match the unpacked path up to the packed
    dtype's rounding (usually bf16).

    The windows-per-query count T comes from q_buckets.shape[1]; each window
    t reads slab t % L.  For the LSH index T == L (one window per table);
    the hypercube reuses this core with L == 1 slab and T == `probes`
    windows, all over the same vertex-CSR slab (hypercube.cube_retrieve_topk).
    """
    L, n_pad, d = packed.shape
    T = q_buckets.shape[1]
    n = n_rows
    pad = n_pad - n
    W = block_rows
    while n_pad % W:  # pack_index pads to a 512 multiple
        W //= 2
    if W < 8:
        raise ValueError(f"packed length {n_pad} not divisible by a block size")
    B = (per_table + W - 2) // W + 1
    if per_table + 2 * W > pad:
        raise ValueError(
            f"per_table={per_table} (+2 blocks of {W}) exceeds packed "
            f"pad={pad}; re-pack with pack_index(..., pad>={per_table + 2 * W})"
        )
    nblk = n_pad // W
    q = queries.shape[0]

    w_idx = jnp.arange(T, dtype=jnp.int32)      # window index per query
    slab_idx = w_idx % L                        # which slab a window reads
    start = bucket_starts[slab_idx[None, :], q_buckets]          # [q, T]
    end = bucket_starts[slab_idx[None, :], q_buckets + 1]
    size = end - start
    if packed_detailed is not None:
        # (bucket, fingerprint)-sorted slabs: start each window at the
        # query's exact-tuple run via binary search over the CSR-ordered
        # fingerprint plane (see _fp_run_starts / _csr_from_buckets)
        flat_fp = packed_detailed.reshape(-1)
        base = slab_idx[None, :] * n_pad
        s0 = _fp_run_starts(
            lambda p: flat_fp[base + p], start, end, q_detailed, n_pad
        )                                                        # [q, T]
    else:
        # pseudo-random window offset: keeps per-table coverage of
        # oversized buckets independent across tables
        # (see gather_candidate_ids)
        golden = jnp.int32(-1640531527)
        mix = (q_buckets * golden) ^ (w_idx[None, :] * jnp.int32(40503))
        s0 = start + jnp.remainder(
            jnp.abs(mix), jnp.maximum(size - per_table, 0) + 1
        )                                                        # [q, T]
    lim = jnp.minimum(s0 + per_table, end)

    blk = (s0 // W)[:, :, None] + jnp.arange(B, dtype=jnp.int32)  # [q, T, B]
    gidx = (slab_idx[None, :, None] * nblk + blk).reshape(q, T * B)
    pos = (blk[..., None] * W + jnp.arange(W, dtype=jnp.int32))   # [q, T, B, W]
    valid = (pos >= s0[..., None, None]) & (pos < lim[..., None, None])

    cand = packed.reshape(nblk * L, W, d)[gidx]             # [q, T*B, W, d]
    rows = packed_rows.reshape(nblk * L, W)[gidx]           # [q, T*B, W]
    if packed_detailed is not None:
        dblk = packed_detailed.reshape(nblk * L, W)[gidx]
        ok = dblk.reshape(q, T, B, W) == q_detailed[:, :, None, None]
        valid = valid & ok

    qv = queries.astype(jnp.float32)
    if metric == "cosine":
        qv = qv / jnp.maximum(
            jnp.linalg.norm(qv, axis=1, keepdims=True), 1e-30
        )
    if jnp.issubdtype(packed.dtype, jnp.integer):
        # int8 slab: bf16 upcast (exact for |v| <= 127), then per-row
        # dequant of the dot — the slab read stays 1 byte/element
        cand = cand.astype(jnp.bfloat16)
    # score in the slab's own dtype (f32 accumulate); slab rounding is
    # already the packed path's documented tolerance
    dots = jnp.einsum(
        "qd,qmwd->qmw", qv.astype(cand.dtype), cand,
        preferred_element_type=jnp.float32,
    )
    if packed_scale is not None:
        dots = dots * packed_scale.reshape(nblk * L, W)[gidx]
    if metric == "cosine":
        score = dots  # packed rows are pre-normalized
    else:
        sq = packed_sqnorm.reshape(nblk * L, W)[gidx]
        qsq = jnp.sum(qv * qv, axis=1)
        score = -jnp.sqrt(
            jnp.maximum(sq - 2.0 * dots + qsq[:, None, None], 0.0)
        )

    m = T * B * W
    score = jnp.where(valid.reshape(q, m), score.reshape(q, m), -jnp.inf)
    ids = jnp.where(valid.reshape(q, m), rows.reshape(q, m), n)
    safe = jnp.minimum(ids, n - 1)

    # stage 1: top T*top_k with duplicates; stage 2: dedup + final top-k.
    # approx_stage1 swaps lax.top_k for approx_max_k (recall_target 0.9),
    # as slab_topk(exact=False) does; near-tie lanes may swap.
    m1 = min(T * top_k, m)
    if approx_stage1:
        s1, pos1 = jax.lax.approx_max_k(score, m1, recall_target=0.9)
    else:
        s1, pos1 = jax.lax.top_k(score, m1)                 # [q, m1]
    ids1 = jnp.take_along_axis(safe, pos1, axis=1)
    # payload sort instead of argsort + gathers
    ids_sorted, s_sorted = jax.lax.sort((ids1, s1), num_keys=1)
    dup = jnp.concatenate(
        [jnp.zeros((q, 1), bool), ids_sorted[:, 1:] == ids_sorted[:, :-1]],
        axis=1,
    )
    s_sorted = jnp.where(dup | ~jnp.isfinite(s_sorted), -jnp.inf, s_sorted)
    s2, pos2 = jax.lax.top_k(s_sorted, top_k)
    out_ids = jnp.where(
        s2 > -jnp.inf, jnp.take_along_axis(ids_sorted, pos2, axis=1), -1
    )
    return s2, out_ids


@functools.partial(
    jax.jit,
    static_argnames=("top_k", "per_table", "strict", "int8_rerank",
                     "stage1_width", "stage1_per_table"),
)
def retrieve_topk_pallas(
    index: LshIndex,
    queries: jax.Array,   # [q, d]
    corpus: jax.Array,    # [n, d] full-precision rows (int8 exact rerank)
    top_k: int,
    per_table: int = 256,
    strict: bool = False,
    int8_rerank: bool = True,
    stage1_width: int = 0,
    stage1_per_table: int = 0,
) -> Tuple[jax.Array, jax.Array]:
    """retrieve_topk over the packed layout via the windowed slab dots
    (ops/pallas/slabscore.py), in one call with no q_block streaming.
    Cosine + unfiltered only; the blocked XLA core remains the general
    path.

    strict: see packed_retrieve_pallas — False (default) is the measured
    production form (maskless multiprobe windows + approx stage-1), True
    pins exact reference window semantics for parity tests.
    """
    if index.packed is None:
        raise ValueError("retrieve_topk_pallas requires a packed index")
    if index.metric != "cosine":
        raise ValueError("retrieve_topk_pallas is cosine-only; use retrieve_topk")
    from crypto_rec_tpu.ops.pallas.slabscore import packed_retrieve_pallas

    q_buckets, _ = query_hashes(index, queries)
    quantized = jnp.issubdtype(index.packed.dtype, jnp.integer)
    scale_free = (
        quantized and not int8_rerank and index.packed_gscale is not None
    )
    core_k = (
        min(4 * top_k, index.sorted_rows.shape[0] * top_k)
        if quantized and not scale_free else top_k
    )
    s, ids = packed_retrieve_pallas(
        index.packed, index.packed_rows, index.packed_scale,
        index.bucket_starts, index.n_rows, queries, q_buckets,
        core_k, per_table, strict=strict, stage1_width=stage1_width,
        stage1_per_table=stage1_per_table,
    )
    if scale_free:
        return s * index.packed_gscale, ids
    if quantized:
        return rerank_exact(corpus, index.metric, queries, ids, top_k)
    return s, ids


def mask_from_candidate_ids(ids: jax.Array, n_rows: int) -> jax.Array:
    """[q, budget] id lists -> dense [q, n] bool mask (for engines that want
    the mask form; -1 entries are ignored)."""
    q = ids.shape[0]
    mask = jnp.zeros((q, n_rows), dtype=bool)
    rows = jnp.broadcast_to(jnp.arange(q)[:, None], ids.shape)
    safe = jnp.maximum(ids, 0)
    updates = ids >= 0
    return mask.at[rows, safe].max(updates)
