"""Row-sharded LSH index: per-shard CSR build + sharded retrieval.

The scale architecture for BASELINE.json configs 4-5 (a sharded index of
up to 1B rows over several cards and hosts):

* the corpus is row-sharded over "mp"; every shard hashes ITS rows with the
  (replicated) hash family and builds a shard-local CSR bucket table — the
  build is embarrassingly parallel (one matmul + one sort per shard, no
  collectives);
* a query is hashed once (replicated — the family params are tiny), each
  shard gathers candidates from its local buckets, scores them against its
  local rows, and reduces to a local top-k;
* local top-ks (values + global row ids + optionally the rating rows) merge
  over an "mp" all_gather — the collective moves O(k) floats per query per
  shard, never corpus rows.

A CPU-mesh test asserts the sharded result equals the single-device
candidate_ids + scoring path row-for-row.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from crypto_rec_tpu.models.lsh.hyperplane import CosineLsh
from crypto_rec_tpu.models.lsh.pstable import PStableLsh
from crypto_rec_tpu.models.lsh.index import (
    _csr_from_buckets,
    gather_candidate_ids,
    packed_retrieve_core,
    rerank_exact,
)


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=(
        "family", "sorted_rows", "bucket_starts", "detailed",
        "packed", "packed_rows", "packed_sqnorm", "packed_detailed",
        "packed_scale", "packed_gscale", "packed_aug_scale",
    ),
    meta_fields=("metric", "n_buckets", "n_local", "n_shards"),
)
@dataclasses.dataclass
class ShardedLshIndex:
    """Per-shard CSR tables.  sorted_rows/bucket_starts lead with the shard
    axis and are placed with P("mp", ...); row ids inside are shard-LOCAL.

    The optional packed fields are the per-shard packed-slab layout (see
    models/lsh/index.pack_index): shard-local CSR-ordered corpus copies so
    each shard's retrieval rides aligned-block gathers instead of random
    row gathers.  Built by pack_sharded_index."""

    metric: str
    n_buckets: int
    n_local: int
    n_shards: int
    family: object
    sorted_rows: jax.Array     # [S, L, n_local]
    bucket_starts: jax.Array   # [S, L, n_buckets + 1]
    detailed: Optional[jax.Array]  # [S, L, n_local] fingerprints or None
    packed: Optional[jax.Array] = None          # [S, L, n_local + pad, d]
    packed_rows: Optional[jax.Array] = None     # [S, L, n_local + pad]
    packed_sqnorm: Optional[jax.Array] = None   # [S, L, n_local + pad]
    packed_detailed: Optional[jax.Array] = None  # [S, L, n_local + pad]
    packed_scale: Optional[jax.Array] = None     # [S, L, n_local + pad] (int8)
    # global-scale int8 only: per-shard dequant scalar [S] — dots × it are
    # true-sim approximations, comparable ACROSS shards at the all_gather
    # merge (each shard applies its own scalar before merging)
    packed_gscale: Optional[jax.Array] = None
    # augmented-euclidean layout: per-shard [S] dequant scale for the
    # -|x|^2/2 norm column appended to each slab row; emitted by
    # pack_sharded_index(augment=True) and consumed by sharded_retrieve_topk
    packed_aug_scale: Optional[jax.Array] = None


def build_sharded_index(
    mesh: Mesh,
    key: jax.Array,
    corpus: jax.Array,   # [n, d], row-sharded over "mp" (or shardable)
    metric: str,
    k: int,
    L: int,
    lsh_bucket_div: int = 4,
    euclidean_h_w: float = 1.0,
) -> ShardedLshIndex:
    n, d = corpus.shape
    S = mesh.shape["mp"]
    if n % S:
        raise ValueError(f"corpus rows {n} must divide the mp axis {S}")
    n_local = n // S
    if metric == "cosine":
        fam = CosineLsh.create(key, d, k, L)
        n_buckets = fam.n_buckets
    elif metric == "euclidean":
        fam = PStableLsh.create(key, d, k, L, euclidean_h_w)
        n_buckets = max(1, n_local // max(1, lsh_bucket_div))
    else:
        raise ValueError(f"unknown metric {metric!r}")

    def body(x_blk):
        if metric == "cosine":
            b = fam.bucket_ids(x_blk)
            det = None
        else:
            h = fam.hash_values(x_blk)
            b = fam.bucket_ids_from_hashes(h, n_buckets)
            det = fam.fingerprints_from_hashes(h).T  # [L, n_local]
        # euclidean: (bucket, fingerprint) order so query windows jump to
        # their exact-tuple run (models/lsh/index._fp_run_starts)
        rows, starts = _csr_from_buckets(
            b, n_buckets, secondary=None if det is None else det.T
        )
        out = (rows[None], starts[None])
        if det is not None:
            out += (det[None],)
        return out

    out_specs = (P("mp", None, None), P("mp", None, None))
    if metric == "euclidean":
        out_specs += (P("mp", None, None),)
    outs = jax.shard_map(
        body, mesh=mesh, in_specs=(P("mp", None),), out_specs=out_specs,
        check_vma=False,
    )(corpus)
    rows, starts = outs[0], outs[1]
    det = outs[2] if metric == "euclidean" else None
    return ShardedLshIndex(
        metric=metric,
        n_buckets=n_buckets,
        n_local=n_local,
        n_shards=S,
        family=fam,
        sorted_rows=rows,
        bucket_starts=starts,
        detailed=det,
    )


def pack_sharded_index(
    mesh: Mesh,
    index: ShardedLshIndex,
    corpus: jax.Array,   # [n, d] row-sharded over "mp" (the indexed rows)
    dtype=jnp.bfloat16,
    pad: int = 4096,
    scale_mode: str = "auto",
    augment: bool = False,
) -> ShardedLshIndex:
    """Per-shard packed-slab layout (models/lsh/index.pack_index, applied
    shard-locally): each shard rewrites ITS corpus rows in CSR order so its
    retrieval leg gathers aligned blocks at streaming bandwidth.  No
    collectives — packing is as embarrassingly parallel as the build.

    scale_mode as in pack_index; "global" (int8 cosine auto) uses a
    SHARD-local scalar scale with no collective — each shard multiplies its
    raw dots by ITS scalar (stored in packed_gscale) before the all_gather
    merge, so the merged scores compare like with like across shards
    without any rerank gather (sharded_retrieve_topk)."""
    n_local = index.n_local
    L = index.sorted_rows.shape[1]
    d = corpus.shape[1]
    metric = index.metric
    pad = -(n_local + pad) % 512 + pad  # align to the block grid
    has_det = index.detailed is not None
    quantized = jnp.issubdtype(jnp.dtype(dtype), jnp.integer)
    if augment and metric != "euclidean":
        raise ValueError("augment=True is the euclidean rank layout")
    if scale_mode == "auto":
        if augment:
            scale_mode = "global" if quantized else "none"
        else:
            scale_mode = "global" if metric == "cosine" else "row"
    if scale_mode not in ("global", "row", "none"):
        raise ValueError(f"unknown scale_mode {scale_mode!r}")
    if augment and scale_mode == "row":
        raise ValueError("augmented slabs use one global scale, not per-row")
    row_scaled = quantized and scale_mode == "row"
    d_aug = -(-(d + 1) // 128) * 128 if augment else d

    def body(rows, corpus_blk, *rest):
        rows = rows[0]                    # [L, n_local]
        g_scale = aug_scale = None
        if quantized and scale_mode == "global":
            if metric == "cosine":
                amax = jnp.max(
                    jnp.max(jnp.abs(corpus_blk), axis=1)
                    / jnp.maximum(jnp.linalg.norm(corpus_blk, axis=1), 1e-30)
                )
            else:
                amax = jnp.max(jnp.abs(corpus_blk))
            g_scale = jnp.maximum(amax, 1e-30) / 127.0
        if augment:
            norm_half_max = jnp.max(
                jnp.sum(corpus_blk * corpus_blk, axis=1)
            ) / 2.0
            if quantized:
                aug_scale = jnp.maximum(norm_half_max, 1e-30) / (
                    127.0 * g_scale
                )
            else:
                aug_scale = jnp.float32(1.0)

        def one_table(r):
            g = corpus_blk[r].astype(jnp.float32)
            if metric == "cosine":
                g = g / jnp.maximum(
                    jnp.linalg.norm(g, axis=1, keepdims=True), 1e-30
                )
                s = jnp.zeros((r.shape[0],), jnp.float32)
            else:
                s = jnp.sum(g * g, axis=1)
            if augment:
                # [x, -|x|^2/2, 0-pad]: see models/lsh/index.pack_index
                norm_col = (-s / 2.0)[:, None]
                if quantized:
                    gq = jnp.clip(jnp.round(g / g_scale), -127, 127)
                    nq = jnp.clip(
                        jnp.round(norm_col / (g_scale * aug_scale)), -127, 0
                    )
                    row = jnp.concatenate([gq, nq], axis=1)
                else:
                    row = jnp.concatenate([g, norm_col], axis=1)
                row = jnp.pad(row, ((0, 0), (0, d_aug - d - 1)))
                return (row.astype(dtype), s,
                        jnp.ones((r.shape[0],), jnp.float32))
            if quantized and scale_mode == "global":
                g = jnp.clip(jnp.round(g / g_scale), -127, 127)
                return g.astype(dtype), s, jnp.ones((r.shape[0],), jnp.float32)
            if quantized:
                amax = jnp.max(jnp.abs(g), axis=1, keepdims=True)
                scale = jnp.maximum(amax, 1e-30) / 127.0
                g = jnp.clip(jnp.round(g / scale), -127, 127)
                return g.astype(dtype), s, scale[:, 0]
            return g.astype(dtype), s, jnp.ones((r.shape[0],), jnp.float32)

        packed, sq, scale = jax.lax.map(one_table, rows)
        packed = jnp.pad(packed, ((0, 0), (0, pad), (0, 0)))
        prows = jnp.pad(rows, ((0, 0), (0, pad)), constant_values=n_local)
        out = (packed[None], prows[None])
        if quantized and scale_mode == "global":
            out += (jnp.reshape(g_scale, (1,)).astype(jnp.float32),)
        if augment:
            out += (jnp.reshape(aug_scale, (1,)).astype(jnp.float32),)
        if row_scaled:
            out += (jnp.pad(
                scale, ((0, 0), (0, pad)), constant_values=1.0
            )[None],)
        if metric == "euclidean" and not augment:
            out += (jnp.pad(sq, ((0, 0), (0, pad)))[None],)
        if metric == "euclidean" and has_det:
            det = rest[0][0]              # [L, n_local] fingerprints
            pd = jnp.take_along_axis(det, rows, axis=1)
            out += (jnp.pad(pd, ((0, 0), (0, pad)))[None],)
        return out

    in_specs = [P("mp", None, None), P("mp", None)]
    args = [index.sorted_rows, corpus]
    # outputs, in body's emission order: packed, rows, [gscale], [scale],
    # [sq, [det]]
    fields = ["packed", "packed_rows"]
    out_specs = (P("mp", *([None] * 3)), P("mp", None, None))
    if quantized and scale_mode == "global":
        fields.append("packed_gscale")
        out_specs += (P("mp"),)
    if augment:
        fields.append("packed_aug_scale")
        out_specs += (P("mp"),)
    if row_scaled:
        fields.append("packed_scale")
        out_specs += (P("mp", None, None),)
    if metric == "euclidean" and not augment:
        fields.append("packed_sqnorm")
        out_specs += (P("mp", None, None),)
    if metric == "euclidean" and has_det:
        in_specs.append(P("mp", None, None))
        args.append(index.detailed)
        fields.append("packed_detailed")
        out_specs += (P("mp", None, None),)
    outs = jax.shard_map(
        body, mesh=mesh, in_specs=tuple(in_specs), out_specs=out_specs,
        check_vma=False,
    )(*args)
    return dataclasses.replace(index, **dict(zip(fields, outs)))


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "budget", "per_table", "top_k", "filtered", "block_rows",
        "int8_rerank",
    ),
)
def sharded_retrieve_topk(
    mesh: Mesh,
    index: ShardedLshIndex,
    queries: jax.Array,   # [q, d] (replicated across mp)
    corpus: jax.Array,    # [n, d] row-sharded over "mp"
    budget: int,
    top_k: int,
    per_table: int = 0,
    filtered: bool = True,
    block_rows: int = 128,
    int8_rerank: bool = True,
) -> Tuple[jax.Array, jax.Array]:
    """-> (scores [q, top_k] descending, global row ids [q, top_k], -1 pad).

    Scores are cosine similarity (metric="cosine") or negated distance
    (metric="euclidean") so descending always means nearest-first.

    With a packed index (pack_sharded_index) each shard's leg runs the
    aligned-block packed retrieval instead of random row gathers; the
    all_gather top-k merge is identical.  Scale-free cosine slabs route
    each shard's leg through the windowed slab dots inside the shard_map
    (collectives and the kernel compose).
    """
    metric = index.metric
    fam = index.family
    n_local = index.n_local

    if index.packed is not None:
        quantized = jnp.issubdtype(index.packed.dtype, jnp.integer)
        has_scale = index.packed_scale is not None  # row-scale int8 only
        augmented = index.packed_aug_scale is not None

        if augmented:
            # euclidean augmented slabs: each shard runs the windowed dots
            # on its slabs (rank dot), oversamples 2x, exactly reranks its
            # survivors against its corpus rows (restoring true -distance
            # scores — the augmented rank's precision band, see
            # slabscore.packed_retrieve_pallas_euclid), and the merge
            # compares exact scores across shards.
            from crypto_rec_tpu.ops.pallas.slabscore import (
                packed_retrieve_pallas_euclid,
            )

            def body_aug(packed, prows, starts, gsc, asc, *rest):
                i = 0
                pdet = None
                if filtered and index.packed_detailed is not None:
                    pdet = rest[i][0]
                    i += 1
                corpus_blk = rest[i]
                qh = fam.hash_values(queries)
                qb = fam.bucket_ids_from_hashes(qh, index.n_buckets)
                qd = fam.fingerprints_from_hashes(qh)
                _s, loc_ids = packed_retrieve_pallas_euclid(
                    packed[0], prows[0], pdet, starts[0], n_local,
                    queries.shape[1], queries, qb,
                    qd if filtered else None,
                    gsc[0] if quantized else None, asc[0],
                    2 * top_k, per_table or budget,
                )
                loc_vals, loc_ids = rerank_exact(
                    corpus_blk, metric, queries, loc_ids, top_k
                )
                shard = jax.lax.axis_index("mp")
                gids = jnp.where(loc_ids >= 0, loc_ids + shard * n_local, -1)
                g_vals = jax.lax.all_gather(loc_vals, "mp", axis=1).reshape(
                    queries.shape[0], -1
                )
                g_ids = jax.lax.all_gather(gids, "mp", axis=1).reshape(
                    queries.shape[0], -1
                )
                vals, pos = jax.lax.top_k(g_vals, top_k)
                ids = jnp.take_along_axis(g_ids, pos, axis=1)
                return vals, jnp.where(vals > -jnp.inf, ids, -1)

            in_specs = [
                P("mp", *([None] * 3)), P("mp", None, None),
                P("mp", None, None), P("mp"), P("mp"),
            ]
            gsc_arg = (
                index.packed_gscale if quantized
                else jnp.ones((index.n_shards,), jnp.float32)
            )
            args = [index.packed, index.packed_rows, index.bucket_starts,
                    gsc_arg, index.packed_aug_scale]
            if filtered and index.packed_detailed is not None:
                in_specs.append(P("mp", None, None))
                args.append(index.packed_detailed)
            in_specs.append(P("mp", None))
            args.append(corpus)
            return jax.shard_map(
                body_aug, mesh=mesh, in_specs=tuple(in_specs),
                out_specs=(P(None, None), P(None, None)),
                check_vma=False,
            )(*args)

        use_kernel = metric == "cosine" and not has_scale

        scale_free = (
            quantized and not int8_rerank and index.packed_gscale is not None
        )

        def body_packed(packed, prows, starts, *rest):
            psq = pdet = pscale = gscale = None
            i = 0
            if scale_free:
                gscale = rest[i][0]
                i += 1
            if has_scale:
                pscale = rest[i][0]
                i += 1
            if metric == "euclidean":
                psq = rest[i][0]
                i += 1
                if filtered and index.packed_detailed is not None:
                    pdet = rest[i][0]
                    i += 1
            # corpus is [n, d] sharded over rows -> the block is already
            # [n_local, d] (no leading shard axis to strip)
            corpus_blk = rest[i] if (quantized and not scale_free) else None
            if metric == "cosine":
                qb = fam.bucket_ids(queries)
                qd = None
            else:
                qh = fam.hash_values(queries)
                qb = fam.bucket_ids_from_hashes(qh, index.n_buckets)
                qd = fam.fingerprints_from_hashes(qh)
            core_k = (
                min(4 * top_k, n_local)
                if quantized and not scale_free else top_k
            )
            if use_kernel:
                from crypto_rec_tpu.ops.pallas.slabscore import (
                    packed_retrieve_pallas,
                )

                loc_vals, loc_ids = packed_retrieve_pallas(
                    packed[0], prows[0], None, starts[0], n_local,
                    queries, qb, core_k, per_table or budget,
                )
            else:
                loc_vals, loc_ids = packed_retrieve_core(
                    packed[0], prows[0], psq, pdet, starts[0], n_local,
                    metric, queries, qb, qd, core_k, per_table or budget,
                    block_rows, packed_scale=pscale,
                )
            if scale_free:
                # each shard applies ITS dequant scalar: the scaled dots
                # approximate true sims, so the all_gather merge compares
                # like with like across shards — no rerank gather needed
                loc_vals = loc_vals * gscale
            elif quantized:
                # exact f32 rescoring of the shard-local survivors (see
                # models/lsh/index.rerank_exact): quantization cannot
                # permute the merged global top-k
                loc_vals, loc_ids = rerank_exact(
                    corpus_blk, metric, queries, loc_ids, min(top_k, core_k)
                )
            shard = jax.lax.axis_index("mp")
            gids = jnp.where(loc_ids >= 0, loc_ids + shard * n_local, -1)
            g_vals = jax.lax.all_gather(loc_vals, "mp", axis=1).reshape(
                queries.shape[0], -1
            )
            g_ids = jax.lax.all_gather(gids, "mp", axis=1).reshape(
                queries.shape[0], -1
            )
            vals, pos = jax.lax.top_k(g_vals, top_k)
            ids = jnp.take_along_axis(g_ids, pos, axis=1)
            return vals, jnp.where(vals > -jnp.inf, ids, -1)

        in_specs = [
            P("mp", *([None] * 3)), P("mp", None, None), P("mp", None, None),
        ]
        args = [index.packed, index.packed_rows, index.bucket_starts]
        if scale_free:
            in_specs.append(P("mp"))
            args.append(index.packed_gscale)
        if has_scale:
            in_specs.append(P("mp", None, None))
            args.append(index.packed_scale)
        if metric == "euclidean":
            in_specs.append(P("mp", None, None))
            args.append(index.packed_sqnorm)
            if filtered and index.packed_detailed is not None:
                in_specs.append(P("mp", None, None))
                args.append(index.packed_detailed)
        if quantized and not scale_free:
            in_specs.append(P("mp", None))
            args.append(corpus)
        return jax.shard_map(
            body_packed, mesh=mesh, in_specs=tuple(in_specs),
            out_specs=(P(None, None), P(None, None)),
            check_vma=False,
        )(*args)

    def body(rows, starts, det, corpus_blk):
        # hash queries (replicated tiny compute)
        if metric == "cosine":
            qb = fam.bucket_ids(queries)
            qd = None
        else:
            qh = fam.hash_values(queries)
            qb = fam.bucket_ids_from_hashes(qh, index.n_buckets)
            qd = fam.fingerprints_from_hashes(qh)
        det_l = det[0] if (filtered and det is not None) else None
        local_ids = gather_candidate_ids(
            rows[0], starts[0], det_l, n_local, qb, qd, budget, per_table
        )                                             # [q, budget] local, -1 pad
        valid = local_ids >= 0
        safe = jnp.maximum(local_ids, 0)
        cand = corpus_blk[safe]                       # [q, budget, d]
        if metric == "cosine":
            dots = jnp.einsum(
                "qd,qbd->qb", queries, cand, preferred_element_type=jnp.float32
            )
            qn = jnp.linalg.norm(queries, axis=1, keepdims=True)
            cn = jnp.linalg.norm(cand, axis=2)
            score = dots / jnp.maximum(qn * cn, 1e-30)
        else:
            diff = cand - queries[:, None, :]
            score = -jnp.sqrt(
                jnp.maximum(jnp.sum(diff * diff, axis=-1), 0.0)
            )
        score = jnp.where(valid, score, -jnp.inf)
        loc_vals, slot = jax.lax.top_k(score, top_k)  # [q, top_k]
        loc_ids = jnp.take_along_axis(safe, slot, axis=1)
        shard = jax.lax.axis_index("mp")
        gids = jnp.where(loc_vals > -jnp.inf, loc_ids + shard * n_local, -1)

        g_vals = jax.lax.all_gather(loc_vals, "mp", axis=1).reshape(
            queries.shape[0], -1
        )
        g_ids = jax.lax.all_gather(gids, "mp", axis=1).reshape(
            queries.shape[0], -1
        )
        vals, pos = jax.lax.top_k(g_vals, top_k)
        ids = jnp.take_along_axis(g_ids, pos, axis=1)
        return vals, jnp.where(vals > -jnp.inf, ids, -1)

    det_spec = P("mp", None, None) if index.detailed is not None else None
    in_specs = [P("mp", None, None), P("mp", None, None)]
    args = [index.sorted_rows, index.bucket_starts]
    if index.detailed is not None:
        in_specs.append(det_spec)
        args.append(index.detailed)
    else:
        def body_nodet(rows, starts, corpus_blk):
            return body(rows, starts, None, corpus_blk)
    in_specs.append(P("mp", None))
    args.append(corpus)

    if index.detailed is not None:
        fn = body
    else:
        fn = body_nodet
    return jax.shard_map(
        fn, mesh=mesh, in_specs=tuple(in_specs),
        out_specs=(P(None, None), P(None, None)),
        check_vma=False,
    )(*args)


def shard_corpus(mesh: Mesh, corpus: jax.Array) -> jax.Array:
    return jax.device_put(corpus, NamedSharding(mesh, P("mp", None)))


def _cf_merge_predict(loc_vals, loc_idx, nr_blk, nm_blk, q_ratings,
                      q_known, q_mean, top_p, top_n, n_local, eps, stats):
    """Shared tail of the sharded CF engines (runs INSIDE the shard_map
    body): per-shard top-P (sims + rating rows + means) -> all_gather
    merge -> mean-centered prediction -> top-N unknown coins."""
    loc_valid = loc_vals > -jnp.inf
    sel_r = nr_blk[loc_idx * loc_valid]                # [q, P, c]
    sel_mu = nm_blk[loc_idx * loc_valid]
    shard = jax.lax.axis_index("mp")
    gids = jnp.where(loc_valid, loc_idx + shard * n_local, -1)

    Sn = jax.lax.axis_size("mp")
    qn_ = q_ratings.shape[0]
    g_vals = jax.lax.all_gather(loc_vals, "mp", axis=1).reshape(qn_, -1)
    g_r = jax.lax.all_gather(sel_r, "mp", axis=1).reshape(qn_, Sn * top_p, -1)
    g_mu = jax.lax.all_gather(sel_mu, "mp", axis=1).reshape(qn_, -1)
    g_gid = jax.lax.all_gather(gids, "mp", axis=1).reshape(qn_, -1)

    top_vals, pos = jax.lax.top_k(g_vals, top_p)
    top_valid = top_vals > -jnp.inf
    w = jnp.where(top_valid, top_vals, 0.0)
    top_r = jnp.take_along_axis(g_r, pos[:, :, None], axis=1)
    top_mu = jnp.take_along_axis(g_mu, pos, axis=1)
    top_gid = jnp.take_along_axis(g_gid, pos, axis=1)

    abs_sum = jnp.sum(jnp.abs(w), axis=1)
    centered = (top_r - top_mu[:, :, None]) * top_valid[:, :, None]
    main_sum = jnp.einsum(
        "qp,qpc->qc", w, centered, preferred_element_type=jnp.float32
    )
    delta = main_sum / jnp.maximum(abs_sum, eps)[:, None]
    pred_unknown = q_mean[:, None] + jnp.where(
        (abs_sum > 0.0)[:, None], delta, 0.0
    )
    predicted = jnp.where(q_known, q_ratings, pred_unknown)
    from crypto_rec_tpu.ops.topk import topn_indices

    top = topn_indices(predicted, ~q_known, top_n)
    return (predicted, top, jnp.any(top_valid, axis=1), top_vals,
            top_gid, stats)



@functools.partial(
    jax.jit,
    static_argnames=("mesh", "budget", "per_table", "top_p", "top_n", "filtered"),
)
def sharded_recommend_csr(
    mesh: Mesh,
    index: ShardedLshIndex,
    q_ratings: jax.Array,   # [q, c] replicated
    q_known: jax.Array,     # [q, c]
    q_mean: jax.Array,      # [q]
    n_ratings: jax.Array,   # [n, c] row-sharded over "mp" (the indexed rows)
    n_mean: jax.Array,      # [n]    row-sharded
    budget: int,
    top_p: int,
    top_n: int,
    per_table: int = 0,
    filtered: bool = True,
):
    """Sharded collaborative filtering over the sharded CSR index.

    Per mp shard: local bucket gather -> cosine vs local rating rows ->
    local top-P (weights + the P selected rating rows + means) -> all_gather
    merge -> mean-centered prediction -> top-N unknown coins.  The full CF
    pipeline of models/rec/engine.py at 10^8+-row index scale; collectives
    carry O(top_p * (c + 2)) floats per query.

    Returns (predicted [q, c], top_n [q, top_n], has_neighbors [q],
    sims [q, top_p], global neighbor ids [q, top_p], stats).

    `stats` is the truncation accounting the budget would otherwise hide
    (the "no silent truncation" contract of models/ivf.py applied to the
    sharded CF engine): int32 scalars summed over queries AND shards —
    unique_candidates gathered, budget_dropped (distinct rows the
    per-shard budget discarded), window_dropped (bucket members beyond
    the per-table window); plus ici_bytes_per_query, the all_gather merge
    traffic (S * top_p * 4 * (c + 3) bytes — measured form of SCALE.md's
    O(P * (c + 2)) claim).
    """
    metric = index.metric
    fam = index.family
    n_local = index.n_local
    eps = 1e-30

    def body(rows, starts, det, nr_blk, nm_blk):
        if metric == "cosine":
            qb = fam.bucket_ids(q_ratings)
            qd = None
        else:
            qh = fam.hash_values(q_ratings)
            qb = fam.bucket_ids_from_hashes(qh, index.n_buckets)
            qd = fam.fingerprints_from_hashes(qh)
        det_l = det[0] if (filtered and det is not None) else None
        local_ids, trunc = gather_candidate_ids(
            rows[0], starts[0], det_l, n_local, qb, qd, budget, per_table,
            with_stats=True,
        )
        # truncation accounting: sum over this shard's queries, then over
        # shards — O(1) extra collective payload
        stats = {
            k: jax.lax.psum(jnp.sum(v), "mp") for k, v in trunc.items()
        }
        valid = local_ids >= 0
        safe = jnp.maximum(local_ids, 0)
        cand = nr_blk[safe]                                # [q, B, c]
        dots = jnp.einsum(
            "qc,qbc->qb", q_ratings, cand, preferred_element_type=jnp.float32
        )
        qn = jnp.linalg.norm(q_ratings, axis=1, keepdims=True)
        cn = jnp.linalg.norm(cand, axis=2)
        sims = jnp.where(valid, dots / jnp.maximum(qn * cn, eps), -jnp.inf)

        loc_vals, slot = jax.lax.top_k(sims, top_p)
        loc_idx = jnp.take_along_axis(safe, slot, axis=1)
        return _cf_merge_predict(
            loc_vals, loc_idx, nr_blk, nm_blk, q_ratings, q_known, q_mean,
            top_p, top_n, n_local, eps, stats,
        )

    in_specs = [P("mp", None, None), P("mp", None, None)]
    args = [index.sorted_rows, index.bucket_starts]
    if index.detailed is not None:
        in_specs.append(P("mp", None, None))
        args.append(index.detailed)
        fn = body
    else:
        def fn(rows, starts, nr_blk, nm_blk):
            return body(rows, starts, None, nr_blk, nm_blk)
    in_specs += [P("mp", None), P("mp")]
    args += [n_ratings, n_mean]
    stats_spec = {
        "unique_candidates": P(), "budget_dropped": P(), "window_dropped": P()
    }
    *outs, stats = jax.shard_map(
        fn, mesh=mesh, in_specs=tuple(in_specs),
        out_specs=(P(None, None),) * 2 + (P(None),) + (P(None, None),) * 2
        + (stats_spec,),
        check_vma=False,
    )(*args)
    # interconnect accounting (static shapes, SCALE.md's O(P*(c+2)) merge claim):
    # the all_gather merge moves, per query per shard, top_p entries of
    # (c rating floats + 1 sim + 1 mean) f32 plus 1 int32 global id.
    S_ = mesh.shape["mp"]
    c_ = q_ratings.shape[1]
    stats["ici_bytes_per_query"] = float(S_ * top_p * 4 * (c_ + 3))
    return (*outs, stats)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "per_table", "top_p", "top_n"),
)
def sharded_recommend_scored(
    mesh: Mesh,
    index: ShardedLshIndex,
    q_ratings: jax.Array,   # [q, c] replicated
    q_known: jax.Array,     # [q, c]
    q_mean: jax.Array,      # [q]
    n_ratings: jax.Array,   # [n, c] row-sharded over "mp" (the indexed rows)
    n_mean: jax.Array,      # [n]    row-sharded
    top_p: int,
    top_n: int,
    per_table: int = 256,
):
    """Sharded CF over the SCORED candidate engine: each mp shard runs the
    windowed slab dots on its packed slabs and selects its
    local top-P neighbors directly (slab_topk's per-table stage 1) — no
    budget-wide candidate set, no per-query dedup-rank sort.  The merge +
    mean-centered prediction tail is shared with sharded_recommend_csr.

    This is the engine the single-card CF path rides (retrieval +
    recommend_topk_retrieved), composed with the mp sharding: per-shard sims are
    cosine (slabs are pre-normalized; int8 global-scale dots are
    dequantized by the shard's own scalar before the merge, the
    pack_sharded_index contract).  The count-ranked csr engine stays as
    the reference-semantics path.

    AUGMENTED euclidean shards (pack_sharded_index augment=True) are also
    accepted: each shard's windowed dots rank its windows
    by the monotone euclidean rank dot, keeps 4*top_p survivors, rescores
    just those rows with exact COSINE similarity (matching the CF weighting
    of sharded_recommend_csr, whose euclidean path also weighs by cosine —
    the reference's get_P_closest is cosine regardless of the index metric,
    /root/reference/lib/crypto_rec.hpp:213-231), and selects its local
    top-P by cosine before the shared merge.

    Returns (predicted [q, c], top_n [q, top_n], has_neighbors [q],
    sims [q, top_p], global neighbor ids [q, top_p], stats).  The array
    outputs match sharded_recommend_csr; the stats dict does NOT — the csr
    engine reports per-query int32 vectors, while this engine's windows are
    not per-query attributable after the kernel, so its keys are scalar
    TOTALS summed over all queries and tables and are named *_total:
      scanned_total        — slab rows the kernel scored;
      window_dropped_total — bucket members beyond the per-table window.
    (No budget stage exists here, so nothing analogous to budget_dropped.)
    stats also carries ici_bytes_per_query, the all_gather merge traffic
    (same merge as the csr engine: S * top_p * 4 * (c + 3) bytes).
    """
    from crypto_rec_tpu.ops.pallas.slabscore import (
        slab_window_dots, slab_topk,
    )

    if index.packed is None:
        raise ValueError("sharded_recommend_scored requires packed shards")
    euclid_aug = (
        index.metric == "euclidean" and index.packed_aug_scale is not None
    )
    if not (index.metric == "cosine" or euclid_aug) \
            or index.packed_scale is not None:
        raise ValueError(
            "scored CF rides the windowed slab dots: cosine scale-free "
            "slabs or augmented euclidean shards only"
        )
    fam = index.family
    n_local = index.n_local
    quantized = jnp.issubdtype(index.packed.dtype, jnp.integer)
    eps = 1e-30
    L = index.sorted_rows.shape[1]
    has_fp = euclid_aug and index.packed_detailed is not None

    def body(packed, prows, starts, gsc, asc, pdet, nr_blk, nm_blk):
        l_idx = jnp.arange(L, dtype=jnp.int32)
        if euclid_aug:
            qh = fam.hash_values(q_ratings)
            qb = fam.bucket_ids_from_hashes(qh, index.n_buckets)
            qd = fam.fingerprints_from_hashes(qh)
        else:
            qb = fam.bucket_ids(q_ratings)
            qd = None
        b0 = starts[0][l_idx[None, :], qb]
        b1 = starts[0][l_idx[None, :], qb + 1]
        size = b1 - b0
        if has_fp:
            from crypto_rec_tpu.models.lsh.index import _fp_run_starts

            n_pad = prows.shape[2]
            flat_fp = pdet[0].reshape(-1)
            base = l_idx[None, :] * n_pad
            s0 = _fp_run_starts(
                lambda p: flat_fp[base + p], b0, b1, qd, n_pad
            )
        else:
            golden = jnp.int32(-1640531527)
            mix = (qb * golden) ^ (l_idx[None, :] * jnp.int32(40503))
            s0 = b0 + jnp.remainder(
                jnp.abs(mix), jnp.maximum(size - per_table, 0) + 1
            )
        sizes = jnp.minimum(b1 - s0, per_table)
        qv = q_ratings.astype(jnp.float32)
        if euclid_aug:
            d = q_ratings.shape[1]
            d_aug = packed.shape[-1]
            qv = jnp.concatenate(
                [
                    qv,
                    jnp.broadcast_to(asc[0].astype(jnp.float32)[None],
                                     (qv.shape[0], 1)),
                    jnp.zeros((qv.shape[0], d_aug - d - 1), jnp.float32),
                ],
                axis=1,
            )
        else:
            qv = qv / jnp.maximum(
                jnp.linalg.norm(qv, axis=1, keepdims=True), eps
            )
        dots, a0 = slab_window_dots(
            packed[0], None, s0, sizes, qv, per_table=per_table,
            mask=False,
        )
        if euclid_aug:
            # the dots rank by the euclidean rank dot; keep 4*top_p
            # survivors, rescore them with exact cosine (the CF weighting
            # of the csr engine) and select the local top-P by cosine
            m = min(4 * top_p, L * per_table)
            rank_vals, cand_idx = slab_topk(
                dots, a0, prows[0], n_local, m, exact=False
            )
            cvalid = cand_idx >= 0
            safe = jnp.maximum(cand_idx, 0)
            cand = nr_blk[safe]                        # [q, m, c]
            cdots = jnp.einsum(
                "qc,qmc->qm", q_ratings, cand,
                preferred_element_type=jnp.float32,
            )
            qn = jnp.linalg.norm(q_ratings, axis=1, keepdims=True)
            cn = jnp.linalg.norm(cand, axis=2)
            sims = jnp.where(
                cvalid, cdots / jnp.maximum(qn * cn, eps), -jnp.inf
            )
            loc_vals, slot = jax.lax.top_k(sims, top_p)
            loc_idx = jnp.take_along_axis(safe, slot, axis=1)
        else:
            loc_vals, loc_idx = slab_topk(
                dots, a0, prows[0], n_local, top_p, exact=False
            )
            if quantized:
                # per-shard dequant BEFORE the merge (pack_sharded_index)
                loc_vals = loc_vals * gsc[0]
            loc_idx = jnp.maximum(loc_idx, 0)
        stats = {
            "scanned_total": jax.lax.psum(
                jnp.sum(jnp.minimum(size, per_table)), "mp"),
            "window_dropped_total": jax.lax.psum(
                jnp.sum(jnp.maximum(size - per_table, 0)), "mp"),
        }
        return _cf_merge_predict(
            loc_vals, loc_idx, nr_blk, nm_blk, q_ratings, q_known, q_mean,
            top_p, top_n, n_local, eps, stats,
        )

    gsc_arg = (
        index.packed_gscale if quantized
        else jnp.ones((index.n_shards,), jnp.float32)
    )
    asc_arg = (
        index.packed_aug_scale if euclid_aug
        else jnp.ones((index.n_shards,), jnp.float32)
    )
    pdet_arg = (
        index.packed_detailed if has_fp
        else index.packed_rows  # placeholder, unread
    )
    in_specs = (
        P("mp", None, None, None), P("mp", None, None),
        P("mp", None, None), P("mp"), P("mp"), P("mp", None, None),
        P("mp", None), P("mp"),
    )
    stats_spec = {"scanned_total": P(), "window_dropped_total": P()}
    *outs, stats = jax.shard_map(
        body, mesh=mesh, in_specs=in_specs,
        out_specs=(P(None, None),) * 2 + (P(None),) + (P(None, None),) * 2
        + (stats_spec,),
        check_vma=False,
    )(index.packed, index.packed_rows, index.bucket_starts, gsc_arg,
      asc_arg, pdet_arg, n_ratings, n_mean)
    # same all_gather merge as the csr engine -> same interconnect bytes per query
    stats["ici_bytes_per_query"] = float(
        mesh.shape["mp"] * top_p * 4 * (q_ratings.shape[1] + 3)
    )
    return (*outs, stats)
