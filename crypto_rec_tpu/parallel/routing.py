"""All-to-all bucket routing: queries travel to the shards that own their
LSH buckets; scores travel back.

This is the "all-to-all lookup exchange" leg of BASELINE.json: instead of
every shard seeing every query (the all_gather merge in parallel/sharded.py,
fine when P*(c+2) is small), the corpus is partitioned by bucket ownership —
owner(row) = primary_bucket(row) mod S — and a query visits only the shards
that own one of its L buckets.  The exchange is two `jax.lax.all_to_all`s
(queries out, top-k results back) with a fixed per-destination capacity so
shapes stay static; overflow beyond the capacity is dropped and accounted
for by the recall oracle.

Pipeline per shard (shard_map over a 1-D "mp" mesh):
  1. compact local queries per destination into [S, cap] slot tables;
  2. all_to_all the [S, cap, d] query buffer (interconnect);
  3. score received queries against the resident rows, local top-k;
  4. all_to_all the [S, cap, k] (score, global-row-id) results back;
  5. scatter results to the originating slots and merge the <=S partial
     top-k lists per query.

Two interiors for step 3:
  * "csr" (production): each shard carries a CSR bucket table over ITS
    resident rows (build_routed_index — the partition itself is a
    device-side sort, no host loop), so a received query gathers only its
    bucket windows and scores O(budget) rows — the distributed analog of
    the reference's direct bucket fetch
    (/root/reference/lib/data_structures/cust_hashtable.hpp:106-113);
  * "dense" (oracle/testing): brute-force against every resident row —
    O(n_resident) per query, recall-maximal, used as the parity oracle
    for the csr interior at toy scale.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from crypto_rec_tpu.ops.distances import pairwise_distances


def _compact_slots(dest_mask: jax.Array, cap: int) -> Tuple[jax.Array, jax.Array]:
    """[q_loc, S] bool -> (slots [S, cap] local query ids, valid [S, cap]).

    Stable compaction by sort: for each destination, the ids of the queries
    that want it, front-packed, truncated to cap.
    """
    q_loc, S = dest_mask.shape
    ids = jnp.broadcast_to(jnp.arange(q_loc, dtype=jnp.int32)[:, None], (q_loc, S))
    # sort key: wanted queries first, preserving id order
    key = jnp.where(dest_mask, ids, q_loc)
    sorted_key = jnp.sort(key, axis=0).T           # [S, q_loc]
    if cap > q_loc:  # pad with the "empty" sentinel
        sorted_key = jnp.pad(
            sorted_key, ((0, 0), (0, cap - q_loc)), constant_values=q_loc
        )
    slots = sorted_key[:, :cap]
    valid = slots < q_loc
    return jnp.where(valid, slots, 0), valid


def _return_and_merge(neg_vals, gids, slots, valid, S, cap, k, q_loc):
    """Steps 4-5 of the exchange, shared by both interiors: all_to_all the
    per-destination (score, gid) results back, scatter them to the
    originating query slots, dedup across shards (a row may be resident on
    several shards under bucket-union ownership) and merge the <=S partial
    top-k lists per query."""
    back_vals = jax.lax.all_to_all(
        neg_vals.reshape(S, cap, k), "mp", 0, 0, tiled=False
    )                                                      # [S, cap, k]
    back_gids = jax.lax.all_to_all(
        gids.reshape(S, cap, k), "mp", 0, 0, tiled=False
    )

    # scatter back: query slots[s, c] owns back_*[s, c, :].  Invalid
    # capacity slots write into a dump row (q_loc) so they can never
    # clobber a real query's results.
    all_vals = jnp.full((q_loc + 1, S, k), -jnp.inf, jnp.float32)
    all_gids = jnp.full((q_loc + 1, S, k), -1, jnp.int32)
    s_idx = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[:, None], (S, cap))
    flat_slots = jnp.where(valid, slots, q_loc).reshape(-1)
    flat_s = s_idx.reshape(-1)
    all_vals = all_vals.at[flat_slots, flat_s].set(back_vals.reshape(-1, k))
    all_gids = all_gids.at[flat_slots, flat_s].set(back_gids.reshape(-1, k))
    all_vals = all_vals[:q_loc].reshape(q_loc, S * k)
    all_gids = all_gids[:q_loc].reshape(q_loc, S * k)

    # payload sort instead of argsort + gathers (see
    # slabscore._dedup_topk_pairs)
    g_sorted, v_sorted = jax.lax.sort((all_gids, all_vals), num_keys=1)
    dup = jnp.concatenate(
        [
            jnp.zeros((q_loc, 1), bool),
            (g_sorted[:, 1:] == g_sorted[:, :-1]) & (g_sorted[:, 1:] >= 0),
        ],
        axis=1,
    )
    v_sorted = jnp.where(dup, -jnp.inf, v_sorted)
    merged_vals, pos = jax.lax.top_k(v_sorted, k)
    merged_gids = jnp.take_along_axis(g_sorted, pos, axis=1)
    merged_gids = jnp.where(merged_vals > -jnp.inf, merged_gids, -1)
    return merged_vals, merged_gids


@functools.partial(
    jax.jit, static_argnames=("mesh", "metric", "k", "cap")
)
def route_queries_by_bucket(
    mesh: Mesh,
    queries: jax.Array,     # [q, d] sharded over "mp"
    dest_mask: jax.Array,   # [q, S] bool: query q must visit shard s
    corpus: jax.Array,      # [n, d] bucket-partitioned, sharded over "mp"
    row_ids: jax.Array,     # [n] int32 global row ids, sharded over "mp"
    metric: str,
    k: int,
    cap: int,
) -> Tuple[jax.Array, jax.Array]:
    """-> (neg_dist_topk [q, k] descending, global_row_ids [q, k], -1 pad).

    Scores are negated distances so "descending" means nearest-first.
    """
    S = mesh.shape["mp"]

    def body(q_blk, dmask, corpus_blk, rid_blk):
        q_loc = q_blk.shape[0]
        slots, valid = _compact_slots(dmask, cap)              # [S, cap]
        send_q = q_blk[slots] * valid[:, :, None]              # [S, cap, d]

        recv_q = jax.lax.all_to_all(send_q, "mp", 0, 0, tiled=False)
        recv_valid = jax.lax.all_to_all(valid, "mp", 0, 0, tiled=False)
        recv_q = recv_q.reshape(S * cap, -1)

        # local scoring: nearest k rows of this corpus shard.  Pad slots
        # (rid < 0, bucket-partition fill rows) must never win a top-k slot.
        d = pairwise_distances(recv_q, corpus_blk, metric)     # [S*cap, n_loc]
        d = jnp.where(rid_blk[None, :] >= 0, d, jnp.inf)
        neg_vals, idx = jax.lax.top_k(-d, k)                   # descending
        gids = rid_blk[idx]                                    # [S*cap, k]
        neg_vals = jnp.where(
            recv_valid.reshape(-1)[:, None], neg_vals, -jnp.inf
        )
        gids = jnp.where(recv_valid.reshape(-1)[:, None], gids, -1)

        return _return_and_merge(neg_vals, gids, slots, valid, S, cap, k, q_loc)

    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P("mp", None), P("mp", None), P("mp", None), P("mp")),
        out_specs=(P("mp", None), P("mp", None)),
        check_vma=False,
    )(queries, dest_mask, corpus, row_ids)


def partition_corpus_by_bucket(bucket_ids, n_shards: int):
    """Host-side bucket-ownership partition: owner_l(row) = bucket_ids[row, l]
    mod S, and shard s stores the DEDUPLICATED UNION over tables of the rows
    it owns.  Any row that collides with a query in ANY of the L tables is
    therefore resident on a shard that query visits (bucket_dest_mask), which
    is what gives the routed path the full L-table LSH recall — the
    distributed analog of the reference's per-table bucket fetch + std::set
    union (/root/reference/lib/lsh_cube.hpp:77-106).

    Returns (slot_rows [S*cap] int64 gather indices into the original corpus,
    row_ids [S*cap] int32 global ids with -1 marking pad slots, cap).  Pad
    slots repeat row 0 but carry row_id -1; route_queries_by_bucket masks
    them out of local top-k.  Expected replication factor is <= L (exactly
    the L-fold replication the packed-slab layout already pays on one chip).
    """
    import numpy as np

    b = np.asarray(bucket_ids)                       # [n, L]
    owners = b % n_shards                            # [n, L]
    members = [
        np.nonzero((owners == s).any(axis=1))[0] for s in range(n_shards)
    ]
    cap = max(1, max(len(m) for m in members))
    row_ids = -np.ones((n_shards, cap), np.int32)
    slot_rows = np.zeros((n_shards, cap), np.int64)
    for s, rows in enumerate(members):
        row_ids[s, : len(rows)] = rows
        slot_rows[s, : len(rows)] = rows
    return slot_rows.reshape(-1), row_ids.reshape(-1), cap


@functools.partial(jax.jit, static_argnames=("n_shards", "cap_r"))
def partition_corpus_by_bucket_device(
    bucket_ids: jax.Array,  # [n, L]
    n_shards: int,
    cap_r: int,
):
    """Device-side bucket-ownership partition — the sort-based replacement
    for the host numpy loop (VERDICT r2 missing #3).

    owner_l(row) = bucket_ids[row, l] mod S; shard s stores the DEDUPED
    union over tables of the rows it owns.  One two-key lax.sort over the
    [n*L] (owner, row) pairs marks (owner, row) duplicates, a second sort
    front-packs the survivors per owner, and searchsorted finds the
    per-shard runs — the same CSR-by-sort trick as
    models/lsh/index._csr_from_buckets, applied to owner ids.

    -> (resident [S, cap_r] int32 row ids (-1 pad), counts [S],
        overflow [S] rows dropped beyond cap_r per shard).
    """
    n, L = bucket_ids.shape
    owners = (bucket_ids % n_shards).astype(jnp.int32)
    rows = jnp.broadcast_to(
        jnp.arange(n, dtype=jnp.int32)[:, None], (n, L)
    )
    o_s, r_s = jax.lax.sort(
        (owners.reshape(-1), rows.reshape(-1)), num_keys=2
    )
    dup = jnp.concatenate(
        [jnp.zeros((1,), bool), (o_s[1:] == o_s[:-1]) & (r_s[1:] == r_s[:-1])]
    )
    o_s = jnp.where(dup, n_shards, o_s)          # sentinel owner sorts last
    o_s, r_s = jax.lax.sort((o_s, r_s), num_keys=2)
    starts = jnp.searchsorted(
        o_s, jnp.arange(n_shards + 1, dtype=jnp.int32), side="left"
    ).astype(jnp.int32)
    counts = starts[1:] - starts[:-1]
    offs = starts[:-1][:, None] + jnp.arange(cap_r, dtype=jnp.int32)[None, :]
    vals = r_s[jnp.minimum(offs, n * L - 1)]
    valid = jnp.arange(cap_r, dtype=jnp.int32)[None, :] < counts[:, None]
    resident = jnp.where(valid, vals, -1)
    return resident, counts, jnp.maximum(counts - cap_r, 0)


@functools.partial(jax.jit, static_argnames=("n_shards",))
def _partition_counts(bucket_ids: jax.Array, n_shards: int) -> jax.Array:
    """Per-shard resident-row counts of the bucket-ownership partition —
    a cheap first pass so callers can size cap_r before partitioning."""
    n, L = bucket_ids.shape
    owners = (bucket_ids % n_shards).astype(jnp.int32)
    rows = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[:, None], (n, L))
    o_s, r_s = jax.lax.sort((owners.reshape(-1), rows.reshape(-1)), num_keys=2)
    dup = jnp.concatenate(
        [jnp.zeros((1,), bool), (o_s[1:] == o_s[:-1]) & (r_s[1:] == r_s[:-1])]
    )
    keep = (~dup)[:, None] & (
        o_s[:, None] == jnp.arange(n_shards, dtype=jnp.int32)[None, :]
    )
    return jnp.sum(keep, axis=0, dtype=jnp.int32)


@dataclasses.dataclass
class RoutedIndex:
    """Bucket-owner-partitioned corpus + per-shard CSR over resident rows.

    All leading-S arrays are placed with P("mp", ...); `local` CSR row ids
    index into the resident arrays (positions 0..cap_r-1), and
    resident_gids maps them back to global corpus rows (-1 on pad slots).
    bucket_starts spans n_buckets + 1 buckets: bucket n_buckets holds the
    pad slots so real query buckets can never gather them."""

    metric: str
    n_buckets: int
    cap_r: int
    resident_gids: jax.Array   # [S * cap_r] int32 global ids, -1 pad
    part_corpus: jax.Array     # [S * cap_r, d]
    sorted_rows: jax.Array     # [S, L, cap_r] local CSR member positions
    bucket_starts: jax.Array   # [S, L, n_buckets + 2]
    detailed: Optional[jax.Array]  # [S, L, cap_r] fingerprints or None
    stats: dict


def build_routed_index(
    mesh: Mesh,
    index,                   # LshIndex over `corpus`
    corpus: jax.Array,       # [n, d]
    cap_r: int = 0,
) -> RoutedIndex:
    """Partition the corpus by bucket ownership (device-side sort) and give
    every shard a CSR bucket table over its resident rows, so the routed
    leg can gather bucket windows instead of scanning the whole shard.

    cap_r = resident capacity per shard; 0 => sized to the actual max
    (one light device pass + a host read), rounded up to a 128 multiple.
    """
    from jax.sharding import NamedSharding
    from crypto_rec_tpu.models.lsh.index import _csr_from_buckets

    S = mesh.shape["mp"]
    n, d = corpus.shape
    counts = _partition_counts(index.bucket_ids, S)
    max_count = int(jax.device_get(jnp.max(counts)))
    if cap_r <= 0:
        cap_r = -(-max_count // 128) * 128
    resident, counts, overflow = partition_corpus_by_bucket_device(
        index.bucket_ids, S, cap_r
    )                                                    # [S, cap_r]
    safe = jnp.maximum(resident, 0)
    part_corpus = corpus[safe.reshape(-1)]               # [S * cap_r, d]
    # resident bucket ids; pad slots get the sentinel bucket n_buckets so
    # the per-shard CSR isolates them past every real bucket
    b_res = index.bucket_ids[safe]                       # [S, cap_r, L]
    b_res = jnp.where(resident[:, :, None] >= 0, b_res, index.n_buckets)
    det_res = None
    if index.detailed is not None:
        det_res = jnp.transpose(
            index.detailed[:, safe], (1, 0, 2)
        )                                                # [S, L, cap_r]

    nb = index.n_buckets

    def body(b_blk, *rest):
        det = rest[0][0].T if rest else None             # [cap_r, L]
        rows, starts = _csr_from_buckets(
            b_blk[0], nb + 1, secondary=det
        )
        out = (rows[None], starts[None])
        if rest:
            # fingerprint plane stays in resident-position order —
            # gather_candidate_ids indexes it by row id (detailed[l, row])
            out += (rest[0][0][None],)
        return out

    in_specs = [P("mp", None, None)]
    args = [b_res]
    out_specs = (P("mp", None, None), P("mp", None, None))
    if det_res is not None:
        in_specs.append(P("mp", None, None))
        args.append(det_res)
        out_specs += (P("mp", None, None),)
    outs = jax.shard_map(
        body, mesh=mesh, in_specs=tuple(in_specs), out_specs=out_specs,
        check_vma=False,
    )(*args)
    gids = resident.reshape(-1)
    mp = NamedSharding(mesh, P("mp"))
    stats = {
        "resident_rows_per_shard": cap_r,
        "max_resident_rows": max_count,
        "partition_overflow_rows": int(jax.device_get(jnp.sum(overflow))),
        "replication_factor": round(
            float(jax.device_get(jnp.sum(counts))) / max(1, n), 3
        ),
    }
    return RoutedIndex(
        metric=index.metric,
        n_buckets=nb,
        cap_r=cap_r,
        resident_gids=jax.device_put(gids, mp),
        part_corpus=jax.device_put(
            part_corpus, NamedSharding(mesh, P("mp", None))
        ),
        sorted_rows=outs[0],
        bucket_starts=outs[1],
        detailed=outs[2] if det_res is not None else None,
        stats=stats,
    )


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "metric", "k", "cap", "budget", "per_table",
                     "n_buckets", "cap_r", "has_detailed"),
)
def route_queries_by_bucket_csr(
    mesh: Mesh,
    queries: jax.Array,      # [q, d] sharded over "mp"
    q_buckets: jax.Array,    # [q, L] int32, sharded over "mp"
    q_detailed,              # [q, L] fingerprints or None
    dest_mask: jax.Array,    # [q, S] bool
    sorted_rows: jax.Array,  # [S, L, cap_r] resident CSR
    bucket_starts: jax.Array,  # [S, L, nb + 2]
    detailed,                # [S, L, cap_r] or None
    part_corpus: jax.Array,  # [S * cap_r, d]
    resident_gids: jax.Array,  # [S * cap_r]
    metric: str,
    k: int,
    cap: int,
    budget: int,
    per_table: int,
    n_buckets: int,
    cap_r: int,
    has_detailed: bool,
) -> Tuple[jax.Array, jax.Array]:
    """The csr interior: queries travel WITH their bucket ids (and
    euclidean fingerprints), and each destination shard gathers only the
    query's bucket windows from its resident CSR — O(budget) scored rows
    per received query instead of O(cap_r)."""
    from crypto_rec_tpu.models.lsh.index import gather_candidate_ids

    S = mesh.shape["mp"]
    L = q_buckets.shape[1]
    if q_detailed is None:
        q_detailed = jnp.zeros_like(q_buckets)

    def body(q_blk, qb_blk, qd_blk, dmask, rows, starts, det, pc_blk, gid_blk):
        q_loc = q_blk.shape[0]
        slots, valid = _compact_slots(dmask, cap)              # [S, cap]
        send_q = q_blk[slots] * valid[:, :, None]              # [S, cap, d]
        send_qb = jnp.where(valid[:, :, None], qb_blk[slots], 0)
        send_qd = jnp.where(valid[:, :, None], qd_blk[slots], 0)

        recv_q = jax.lax.all_to_all(send_q, "mp", 0, 0, tiled=False)
        recv_qb = jax.lax.all_to_all(send_qb, "mp", 0, 0, tiled=False)
        recv_qd = jax.lax.all_to_all(send_qd, "mp", 0, 0, tiled=False)
        recv_valid = jax.lax.all_to_all(valid, "mp", 0, 0, tiled=False)
        recv_q = recv_q.reshape(S * cap, -1)
        recv_qb = recv_qb.reshape(S * cap, L)
        recv_qd = recv_qd.reshape(S * cap, L)

        det_l = det[0] if has_detailed else None
        local_ids = gather_candidate_ids(
            rows[0], starts[0], det_l, cap_r, recv_qb,
            recv_qd if has_detailed else None, budget, per_table,
        )                                               # [S*cap, budget]
        valid_c = local_ids >= 0
        safe = jnp.maximum(local_ids, 0)
        cand = pc_blk[safe]                             # [S*cap, budget, d]
        if metric == "cosine":
            dots = jnp.einsum(
                "qd,qbd->qb", recv_q, cand,
                preferred_element_type=jnp.float32,
            )
            qn = jnp.linalg.norm(recv_q, axis=1, keepdims=True)
            cn = jnp.linalg.norm(cand, axis=2)
            dist = 1.0 - dots / jnp.maximum(qn * cn, 1e-30)
        else:
            diff = cand - recv_q[:, None, :]
            dist = jnp.sqrt(jnp.maximum(jnp.sum(diff * diff, axis=2), 0.0))
        dist = jnp.where(valid_c, dist, jnp.inf)
        neg_vals, pos = jax.lax.top_k(-dist, k)         # [S*cap, k]
        cand_pos = jnp.take_along_axis(safe, pos, axis=1)
        gids = gid_blk[cand_pos]                        # [S*cap, k]
        ok = recv_valid.reshape(-1)[:, None] & (neg_vals > -jnp.inf)
        neg_vals = jnp.where(ok, neg_vals, -jnp.inf)
        gids = jnp.where(ok, gids, -1)
        return _return_and_merge(neg_vals, gids, slots, valid, S, cap, k, q_loc)

    det_arg = detailed if has_detailed else sorted_rows  # placeholder
    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(
            P("mp", None), P("mp", None), P("mp", None), P("mp", None),
            P("mp", None, None), P("mp", None, None), P("mp", None, None),
            P("mp", None), P("mp"),
        ),
        out_specs=(P("mp", None), P("mp", None)),
        check_vma=False,
    )(queries, q_buckets, q_detailed, dest_mask, sorted_rows, bucket_starts,
      det_arg, part_corpus, resident_gids)


def bucket_dest_mask(q_buckets, n_shards: int) -> jax.Array:
    """[q, L] query bucket ids -> [q, S] bool destination mask: query q
    visits shard s iff s owns one of q's L buckets (mod-S ownership,
    matching partition_corpus_by_bucket)."""
    owners = q_buckets % n_shards                    # [q, L]
    shards = jnp.arange(n_shards, dtype=owners.dtype)
    return jnp.any(owners[:, :, None] == shards[None, None, :], axis=1)


def routing_overflow(dest_mask, n_shards: int, cap: int):
    """Capacity accounting for route_queries_by_bucket: per source shard and
    destination, requests beyond `cap` are dropped by _compact_slots.
    Returns (dropped_requests, total_requests)."""
    import numpy as np

    dm = np.asarray(dest_mask)
    q = dm.shape[0]
    q_loc = q // n_shards
    dropped = 0
    for src in range(n_shards):
        counts = dm[src * q_loc: (src + 1) * q_loc].sum(axis=0)
        dropped += int(np.maximum(counts - cap, 0).sum())
    return dropped, int(dm.sum())


def routed_retrieve_topk(
    mesh: Mesh,
    index,                  # LshIndex over `corpus` (models/lsh/index.py)
    queries: jax.Array,     # [q, d]
    corpus: jax.Array,      # [n, d] — the rows the index was built over
    top_k: int,
    cap: int = 0,
    interior: str = "csr",
    budget: int = 0,
    per_table: int = 0,
    routed: Optional[RoutedIndex] = None,
):
    """BASELINE.json's "all-to-all lookup exchange", end to end: the corpus
    is partitioned by LSH bucket ownership (device-side sort), each query
    travels (all_to_all) only to the <=L shards that own one of its
    buckets, is scored against the resident rows there, and the per-shard
    top-k merge travels back.

    interior="csr" (default): each destination shard gathers only the
    query's bucket windows from its resident CSR (budget rows per query —
    default 16*top_k); "dense" brute-forces the whole resident shard (the
    recall-maximal oracle for tests).  Pass a prebuilt `routed` index
    (build_routed_index) to amortize the partition across query batches.

    -> (scores [q, top_k] descending nearest-first, global row ids [q, top_k]
        with -1 pads, stats dict with overflow/replication accounting).

    cap = per-(source, destination) query capacity; 0 => q // S (no overflow
    possible).  Smaller caps trade interconnect bandwidth for dropped requests, which
    `stats` quantifies and the recall oracle measures.
    """
    import numpy as np

    from crypto_rec_tpu.models.lsh.index import query_hashes

    S = mesh.shape["mp"]
    q, d = queries.shape
    pad_q = (-q) % S
    queries_p = jnp.pad(queries, ((0, pad_q), (0, 0)))

    q_buckets, q_detailed = query_hashes(index, queries)
    dest = bucket_dest_mask(q_buckets, S)
    dest = jnp.pad(dest, ((0, pad_q), (0, 0)))       # pad queries visit nobody

    cap = cap or (q + pad_q) // S
    if interior == "csr":
        if routed is None:
            routed = build_routed_index(mesh, index, corpus)
        budget = budget or 16 * top_k
        qb_p = jnp.pad(q_buckets, ((0, pad_q), (0, 0)))
        qd_p = (
            jnp.pad(q_detailed, ((0, pad_q), (0, 0)))
            if q_detailed is not None else None
        )
        vals, gids = route_queries_by_bucket_csr(
            mesh, queries_p, qb_p, qd_p, dest,
            routed.sorted_rows, routed.bucket_starts, routed.detailed,
            routed.part_corpus, routed.resident_gids,
            index.metric, top_k, cap, budget, per_table or budget,
            routed.n_buckets, routed.cap_r,
            has_detailed=routed.detailed is not None,
        )
        part_stats = dict(routed.stats)
    elif interior == "dense":
        slot_rows, row_ids, corpus_cap = partition_corpus_by_bucket(
            index.bucket_ids, S
        )
        part_corpus = corpus[slot_rows]              # [S * corpus_cap, d]
        vals, gids = route_queries_by_bucket(
            mesh, queries_p, dest, part_corpus,
            jnp.asarray(row_ids), index.metric, top_k, cap,
        )
        part_stats = {
            "resident_rows_per_shard": int(corpus_cap),
            "replication_factor": round(
                S * corpus_cap / max(1, corpus.shape[0]), 3
            ),
        }
    else:
        raise ValueError(f"unknown interior {interior!r} (csr | dense)")
    dropped, total = routing_overflow(dest, S, cap)
    mean_dest = float(np.asarray(dest).sum() / max(1, q))
    # interconnect traffic accounting: bytes a query's exchange
    # moves over the interconnect.  Request leg = the query vector (f32 d)
    # plus, for the csr interior, its bucket ids + fingerprints (int32 L
    # each) and a validity byte; return leg = top_k (f32 score, int32 gid)
    # pairs.  "effective" counts only real destinations (mean_dest per
    # query); "wire" counts the fixed-cap all_to_all buffers actually
    # shipped (S*cap slots per source shard, padding included) — the
    # static-shape price of XLA collectives.
    d_cols = queries.shape[1]
    L_tabs = q_buckets.shape[1]
    req_bytes = 4 * d_cols + (8 * L_tabs + 1 if interior == "csr" else 1)
    ret_bytes = 8 * top_k
    q_pad_total = q + pad_q
    stats = {
        "n_shards": S,
        "cap": cap,
        "interior": interior,
        "dropped_requests": dropped,
        "total_requests": total,
        "corpus_rows": int(corpus.shape[0]),
        "mean_destinations_per_query": round(mean_dest, 3),
        "ici_request_bytes_per_query": round(mean_dest * req_bytes, 1),
        "ici_return_bytes_per_query": round(mean_dest * ret_bytes, 1),
        "ici_bytes_per_query": round(mean_dest * (req_bytes + ret_bytes), 1),
        "ici_bytes_per_query_wire": round(
            S * S * cap * (req_bytes + ret_bytes) / max(1, q_pad_total), 1
        ),
        **part_stats,
    }
    return vals[:q], gids[:q], stats
