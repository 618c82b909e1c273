"""Sharded retrieval + recommendation over a (dp, mp) mesh.

Layout (the row/column-sharded embedding-table design from BASELINE.json):
* the indexed corpus (ratings [n, c], bucket ids [n, L], detailed hashes)
  is row-sharded over "mp";
* the query batch is row-sharded over "dp" and replicated across "mp";
* each (dp, mp) mesh cell scores its query block against its index shard
  (local similarity matmul + local candidate mask + local top-P);
* the per-shard top-P results — weights plus the P selected neighbor rating
  rows — ride an all_gather over "mp" (interconnect), and a second top-P picks the
  global winners.  Communication per query is O(P * (c + 2)) floats, NOT the
  corpus, which is the point: collectives move candidates, not tables.

This is the multi-chip form of models/rec/engine.py:recommend; a unit test
checks element parity against the single-device path on a CPU-simulated
8-device mesh (SURVEY.md §4 test strategy).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from crypto_rec_tpu.models.rec.engine import RatingSet, Recommendation
from crypto_rec_tpu.ops.topk import masked_topk_desc, topn_indices

_EPS = 1e-30


def shard_rating_set(mesh: Mesh, rs: RatingSet, axis: str = "mp") -> RatingSet:
    """Place a RatingSet with rows sharded over `axis`."""
    row_sharding = NamedSharding(mesh, P(axis, None))
    vec_sharding = NamedSharding(mesh, P(axis))
    return RatingSet(
        ratings=jax.device_put(rs.ratings, row_sharding),
        known=jax.device_put(rs.known, row_sharding),
        mean=jax.device_put(rs.mean, vec_sharding),
    )


def distributed_topk(
    vals: jax.Array, payload_idx: jax.Array, k: int, axis_name: str
) -> Tuple[jax.Array, jax.Array]:
    """Merge per-shard top-k into a global top-k inside a shard_map body.

    vals [q, k_local] descending per shard; payload_idx [q, k_local] global
    ids.  all_gather over `axis_name` -> re-top-k.  The classic two-stage
    top-k (local reduce, all_gather merge).
    """
    g_vals = jax.lax.all_gather(vals, axis_name, axis=1)        # [q, S, k]
    g_idx = jax.lax.all_gather(payload_idx, axis_name, axis=1)  # [q, S, k]
    q = vals.shape[0]
    flat_vals = g_vals.reshape(q, -1)
    flat_idx = g_idx.reshape(q, -1)
    top_vals, pos = jax.lax.top_k(flat_vals, k)
    top_idx = jnp.take_along_axis(flat_idx, pos, axis=1)
    return top_vals, top_idx


@functools.partial(
    jax.jit, static_argnames=("mesh", "top_p", "top_n", "n_total")
)
def _sharded_recommend_impl(
    mesh: Mesh,
    q_ratings, q_known, q_mean,
    n_ratings, n_mean,
    cand_mask,
    top_p: int,
    top_n: int,
    n_total: int,
):
    def body(q_r, q_k, q_mu, n_r, n_mu, mask):
        # ---- local scoring: [q_loc, n_loc] cosine similarity ----
        dots = jax.lax.dot_general(
            q_r, n_r, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32
        )
        qn = jnp.sqrt(jnp.sum(jnp.square(q_r), axis=1))
        nn = jnp.sqrt(jnp.sum(jnp.square(n_r), axis=1))
        sims = dots / jnp.maximum(qn[:, None] * nn[None, :], _EPS)

        # ---- local top-P + row gather ----
        vals, idx, valid = masked_topk_desc(sims, mask, top_p)
        safe = jnp.maximum(idx, 0) * valid
        sel_r = n_r[safe]                        # [q_loc, P, c]
        sel_mu = n_mu[safe]                      # [q_loc, P]
        vals = jnp.where(valid, vals, -jnp.inf)

        # ---- merge across index shards (all_gather over "mp") ----
        S = jax.lax.axis_size("mp")
        g_vals = jax.lax.all_gather(vals, "mp", axis=1).reshape(vals.shape[0], -1)
        g_r = jax.lax.all_gather(sel_r, "mp", axis=1).reshape(
            vals.shape[0], S * top_p, -1
        )
        g_mu = jax.lax.all_gather(sel_mu, "mp", axis=1).reshape(vals.shape[0], -1)
        # global row ids for reporting: local idx + shard offset
        shard = jax.lax.axis_index("mp")
        n_loc = n_r.shape[0]
        gid = jnp.where(valid, idx + shard * n_loc, -1)
        g_gid = jax.lax.all_gather(gid, "mp", axis=1).reshape(vals.shape[0], -1)

        top_vals, pos = jax.lax.top_k(g_vals, top_p)
        top_valid = top_vals > -jnp.inf
        w = jnp.where(top_valid, top_vals, 0.0)
        top_r = jnp.take_along_axis(g_r, pos[:, :, None], axis=1)
        top_mu = jnp.take_along_axis(g_mu, pos, axis=1)
        top_gid = jnp.take_along_axis(g_gid, pos, axis=1)

        # ---- mean-centered weighted prediction (engine.predict_scores) ----
        abs_sum = jnp.sum(jnp.abs(w), axis=1)
        centered = (top_r - top_mu[:, :, None]) * top_valid[:, :, None]
        main_sum = jnp.einsum("qp,qpc->qc", w, centered, preferred_element_type=jnp.float32)
        delta = main_sum / jnp.maximum(abs_sum, _EPS)[:, None]
        pred_unknown = q_mu[:, None] + jnp.where((abs_sum > 0.0)[:, None], delta, 0.0)
        predicted = jnp.where(q_k, q_r, pred_unknown)
        top = topn_indices(predicted, ~q_k, top_n)
        return predicted, top, jnp.any(top_valid, axis=1), top_vals, top_gid, top_valid

    # check_vma=False: outputs are replicated over "mp" by construction
    # (every mp shard computes the identical post-all_gather merge).
    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(
            P("dp", None), P("dp", None), P("dp"),
            P("mp", None), P("mp"),
            P("dp", "mp"),
        ),
        out_specs=(
            P("dp", None), P("dp", None), P("dp"),
            P("dp", None), P("dp", None), P("dp", None),
        ),
        check_vma=False,
    )(q_ratings, q_known, q_mean, n_ratings, n_mean, cand_mask)


def sharded_recommend(
    mesh: Mesh,
    queries: RatingSet,
    neighbors: RatingSet,
    cand_mask: jax.Array,
    top_p: int,
    top_n: int,
) -> Recommendation:
    """Multi-chip recommend: queries sharded over dp, index over mp.

    Shapes must divide the mesh axes (pad rows host-side if needed).
    `cand_mask` is the dense [q, n] candidate mask (sharded (dp, mp)).
    """
    predicted, top, has, vals, gids, valid = _sharded_recommend_impl(
        mesh,
        queries.ratings, queries.known, queries.mean,
        neighbors.ratings, neighbors.mean,
        cand_mask,
        top_p, top_n, neighbors.ratings.shape[0],
    )
    return Recommendation(
        predicted=predicted,
        top_n=top,
        has_neighbors=has,
        sims=vals,
        neighbor_idx=jnp.where(valid, gids, -1),
        neighbor_valid=valid,
    )
