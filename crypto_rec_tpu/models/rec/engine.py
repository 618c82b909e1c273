"""Neighbor-weighted, mean-centered collaborative filtering.

Reference math (/root/reference/lib/crypto_rec.hpp:213-345):
* get_P_closest: cosine similarity of the query user to every candidate,
  sorted descending, truncated to P (crypto_rec.hpp:213-231).  When the user
  is part of the index its self-similarity (1.0) is included — kept for
  parity: the self row contributes 0 to the weighted sum on unknown coins
  (its value there IS the mean) but does inflate the |sim| normalizer;
* predicted score for unknown coin j:
      pred_j = user_mean + sum_i sim_i * (R[i, j] - mean_i) / sum_i |sim_i|
  (get_predicted_user_sim, crypto_rec.hpp:280-306);
* top-N = the N highest-predicted unknown coins (crypto_rec.hpp:309-345).

Batched form: the whole per-user loop nest becomes, for a [q] batch of users
against [n] candidates: one similarity matmul, one masked top-k, one gather,
and one weighted contraction — matmuls end to end.  A zero |sim| sum (possible
when no candidate survives the mask) predicts the user mean instead of the
reference's NaN (main.cpp:421-423 contains a leftover NaN debug check).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from crypto_rec_tpu.ops.distances import cosine_similarity_matrix
from crypto_rec_tpu.ops.topk import masked_topk_desc, topn_indices

_EPS = 1e-30


class RatingSet(NamedTuple):
    """Device view of a UserMatrix (io/users.py) — ratings are imputed."""

    ratings: jax.Array  # [n, c] float32
    known: jax.Array    # [n, c] bool
    mean: jax.Array     # [n] float32

    @classmethod
    def from_user_matrix(cls, um) -> "RatingSet":
        return cls(
            ratings=jnp.asarray(um.ratings, jnp.float32),
            known=jnp.asarray(um.known),
            mean=jnp.asarray(um.mean, jnp.float32),
        )


class Recommendation(NamedTuple):
    predicted: jax.Array      # [q, c] — known coins keep their rating
    top_n: jax.Array          # [q, N] coin indexes, -1 padded
    has_neighbors: jax.Array  # [q] bool — reference skips users with empty
                              # candidate sets (main.cpp:161,207)
    sims: jax.Array           # [q, P] descending neighbor similarities
    neighbor_idx: jax.Array   # [q, P] candidate row indexes
    neighbor_valid: jax.Array # [q, P]


def predict_scores(
    queries: RatingSet,
    neighbors: RatingSet,
    sims: jax.Array,
    neighbor_idx: jax.Array,
    neighbor_valid: jax.Array,
) -> jax.Array:
    """get_predicted_user_sim over a batch: [q, P] selected neighbors ->
    [q, c] predictions (known cells keep their current rating)."""
    w = jnp.where(neighbor_valid, sims, 0.0)                      # [q, P]
    abs_sum = jnp.sum(jnp.abs(w), axis=1)                         # [q]
    neigh_r = neighbors.ratings[neighbor_idx]                     # [q, P, c]
    neigh_mu = neighbors.mean[neighbor_idx]                       # [q, P]
    centered = (neigh_r - neigh_mu[:, :, None]) * neighbor_valid[:, :, None]
    main_sum = jnp.einsum(
        "qp,qpc->qc", w, centered, preferred_element_type=jnp.float32
    )
    delta = main_sum / jnp.maximum(abs_sum, _EPS)[:, None]
    pred_unknown = queries.mean[:, None] + jnp.where(
        (abs_sum > 0.0)[:, None], delta, 0.0
    )
    return jnp.where(queries.known, queries.ratings, pred_unknown)


@functools.partial(jax.jit, static_argnames=("top_p", "top_n"))
def recommend(
    queries: RatingSet,
    neighbors: RatingSet,
    candidates: jax.Array,   # [q, n] bool mask of allowed neighbors
    top_p: int,
    top_n: int,
) -> Recommendation:
    """Full fused pipeline: similarity matmul -> masked top-P -> weighted
    mean-centered prediction -> top-N unknown coins."""
    sims = cosine_similarity_matrix(queries.ratings, neighbors.ratings)
    vals, idx, valid = masked_topk_desc(sims, candidates, top_p)
    safe_idx = jnp.maximum(idx, 0) * valid  # idx rows of invalid slots -> 0
    predicted = predict_scores(queries, neighbors, vals, safe_idx, valid)
    top = topn_indices(predicted, ~queries.known, top_n)
    return Recommendation(
        predicted=predicted,
        top_n=top,
        has_neighbors=jnp.any(valid, axis=1),
        sims=vals,
        neighbor_idx=jnp.where(valid, idx, -1),
        neighbor_valid=valid,
    )


@functools.partial(jax.jit, static_argnames=("top_n",))
def recommend_topk_retrieved(
    queries: RatingSet,
    neighbors: RatingSet,
    sims: jax.Array,          # [q, P] descending neighbor similarities
    neighbor_idx: jax.Array,  # [q, P] row ids (-1 pad), e.g. from
                              # models.lsh.index.retrieve_topk on the
                              # neighbor rating rows
    top_n: int,
) -> Recommendation:
    """CF scoring over pre-retrieved unique neighbors (the fused-retrieval
    form of get_P_closest + get_top_N_recom)."""
    valid = neighbor_idx >= 0
    idx = jnp.maximum(neighbor_idx, 0) * valid
    predicted = predict_scores(queries, neighbors, sims, idx, valid)
    top = topn_indices(predicted, ~queries.known, top_n)
    return Recommendation(
        predicted=predicted,
        top_n=top,
        has_neighbors=jnp.any(valid, axis=1),
        sims=jnp.where(valid, sims, -jnp.inf),
        neighbor_idx=neighbor_idx,
        neighbor_valid=valid,
    )


@functools.partial(jax.jit, static_argnames=("top_p", "top_n"))
def recommend_from_ids(
    queries: RatingSet,
    neighbors: RatingSet,
    candidate_ids: jax.Array,  # [q, B] row ids, -1 padded (CSR budget path)
    top_p: int,
    top_n: int,
) -> Recommendation:
    """Same engine over fixed-budget candidate id lists: computes similarities
    only against the B gathered rows per query (O(q*B*c) instead of O(q*n*c))
    — the form the sharded/billion-row path uses."""
    valid_c = candidate_ids >= 0
    safe = jnp.maximum(candidate_ids, 0)
    cand_r = neighbors.ratings[safe]                              # [q, B, c]
    dots = jnp.einsum(
        "qc,qbc->qb", queries.ratings, cand_r, preferred_element_type=jnp.float32
    )
    qn = jnp.linalg.norm(queries.ratings, axis=1, keepdims=True)
    cn = jnp.linalg.norm(cand_r, axis=2)
    sims = dots / jnp.maximum(qn * cn, _EPS)
    vals, slot, valid = masked_topk_desc(sims, valid_c, top_p)
    idx = jnp.take_along_axis(safe, slot, axis=1)
    predicted = predict_scores(queries, neighbors, vals, idx * valid, valid)
    top = topn_indices(predicted, ~queries.known, top_n)
    return Recommendation(
        predicted=predicted,
        top_n=top,
        has_neighbors=jnp.any(valid, axis=1),
        sims=vals,
        neighbor_idx=jnp.where(valid, idx, -1),
        neighbor_valid=valid,
    )
