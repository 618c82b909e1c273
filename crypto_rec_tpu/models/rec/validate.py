"""10-fold cross-validation MAE for the LSH recommender.

Reference flow (lsh_rec_10_fold_validation_A, /root/reference/main.cpp:393-437
+ crypto_rec.hpp:348-449):
* split users into 10 random folds of n/10 (remainder users are silently
  dropped by split_to_10, crypto_rec.hpp:351-366 — kept for parity);
* per fold: build LSH tables on the other 9, and for each held-out user
  "hide one score": zero out the imputed unknowns, hide one random known
  rating, re-impute it with the mean of the remaining coins, skip users
  with fewer than 2 known coins or an otherwise all-zero vector
  (hide_one_score, crypto_rec.hpp:393-449);
* MAE = mean over folds of mean |hidden - predicted| over scored users.

Deviations (SURVEY.md §5): the reference draws the hidden coin as an index
into the known-index list but then hides that *position* in the dimension
array (crypto_rec.hpp:410-412), and reseeds rand with time(0) per call; we
hide a uniformly random known coin with an explicit jax.random key.

Batched form: each fold is one batched build + one batched query — no per-user
loops.  All folds share one jit cache entry (identical shapes).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from crypto_rec_tpu.models.lsh.index import build_index, candidate_mask
from crypto_rec_tpu.models.rec.engine import RatingSet, recommend


def hide_one_score(
    key: jax.Array,
    ratings: jax.Array,
    known: jax.Array,
    c: int,
    hide_mode: str = "fixed",
) -> Tuple[RatingSet, jax.Array, jax.Array]:
    """Batched hide_one_score (crypto_rec.hpp:393-449).

    Returns (hidden RatingSet, hidden coin index [q], scoreable mask [q]).
    Scoreable: >= 2 known coins AND the remaining vector is not all-zero.

    hide_mode:
      "fixed"     — hide a uniformly random KNOWN coin (the intended
                    semantics; our default).
      "reference" — emulate the reference's index-conflation bug
                    (crypto_rec.hpp:410-412): the random draw ranges over
                    [0, known_count) but is then used as a COLUMN index, so
                    an imputed (unknown) column can be "hidden", whose old
                    value is just the user mean — biasing MAE low.  Used
                    for apples-to-apples parity measurement only.
    """
    q = ratings.shape[0]
    known_counts = jnp.sum(known, axis=1)
    if hide_mode == "reference":
        u = jax.random.uniform(key, (q,))
        hide_idx = jnp.floor(u * known_counts).astype(jnp.int32)
        hide_idx = jnp.minimum(hide_idx, c - 1)
    elif hide_mode == "fixed":
        logits = jnp.where(known, 0.0, -jnp.inf)
        hide_idx = jax.random.categorical(key, logits, axis=1)     # [q]
    else:
        raise ValueError(f"unknown hide_mode {hide_mode!r}")
    hide_oh = jax.nn.one_hot(hide_idx, c, dtype=bool)

    # unknown cells -> 0; then the hidden cell gets the mean of the rest.
    zeroed = jnp.where(known, ratings, 0.0)
    rest_sum = jnp.sum(zeroed, axis=1) - jnp.sum(jnp.where(hide_oh, zeroed, 0.0), axis=1)
    new_mean = rest_sum / jnp.maximum(c - 1, 1)
    new_ratings = jnp.where(hide_oh, new_mean[:, None], zeroed)
    useless = rest_sum == 0.0                                      # crypto_rec.hpp:421-433
    scoreable = (known_counts >= 2) & ~useless
    hidden = RatingSet(ratings=new_ratings, known=~hide_oh, mean=new_mean)
    return hidden, hide_idx, scoreable


def ten_fold_mae(
    key: jax.Array,
    users: RatingSet,
    metric: str,
    k: int,
    L: int,
    lsh_bucket_div: int,
    euclidean_h_w: float,
    top_p: int,
    hide_mode: str = "fixed",
    engine: str = "mask",
    candidate_budget: int = 256,
) -> float:
    """Overall 10-fold CV MAE (main.cpp:393-437).

    engine picks the per-fold candidate path (VERDICT r4 missing #5 — the
    dense mask is O(test * train) memory per fold and cannot validate
    large synthetic user sets):
      "mask"  — dense candidate mask, exact reference whole-bucket-union
                semantics (get_LSH_filtered_combined_buckets);
      "csr"   — fixed-budget CSR candidate ids + gathered scoring,
                O(test * budget) memory;
      "fused" — packed slabs + fused retrieval straight to the top-P
                neighbors (the serving engine, validated end to end).
    All three produce identical predictions whenever the budget/window
    covers each query's bucket union (tested in test_pipeline_engines.py).
    """
    n, c = users.ratings.shape
    fold_size = n // 10
    if fold_size == 0:
        raise ValueError("need at least 10 users for 10-fold CV")
    if engine not in ("mask", "csr", "fused"):
        raise ValueError(f"unknown engine {engine!r} (mask | csr | fused)")
    key, kperm = jax.random.split(key)
    perm = np.asarray(jax.random.permutation(kperm, n))[: 10 * fold_size]
    folds = perm.reshape(10, fold_size)

    @functools.partial(jax.jit, static_argnames=())
    def one_fold(train: RatingSet, test: RatingSet, test_known, kidx):
        kfold, khide = jax.random.split(kidx)
        hidden, hide_idx, scoreable = hide_one_score(
            khide, test.ratings, test_known, c, hide_mode=hide_mode
        )
        index = build_index(
            kfold, train.ratings, metric, k, L, lsh_bucket_div, euclidean_h_w
        )
        if engine == "csr":
            from crypto_rec_tpu.models.lsh.index import gather_candidate_ids, query_hashes
            from crypto_rec_tpu.models.rec.engine import recommend_from_ids

            qb, qd = query_hashes(index, hidden.ratings)
            ids = gather_candidate_ids(
                index.sorted_rows, index.bucket_starts, index.detailed,
                index.n_rows, qb, qd, budget=candidate_budget,
            )
            rec = recommend_from_ids(
                hidden, train, ids, top_p=top_p, top_n=1
            )
        elif engine == "fused":
            from crypto_rec_tpu.models.lsh.index import pack_index, retrieve_topk
            from crypto_rec_tpu.models.rec.engine import recommend_topk_retrieved

            pidx = pack_index(index, train.ratings, dtype=jnp.float32)
            sims, nidx = retrieve_topk(
                pidx, hidden.ratings, train.ratings, top_k=top_p,
                per_table=candidate_budget,
            )
            rec = recommend_topk_retrieved(hidden, train, sims, nidx, 1)
        else:
            mask = candidate_mask(index, hidden.ratings, filtered=True)
            rec = recommend(hidden, train, mask, top_p=top_p, top_n=1)
        pred_hidden = jnp.take_along_axis(
            rec.predicted, hide_idx[:, None], axis=1
        )[:, 0]
        old = jnp.take_along_axis(test.ratings, hide_idx[:, None], axis=1)[:, 0]
        ok = scoreable & rec.has_neighbors
        abs_err = jnp.abs(old - pred_hidden) * ok
        count = jnp.sum(ok)
        return jnp.sum(abs_err) / jnp.maximum(count, 1), count

    ratings = np.asarray(users.ratings)
    known = np.asarray(users.known)
    mean = np.asarray(users.mean)
    fold_maes = []
    for i in range(10):
        test_idx = folds[i]
        train_idx = np.concatenate([folds[j] for j in range(10) if j != i])
        train = RatingSet(
            jnp.asarray(ratings[train_idx]),
            jnp.asarray(known[train_idx]),
            jnp.asarray(mean[train_idx]),
        )
        test = RatingSet(
            jnp.asarray(ratings[test_idx]),
            jnp.asarray(known[test_idx]),
            jnp.asarray(mean[test_idx]),
        )
        key, kidx = jax.random.split(key)
        mae, _count = one_fold(train, test, jnp.asarray(known[test_idx]), kidx)
        fold_maes.append(float(mae))
    return float(np.mean(fold_maes))
