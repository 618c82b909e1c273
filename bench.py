"""Benchmark: LSH retrieval recall@10 + queries/s/chip on synthetic
embeddings (BASELINE.json config 3: single-chip batched LSH vs exact NN).

Prints exactly ONE JSON line:
  {"metric": "lsh_recall@10", "value": <recall>, "unit": "recall",
   "vs_baseline": <recall / 0.95>, ...extra diagnostics...}

The baseline target is recall@10 >= 0.95 vs exact NN (BASELINE.md); the
reference itself publishes no numbers (its oracle functions are never called
by main — /root/reference/lib/utils.hpp:107-140), so vs_baseline is measured
against that target.

Timing methodology: every jitted path is warmed up (compile excluded), and
each timed repetition ends in jax.block_until_ready, so asynchronous
dispatch cannot under-report.  A stage that fails stops the run.

Environment knobs:
  BENCH_N (corpus rows, default 2,000,000), BENCH_D (dims), BENCH_Q
  (queries), BENCH_ORACLE_Q (queries for the exact-NN recall check),
  BENCH_LSH_K (default auto), BENCH_LSH_L, BENCH_BUDGET, BENCH_WINDOW.
  BENCH_METRIC      cosine (default) | euclidean (p-stable + detailed filter,
                    /root/reference/lib/generators/euclidean_phi_gen.hpp).
  BENCH_EUC_W       p-stable window w (default 4.0 for the synthetic scale).
  BENCH_PACK_DTYPE  bfloat16 | int8 | both | none (default: both when the
                    bf16 slabs fit the device, else int8) — "both" reports a
                    bf16 AND an int8 fused datapoint in the same JSON line.
  BENCH_CUBE        hypercube probing stage
                    (/root/reference/lib/lsh_cube.hpp:139-177); default ON
                    (cosine runs, N <= 4M), nested as out["hypercube"].
  BENCH_CUBE_K / BENCH_CUBE_PROBES  cube vertex bits / probe count.
  BENCH_EUCLIDEAN   p-stable LSH stage on the SAME corpus
                    (/root/reference/lib/generators/euclidean_phi_gen.hpp);
                    default ON (cosine runs, N <= 4M), nested as
                    out["euclidean"].  BENCH_EUC_K/BENCH_EUC_L/BENCH_EUC_PT
                    override its k/L/window.
  BENCH_CF          end-to-end collaborative-filtering stage: fused
                    retrieval (top-P cosine neighbors) + mean-centered
                    prediction + top-N, the models/rec/engine.py math over
                    the bench corpus as rating rows; default ON (cosine,
                    N <= 4M), nested as out["cf"].
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

import numpy as np

from crypto_rec_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402



def log(*a):
    print(*a, file=sys.stderr, flush=True)


def timed(fn, reps: int = 5):
    """Median wall-clock of fn(): fully sync every rep and free its outputs
    before the next (async overlap both under-reports AND doubles peak
    device memory on a nearly-full card)."""
    times = []
    out = None
    for _ in range(reps):
        del out
        t0 = time.perf_counter()
        out = fn()
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def main() -> None:
    N = int(os.environ.get("BENCH_N", 2_000_000))
    D = int(os.environ.get("BENCH_D", 128))
    Q = int(os.environ.get("BENCH_Q", 8192))
    # Fused-path batch curve: the JSON records every batch; the headline
    # is the fastest one, with its batch size recorded.
    QBATCH = [
        int(b) for b in os.environ.get(
            "BENCH_QBATCH", f"{Q},32768,65536" if N <= 4_000_000 else f"{Q}"
        ).split(",")
    ]
    # planted rows are Q*10 of the corpus; keep them a minority
    QBATCH = [b for b in QBATCH if b * 10 <= N // 2] or [Q]
    QMAX = max([Q] + QBATCH)
    OQ = int(os.environ.get("BENCH_ORACLE_Q", 1024))
    METRIC = os.environ.get("BENCH_METRIC", "cosine")
    L = int(os.environ.get("BENCH_LSH_L", 8 if METRIC == "cosine" else 16))
    BUDGET = int(os.environ.get("BENCH_BUDGET", 1024))
    EUC_W = float(os.environ.get("BENCH_EUC_W", 8.0))
    if METRIC == "cosine":
        # Auto-size k: one bit below "average bucket == budget/L" — slightly
        # larger buckets raise the per-table collision probability, and the
        # window below still covers them (CPU sweep 2026-08-17: this point
        # gives recall ~0.99 at 1M rows vs ~0.96 for auto k).
        k_auto = max(8, math.ceil(math.log2(max(2, N / max(1, BUDGET // L)))) - 1)
        K = int(os.environ.get("BENCH_LSH_K", k_auto))
        n_buckets = 1 << K
    else:
        # p-stable tables: n / lsh_bucket_div buckets (lsh_cube.hpp:61).
        # k=5, w=8, L=16, window 512: clustered data concentrates the
        # Gaussian h-values, so central tuples crowd — deeper tuples +
        # wider w flatten the cells (CPU sweep 2026-08-20 at 500k rows:
        # recall 0.9966 vs 0.15 for the shallow k=3/w=6 point at 2M)
        K = int(os.environ.get("BENCH_LSH_K", 5))
        n_buckets = max(1, N // 4)
    # Per-table gather window: 2x the average bucket (CPU sweep 2026-08-17:
    # recall 0.996 at 1M rows; 4x doubles gather traffic for +0.3 recall
    # pt).  Euclidean buckets are skewed (clustered h-values), so the
    # average is misleading — 512 measured best (sweep 2026-08-20).
    pt_auto = (
        min(BUDGET, max(128, 2 * N // n_buckets))
        if METRIC == "cosine" else 512
    )
    PT = int(os.environ.get("BENCH_WINDOW", pt_auto))
    TOPK = 10
    dev = jax.devices()[0]
    # device memory available to this process (None on backends that do
    # not report it): every memory gate below is a share of it
    HBM = (dev.memory_stats() or {}).get("bytes_limit") or float("inf")
    # bf16 scoring needs a second corpus copy next to the f32 one
    BF16 = os.environ.get(
        "BENCH_BF16", "1" if 3 * N * D * 4 <= 0.25 * HBM else "0") == "1"

    from crypto_rec_tpu.models.lsh.index import (
        build_index,
        candidate_ids,
        pack_index,
        retrieve_topk,
    )
    from crypto_rec_tpu.ops.oracle import exact_nearest, recall_at_k

    log(f"device: {dev} platform={dev.platform} kind={dev.device_kind}  N={N} D={D} Q={Q} "
        f"metric={METRIC} K={K} L={L} budget={BUDGET} window={PT}")
    key = jax.random.PRNGKey(0)

    # Clustered synthetic corpus with PLANTED ground truth (see
    # crypto_rec_tpu.io.synth.planted_clustered_corpus for the protocol and
    # the memory story).  Planted rows are query + small noise, so they are
    # the unambiguous top-k under cosine AND euclidean.
    from crypto_rec_tpu.io.synth import planted_clustered_corpus

    t0 = time.perf_counter()
    corpus, queries_all, true_idx_all = planted_clustered_corpus(
        key, N, D, QMAX, TOPK)
    corpus = jax.block_until_ready(corpus)
    queries_all = jax.block_until_ready(queries_all)
    queries, true_idx = queries_all[:Q], true_idx_all[:Q]
    log(f"corpus [{N}, {D}] built in {time.perf_counter() - t0:.1f}s "
        f"({QMAX}x{TOPK} planted true neighbors)")

    # ---- index build: warm (compile) then timed ----
    def do_build(seed):
        return build_index(
            jax.random.PRNGKey(seed), corpus, METRIC, K, L,
            lsh_bucket_div=4, euclidean_h_w=EUC_W,
        )

    t0 = time.perf_counter()
    index = do_build(1)
    jax.block_until_ready(index.bucket_starts)
    log(f"index build cold (incl. compile): {time.perf_counter() - t0:.2f}s")
    del index  # don't hold a live index while timing fresh builds
    # Time builds one at a time: sync EVERY output leaf and delete before
    # the next rep — syncing a single array would let builds overlap
    # asynchronously and double peak memory.  The last timed
    # build is reused as THE index (no extra build, less fragmentation).
    build_times = []
    index = None
    for _ in range(3 if N <= 4_000_000 else 1):
        del index
        t0 = time.perf_counter()
        index = do_build(1)
        jax.block_until_ready(jax.tree_util.tree_leaves(index))
        build_times.append(time.perf_counter() - t0)
    build_s = float(np.median(build_times))
    log(f"index build warm: {build_s:.3f}s ({N / build_s / 1e6:.2f}M rows/s)")

    # ---- candidate-set retrieval QPS (secondary; the CF engine's path).
    # Off by default above 4M rows; the fused path below is the headline
    # retrieval measurement either way.
    CANDSET = os.environ.get("BENCH_CANDSET", "1" if N <= 4_000_000 else "0") == "1"
    qps = 0.0
    if CANDSET:
        jax.block_until_ready(candidate_ids(index, queries, budget=BUDGET, per_table=PT))
        query_s = timed(lambda: candidate_ids(index, queries, budget=BUDGET, per_table=PT), reps=5)
        qps = Q / query_s
        log(f"retrieval: {Q} queries in {query_s * 1e3:.1f} ms -> {qps:,.0f} q/s/chip")

    # ---- packed-slab layouts (pack_index): per-table CSR-ordered corpus
    # copies turn the fused path's random row gather into contiguous
    # aligned reads.  Costs L extra corpus copies, so the dtype plan is
    # gated on device memory: bf16 slabs up to ~35% of it, int8 to ~65%.
    D_SLAB = -(-(D + 1) // 128) * 128 if METRIC == "euclidean" else D
    slab_bytes = lambda itemsize: L * (N + 4096) * D_SLAB * itemsize
    plan_env = os.environ.get("BENCH_PACK_DTYPE", "")
    if plan_env in ("bfloat16", "int8", "none"):
        plan = [] if plan_env == "none" else [plan_env]
    elif plan_env == "both" or (not plan_env and slab_bytes(2) <= 0.35 * HBM):
        plan = ["bfloat16", "int8"]
    elif not plan_env and slab_bytes(1) <= 0.65 * HBM:
        plan = ["int8"]
    else:
        plan = [] if not plan_env else [plan_env]

    # HOST_ORACLE (auto at >4M rows): keep a host copy of the corpus and
    # free the device f32 copy right after packing — the oracle streams
    # from host, and the no-rerank retrieval paths never read the corpus.
    HOST_ORACLE = os.environ.get(
        "BENCH_HOST_ORACLE", "1" if N > 4_000_000 else "0") == "1"
    RERANK = os.environ.get("BENCH_INT8_RERANK", "0") == "1"
    corpus_host = None
    corpus_freed = False
    if HOST_ORACLE:
        corpus_host = np.asarray(jax.device_get(corpus))
        if not RERANK:
            # free the device corpus BEFORE packing: the pack runs on the
            # host copy (pack_index_host) and the scale-free / no-rerank
            # retrieval paths never read the corpus — device peak becomes
            # just the slabs.  The zeros array is a trace-only stand-in for
            # the packed no-rerank calls; any stage that actually SCORES
            # against the corpus must go through need_corpus() below.
            corpus.delete()
            corpus = jnp.zeros((2, D), jnp.float32)
            corpus_freed = True
            log("device corpus freed (host oracle mode)")

    def need_corpus(stage):
        """Re-upload the real corpus if host-oracle mode freed it; stages
        that read corpus rows call this instead of trusting the stand-in."""
        nonlocal corpus, corpus_freed
        if corpus_freed:
            log(f"{stage}: re-uploading {N}x{D} corpus from host "
                f"(device copy was freed in host-oracle mode)")
            corpus = jax.block_until_ready(jnp.asarray(corpus_host))
            corpus_freed = False
        return corpus

    per_dtype = {}
    pidx = None
    for dtype_name in plan:
        pack_dtype = {"int8": jnp.int8, "bfloat16": jnp.bfloat16}[dtype_name]
        del pidx
        pidx = None
        t0 = time.perf_counter()
        # euclidean main metric packs the AUGMENTED layout so retrieval
        # rides the windowed dots (rank dot); cosine packs plain slabs
        if HOST_ORACLE and not RERANK:
            from crypto_rec_tpu.models.lsh.index import pack_index_host

            pidx = pack_index_host(index, corpus_host, dtype=pack_dtype,
                                   augment=(METRIC == "euclidean"))
        else:
            pidx = pack_index(index, corpus, dtype=pack_dtype,
                              augment=(METRIC == "euclidean"))
        jax.block_until_ready(jax.tree_util.tree_leaves(pidx))
        pack_s = time.perf_counter() - t0
        gb = slab_bytes(jnp.dtype(pack_dtype).itemsize) / 1e9
        log(f"packed slabs ({gb:.1f} GB {dtype_name}) in {pack_s:.2f}s"
            + (" [host pack]" if HOST_ORACLE and not RERANK else ""))

        # RERANK above: int8 default is the no-rerank mode — raw
        # global-scale dots ranked and dequantized by the stored scalar
        if METRIC == "cosine" and pidx.packed_scale is None:
            # cosine scale-free slabs: the whole batch in one windowed-dots
            # call (retrieve_topk_pallas)
            from crypto_rec_tpu.models.lsh.index import retrieve_topk_pallas

            kernel = "windowed_dots"

            def retrieve_for(qs):
                return lambda: retrieve_topk_pallas(
                    pidx, qs, corpus, top_k=TOPK, per_table=PT,
                    int8_rerank=RERANK,
                )
        else:
            # euclidean main metric: the augmented pack routes retrieval
            # through the windowed dots inside retrieve_topk
            kernel = ("windowed_dots_aug" if METRIC == "euclidean"
                      else "xla_blocked")

            def retrieve_for(qs):
                return lambda: retrieve_topk(
                    pidx, qs, corpus, top_k=TOPK, per_table=PT,
                    int8_rerank=RERANK,
                )
        batch_curve = {}
        fused_qps = 0.0
        rec = -1.0
        for qb in QBATCH:
            run = retrieve_for(queries_all[:qb])
            jax.block_until_ready(run())
            b_s = timed(run, reps=5)
            b_qps = qb / b_s
            _sf, ids_f = run()
            b_rec = float(recall_at_k(ids_f, true_idx_all[:qb]))
            log(f"fused retrieve+score+top{TOPK} [{dtype_name}/{kernel}] "
                f"q={qb}: {b_s * 1e3:.1f} ms -> {b_qps:,.0f} q/s/chip "
                f"(recall {b_rec:.4f})")
            batch_curve[str(qb)] = {
                "qps": round(b_qps, 1), "recall": round(b_rec, 4),
            }
            if b_qps > fused_qps:
                fused_qps, rec = b_qps, b_rec
        per_dtype[dtype_name] = {
            "qps": round(fused_qps, 1),
            "recall": round(rec, 4),
            "pack_s": round(pack_s, 3),
            "kernel": kernel,
            "int8_rerank": bool(RERANK) if dtype_name == "int8" else None,
            "batch_curve": batch_curve,
        }

    # headline = the fastest packed datapoint (or the unpacked fused path
    # when no packing fits)
    headline_batch = Q
    if per_dtype:
        head_name = max(per_dtype, key=lambda d: per_dtype[d]["qps"])
        head = per_dtype[head_name]
        fused_qps, fused_recall = head["qps"], head["recall"]
        headline_batch = max(
            (int(b) for b, v in head["batch_curve"].items()
             if v["qps"] == head["qps"]), default=Q,
        )
    else:
        head_name = "unpacked"
        need_corpus("unpacked fused fallback")
        score_corpus = corpus.astype(jnp.bfloat16) if BF16 else corpus
        score_corpus = jax.block_until_ready(score_corpus)
        jax.block_until_ready(retrieve_topk(index, queries, score_corpus, top_k=TOPK, per_table=PT))
        fused_s = timed(
            lambda: retrieve_topk(index, queries, score_corpus, top_k=TOPK, per_table=PT),
            reps=5,
        )
        fused_qps = Q / fused_s
        _sf, ids_f = retrieve_topk(index, queries, score_corpus, top_k=TOPK, per_table=PT)
        fused_recall = float(recall_at_k(ids_f, true_idx))
        log(f"fused retrieve (unpacked): {fused_s*1e3:.1f} ms -> "
            f"{fused_qps:,.0f} q/s/chip (recall {fused_recall:.4f})")

    # ---- candidate-set recall (CF path) ----
    recall = -1.0
    if CANDSET:
        ids = candidate_ids(index, queries, budget=BUDGET, per_table=PT)
        recall = float(recall_at_k(ids, true_idx))

    # ---- scored candidate-set engine: score-ranked sets off the windowed
    # dots — the candidate engine the CF paths ride at scale.
    # The count-ranked candidate_ids above stays as the reference-
    # semantics engine; both are recorded. ----
    scored_stats = None
    if pidx is not None and METRIC == "cosine" and pidx.packed_scale is None:
        from crypto_rec_tpu.models.lsh.index import candidate_ids_scored

        SBUDGET = int(os.environ.get("BENCH_SCORED_BUDGET", 256))
        run_sc = lambda: candidate_ids_scored(
            pidx, queries, budget=SBUDGET, per_table=PT)
        sids = run_sc()
        jax.block_until_ready(sids)
        sc_s = timed(run_sc, reps=5)
        sc_recall = float(recall_at_k(sids, true_idx))
        log(f"scored candidate sets (budget={SBUDGET}): "
            f"{sc_s*1e3:.1f} ms -> {Q/sc_s:,.0f} q/s/chip "
            f"(set-recall {sc_recall:.4f})")
        scored_stats = {
            "qps": round(Q / sc_s, 1),
            "recall": round(sc_recall, 4),
            "budget": SBUDGET,
        }

    # ---- end-to-end CF stage: fused retrieval -> top-P neighbors ->
    # mean-centered prediction -> top-N (the reference's actual product,
    # /root/reference/lib/crypto_rec.hpp:213-345, at retrieval speed
    # instead of the candidate-set path's per-query dedup-rank sort) ----
    cf_stats = None
    secondary_ok = METRIC == "cosine" and N <= 4_000_000
    if os.environ.get("BENCH_CF", "1" if secondary_ok else "0") == "1" \
            and pidx is not None:
        from crypto_rec_tpu.models.rec.engine import (
            RatingSet, recommend_topk_retrieved,
        )
        TOP_P, TOP_N = 20, 5
        need_corpus("CF stage")
        kq = jax.random.PRNGKey(11)
        n_known = jax.random.bernoulli(kq, 0.6, (N, D))
        n_mean = jnp.sum(corpus * n_known, axis=1) / jnp.maximum(
            jnp.sum(n_known, axis=1), 1
        )
        nset = RatingSet(ratings=corpus, known=n_known, mean=n_mean)

        def make_cf(qb):
            qs = queries_all[:qb]
            q_known = jax.random.bernoulli(
                jax.random.PRNGKey(12), 0.6, (qb, D))
            q_mean = jnp.sum(qs * q_known, axis=1) / jnp.maximum(
                jnp.sum(q_known, axis=1), 1
            )
            qset = RatingSet(ratings=qs, known=q_known, mean=q_mean)

            # one windowed-dots call for the whole batch + per-table
            # stage-1 at kk=12 (96 stage-1 survivors for top-20)
            cf_kernel_ok = pidx.packed_scale is None

            def run_cf():
                if cf_kernel_ok:
                    from crypto_rec_tpu.models.lsh.index import (
                        retrieve_topk_pallas,
                    )

                    sims, nidx = retrieve_topk_pallas(
                        pidx, qs, corpus, top_k=TOP_P, per_table=PT,
                        int8_rerank=False, stage1_per_table=12,
                    )
                else:
                    sims, nidx = retrieve_topk(
                        pidx, qs, corpus, top_k=TOP_P, per_table=PT,
                        int8_rerank=False, stage1_per_table=12,
                    )
                return recommend_topk_retrieved(qset, nset, sims, nidx, TOP_N)

            return run_cf

        cf_curve = {}
        cf_qps = 0.0
        cf_recall = -1.0
        for qb in QBATCH:
            run_cf = make_cf(qb)
            jax.block_until_ready(run_cf())
            cf_s = timed(run_cf, reps=5)
            cf_rec = run_cf()
            # neighbor quality: the 10 planted twins are the true top
            # neighbors of each query (they tie near sim 1.0, so top-1
            # identity is arbitrary — measure set recall, not first-hit)
            b_recall = float(recall_at_k(
                jnp.asarray(cf_rec.neighbor_idx)[:, :TOPK],
                true_idx_all[:qb],
            ))
            log(f"CF end-to-end q={qb} (top-{TOP_P} neighbors -> predict "
                f"-> top-{TOP_N}): {cf_s*1e3:.1f} ms -> "
                f"{qb/cf_s:,.0f} users/s/chip "
                f"(neighbor recall@{TOPK} {b_recall:.4f})")
            cf_curve[str(qb)] = {
                "qps": round(qb / cf_s, 1), "recall": round(b_recall, 4),
            }
            if qb / cf_s > cf_qps:
                cf_qps, cf_recall = qb / cf_s, b_recall
        cf_stats = {
            "qps": round(cf_qps, 1),
            "top_p": TOP_P,
            "top_n": TOP_N,
            "neighbor_recall": round(cf_recall, 4),
            "via": "fused_retrieve+recommend_topk_retrieved",
            "batch_curve": cf_curve,
        }
        del nset, n_known

    # ---- euclidean (p-stable) stage on the same corpus ----
    euc_stats = None
    if os.environ.get("BENCH_EUCLIDEAN", "1" if secondary_ok else "0") == "1":
        del pidx  # free the cosine slabs before packing euclidean tables
        pidx = None
        need_corpus("euclidean stage")
        # the collision-limited regime wants wider cells and fewer tables:
        # L=4 / w=20 / window 768
        E_K = int(os.environ.get("BENCH_EUC_K", 5))
        E_L = int(os.environ.get("BENCH_EUC_L", 4))
        E_PT = int(os.environ.get("BENCH_EUC_PT", 768))
        E_W = float(os.environ.get("BENCH_EUC_W", 20.0))
        # augmented layout (pack_index augment=True): euclidean rides the
        # windowed dots.  int8 by default: half the slab bytes of bf16
        E_AUG = os.environ.get("BENCH_EUC_AUG", "1") == "1"
        e_dtype = {"int8": jnp.int8, "bfloat16": jnp.bfloat16}[
            os.environ.get("BENCH_EUC_DTYPE", "int8")
        ]
        def e_build_once():
            eidx = build_index(
                jax.random.PRNGKey(21), corpus, "euclidean", E_K, E_L,
                lsh_bucket_div=4, euclidean_h_w=E_W,
            )
            jax.block_until_ready(jax.tree_util.tree_leaves(eidx))
            return eidx

        t0 = time.perf_counter()
        eidx = e_build_once()
        e_build_cold = time.perf_counter() - t0
        # the cold build is mostly compile; report warm like cosine
        del eidx
        t0 = time.perf_counter()
        eidx = e_build_once()
        e_build = time.perf_counter() - t0
        log(f"euclidean build cold {e_build_cold:.2f}s / warm {e_build:.2f}s")
        t0 = time.perf_counter()
        eidx = pack_index(eidx, corpus, dtype=e_dtype, augment=E_AUG)
        jax.block_until_ready(jax.tree_util.tree_leaves(eidx))
        e_pack_cold = time.perf_counter() - t0
        # warm pack: re-pack once more (pack_index is also jit-compiled)
        eidx2 = build_index(
            jax.random.PRNGKey(21), corpus, "euclidean", E_K, E_L,
            lsh_bucket_div=4, euclidean_h_w=E_W,
        )
        del eidx
        t0 = time.perf_counter()
        eidx = pack_index(eidx2, corpus, dtype=e_dtype, augment=E_AUG)
        jax.block_until_ready(jax.tree_util.tree_leaves(eidx))
        e_pack = time.perf_counter() - t0
        del eidx2
        log(f"euclidean pack cold {e_pack_cold:.2f}s / warm {e_pack:.2f}s")
        EQ = min(32768, QMAX)
        e_qs, e_true = queries_all[:EQ], true_idx_all[:EQ]
        e_run = lambda: retrieve_topk(
            eidx, e_qs, corpus, top_k=TOPK, per_table=E_PT,
            approx_stage1=True,
        )
        jax.block_until_ready(e_run())
        e_s = timed(e_run, reps=5)
        _es, e_ids = e_run()
        e_recall = float(recall_at_k(e_ids, e_true))
        log(f"euclidean k={E_K} L={E_L} w={E_W} window={E_PT} "
            f"[{jnp.dtype(e_dtype).name}] q={EQ}: {e_s*1e3:.1f} ms -> "
            f"{EQ/e_s:,.0f} q/s/chip (recall {e_recall:.4f}, "
            f"build {e_build:.2f}s, pack {e_pack:.2f}s)")
        euc_stats = {
            "k": E_K, "tables": E_L, "w": E_W, "per_table": E_PT,
            "qps": round(EQ / e_s, 1), "recall": round(e_recall, 4),
            "batch": EQ,
            "build_s": round(e_build, 3), "pack_s": round(e_pack, 3),
            "build_cold_s": round(e_build_cold, 3),
            "pack_cold_s": round(e_pack_cold, 3),
            "dtype": jnp.dtype(e_dtype).name, "augmented": E_AUG,
        }
        if E_AUG:
            # euclidean scored candidate sets: the augmented rank dot feeds
            # candidate_ids_scored, so euclidean CF rides the same
            # score-ranked engine as cosine
            from crypto_rec_tpu.models.lsh.index import candidate_ids_scored

            run_esc = lambda: candidate_ids_scored(
                eidx, e_qs, budget=256, per_table=E_PT)
            jax.block_until_ready(run_esc())
            esc_s = timed(run_esc, reps=5)
            esc_recall = float(recall_at_k(run_esc(), e_true))
            log(f"euclidean scored sets (budget=256): "
                f"{esc_s*1e3:.1f} ms -> {EQ/esc_s:,.0f} sets/s "
                f"(set-recall {esc_recall:.4f})")
            euc_stats["scored_sets"] = {
                "qps": round(EQ / esc_s, 1),
                "recall": round(esc_recall, 4),
                "budget": 256,
            }
        del eidx

    # ---- hypercube stage (lsh_cube.hpp:139-177) ----
    cube_stats = None
    if os.environ.get("BENCH_CUBE", "1" if secondary_ok else "0") == "1":
        from crypto_rec_tpu.models.lsh.hypercube import (
            build_hypercube, build_multicube, cube_retrieve_topk,
            multicube_retrieve_topk, pack_cube,
        )

        del pidx  # free the LSH slabs before packing the cube
        pidx = None
        need_corpus("hypercube stage")
        CK = int(os.environ.get("BENCH_CUBE_K", max(8, K)))
        # query-DIRECTED probing lifts a single cube but plateaus below
        # 0.99 (confident-bit flips are unreachable); the MULTICUBE union
        # of C independent cubes makes misses independent.  The
        # single-cube directed point is recorded alongside (one cube IS
        # the reference's structure).
        C_CUBES = int(os.environ.get("BENCH_CUBE_C", 2))
        # 12 directed probes/cube keeps the union in the 0.99 class
        C_PROBES = int(os.environ.get("BENCH_CUBE_MPROBES", 12))
        c_pt = int(os.environ.get("BENCH_CUBE_PT", 488))
        CQ = min(32768, QMAX)
        c_qs, c_true = queries_all[:CQ], true_idx_all[:CQ]
        c_dtype = jnp.int8
        cube_points = []
        t0 = time.perf_counter()
        mcube = build_multicube(
            jax.random.PRNGKey(7), corpus, METRIC, C_CUBES, CK, EUC_W,
            corpus_dtype=c_dtype,
        )
        jax.block_until_ready(jax.tree_util.tree_leaves(mcube))
        mc_build_s = time.perf_counter() - t0
        run = lambda: multicube_retrieve_topk(
            mcube, c_qs, top_k=TOPK, probes=C_PROBES, per_probe=c_pt)
        jax.block_until_ready(run())
        mc_s = timed(run, reps=5)
        _cs, cids = run()
        mc_recall = float(recall_at_k(cids, c_true))
        log(f"multicube C={C_CUBES} k={CK} probes={C_PROBES}/cube "
            f"window={c_pt} q={CQ}: {mc_s*1e3:.1f} ms -> "
            f"{CQ/mc_s:,.0f} q/s/chip "
            f"(recall {mc_recall:.4f}, build+pack {mc_build_s:.1f}s)")
        cube_points.append({
            "form": "multicube", "cubes": C_CUBES, "k": CK,
            "probes": C_PROBES, "per_probe": c_pt, "batch": CQ,
            "qps": round(CQ / mc_s, 1), "recall": round(mc_recall, 4),
            "dtype": jnp.dtype(c_dtype).name, "directed": True,
        })
        del mcube
        # single-cube directed point (the reference's one-cube shape)
        S_PROBES = int(os.environ.get("BENCH_CUBE_PROBES", 16))
        t0 = time.perf_counter()
        cube = build_hypercube(jax.random.PRNGKey(7), corpus, METRIC, CK, EUC_W)
        cube = pack_cube(cube, corpus, dtype=c_dtype)
        jax.block_until_ready(jax.tree_util.tree_leaves(cube))
        cube_build_s = time.perf_counter() - t0
        run = lambda: cube_retrieve_topk(
            cube, c_qs, corpus, top_k=TOPK, probes=S_PROBES,
            per_probe=976, approx_stage1=True,
        )
        jax.block_until_ready(run())
        cube_s = timed(run, reps=5)
        _cs, cids = run()
        cube_recall = float(recall_at_k(cids, c_true))
        log(f"hypercube k={CK} probes={S_PROBES} window=976 (directed) "
            f"q={CQ}: {cube_s*1e3:.1f} ms -> {CQ/cube_s:,.0f} q/s/chip "
            f"(recall {cube_recall:.4f}, build+pack {cube_build_s:.1f}s)")
        cube_points.append({
            "form": "single", "cubes": 1, "k": CK, "probes": S_PROBES,
            "per_probe": 976, "batch": CQ, "qps": round(CQ / cube_s, 1),
            "recall": round(cube_recall, 4),
            "dtype": jnp.dtype(c_dtype).name, "directed": True,
        })
        del cube
        # euclidean cube datapoint: augmented slabs ride the shared-slab
        # windowed dots (pack_cube augment=True)
        if os.environ.get("BENCH_CUBE_EUC", "1") == "1":
            # w=8 is the single-euclid-cube recall optimum on the planted
            # corpus (narrower cells make the bits noisy, wider ones
            # overcrowd vertices); its ceiling is vertex truncation, the
            # miss-independence argument behind the MultiCube
            EC_W = float(os.environ.get("BENCH_CUBE_EUC_W", 8.0))
            EC_PROBES = int(os.environ.get("BENCH_CUBE_EUC_PROBES", 64))
            t0 = time.perf_counter()
            ecube = build_hypercube(
                jax.random.PRNGKey(7), corpus, "euclidean", CK, EC_W)
            ecube = pack_cube(ecube, corpus, dtype=jnp.int8, augment=True)
            jax.block_until_ready(jax.tree_util.tree_leaves(ecube))
            ec_build_s = time.perf_counter() - t0
            run = lambda: cube_retrieve_topk(
                ecube, c_qs, corpus, top_k=TOPK, probes=EC_PROBES,
                per_probe=976,
            )
            jax.block_until_ready(run())
            ec_s = timed(run, reps=5)
            _cs, cids = run()
            ec_recall = float(recall_at_k(cids, c_true))
            log(f"euclidean cube k={CK} w={EC_W} probes={EC_PROBES} "
                f"(augmented) q={CQ}: {ec_s*1e3:.1f} ms -> "
                f"{CQ/ec_s:,.0f} q/s/chip (recall {ec_recall:.4f}, "
                f"build+pack {ec_build_s:.1f}s)")
            cube_points.append({
                "form": "euclidean_aug", "cubes": 1, "k": CK,
                "w": EC_W, "probes": EC_PROBES, "per_probe": 976,
                "batch": CQ, "qps": round(CQ / ec_s, 1),
                "recall": round(ec_recall, 4),
                "dtype": "int8", "directed": True,
            })
            del ecube
            # euclidean MULTICUBE: the same miss-independence fix as the
            # cosine multicube, on the augmented rank layout — C cubes'
            # segments in one shared-slab call
            EC_C = int(os.environ.get("BENCH_CUBE_EUC_C", 3))
            EC_MPROBES = int(
                os.environ.get("BENCH_CUBE_EUC_MPROBES", 24))
            t0 = time.perf_counter()
            emc = build_multicube(
                jax.random.PRNGKey(7), corpus, "euclidean", EC_C, CK,
                EC_W, corpus_dtype=jnp.int8,
            )
            jax.block_until_ready(jax.tree_util.tree_leaves(emc))
            emc_build_s = time.perf_counter() - t0
            run = lambda: multicube_retrieve_topk(
                emc, c_qs, top_k=TOPK, probes=EC_MPROBES,
                per_probe=976)
            jax.block_until_ready(run())
            emc_s = timed(run, reps=5)
            _cs, cids = run()
            emc_recall = float(recall_at_k(cids, c_true))
            log(f"euclidean multicube C={EC_C} k={CK} w={EC_W} "
                f"probes={EC_MPROBES}/cube q={CQ}: {emc_s*1e3:.1f} ms "
                f"-> {CQ/emc_s:,.0f} q/s/chip (recall {emc_recall:.4f}, "
                f"build+pack {emc_build_s:.1f}s)")
            cube_points.append({
                "form": "euclidean_multicube", "cubes": EC_C, "k": CK,
                "w": EC_W, "probes": EC_MPROBES, "per_probe": 976,
                "batch": CQ, "qps": round(CQ / emc_s, 1),
                "recall": round(emc_recall, 4),
                "dtype": "int8", "directed": True,
            })
            del emc
        # headline preference: fastest >=0.99 point (the multicube
        # frontier), else fastest >=0.95, else max recall — all points
        # ride along in `points`
        hi_pts = [p for p in cube_points if p["recall"] >= 0.99]
        ok_pts = [p for p in cube_points if p["recall"] >= 0.95]
        cube_stats = dict(
            max(hi_pts, key=lambda p: p["qps"]) if hi_pts
            else max(ok_pts, key=lambda p: p["qps"]) if ok_pts
            else max(cube_points, key=lambda p: p["recall"])
        )
        cube_stats["points"] = cube_points

    # ---- recall vs planted ground truth (+ exact-NN spot check) ----
    # HOST_ORACLE (auto at >4M rows): the oracle corpus streams from host
    # memory so the f32 [n, d] copy never sits next to the slabs
    t0 = time.perf_counter()
    # BENCH_SKIP_ORACLE=1: skip the exact-NN spot check (planted truth is
    # exact ground truth by construction) — oracle_agreement reports -1
    if os.environ.get("BENCH_SKIP_ORACLE", "0") == "1":
        oracle_idx = None
    elif HOST_ORACLE:
        from crypto_rec_tpu.ops.oracle import exact_nearest_streamed

        _d, oracle_idx = exact_nearest_streamed(
            queries[:OQ], corpus_host, METRIC, TOPK)
    else:
        _d, oracle_idx = exact_nearest(
            queries[:OQ], corpus, METRIC, TOPK, block_rows=64
        )
    if oracle_idx is None:
        oracle_agree = -1.0
        log("exact oracle SKIPPED (BENCH_SKIP_ORACLE=1)")
    else:
        jax.block_until_ready(oracle_idx)
        # spot check: the exact oracle must agree with the planted truth
        oracle_agree = float(recall_at_k(oracle_idx, true_idx[:OQ]))
        log(f"exact oracle over {OQ} x {N}: {time.perf_counter() - t0:.1f}s "
            f"(agreement with planted truth: {oracle_agree:.4f})")
    log(f"candidate-set recall@{TOPK} = {recall:.4f} (budget={BUDGET}); "
        f"fused top-{TOPK} recall = {fused_recall:.4f}")

    out = {
        "metric": f"lsh_recall@{TOPK}",
        "value": round(fused_recall, 4),
        "unit": "recall",
        "vs_baseline": round(fused_recall / 0.95, 4),
        "qps_per_chip": round(fused_qps, 1),
        # the scored engine (score-ranked sets, round 4) is the candidate
        # engine of record; the count-ranked reference-semantics engine is
        # kept alongside for the trajectory
        "candidate_set_qps": round(
            scored_stats["qps"] if scored_stats else qps, 1),
        "candidate_set_recall": round(
            scored_stats["recall"] if scored_stats else recall, 4),
        "candidate_set_engine": (
            "scored" if scored_stats else "count_ranked"),
        "candidate_set_scored": scored_stats,
        "count_ranked_qps": round(qps, 1),
        "count_ranked_recall": round(recall, 4),
        "oracle_agreement": round(oracle_agree, 4),
        "index_build_s": round(build_s, 3),
        "index_rows_per_s": round(N / build_s, 1),
        "corpus_rows": N,
        "dim": D,
        "distance_metric": METRIC,
        "lsh_k": K,
        "lsh_tables": L,
        "candidate_budget": BUDGET,
        "per_table_window": PT,
        "packed_slabs": bool(per_dtype),
        "pack_dtype": head_name,
        "headline_batch": headline_batch,
        "per_dtype": per_dtype,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
    }
    if cf_stats:
        out["cf"] = cf_stats
    if euc_stats:
        out["euclidean"] = euc_stats
    if cube_stats:
        out["hypercube"] = cube_stats
    print(json.dumps(out))


if __name__ == "__main__":
    main()
