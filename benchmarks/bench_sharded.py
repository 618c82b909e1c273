"""Sharded-retrieval scaling benchmark (BASELINE.json config 4 analog).

Runs the (dp, mp) sharded recommend on the device mesh of the devices
JAX finds and reports per-configuration throughput.  It needs at least two
devices and stops with an error on fewer; to rehearse on a CPU, give the
CPU backend virtual devices:

  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python benchmarks/bench_sharded.py

Usage: python benchmarks/bench_sharded.py [--rows 65536]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=65536)
    ap.add_argument("--queries", type=int, default=2048)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--top-p", type=int, default=16)
    ap.add_argument("--kernel-point", action="store_true", default=False,
                    help="measure the packed sharded engine on a 1-device "
                         "mesh vs the local windowed path at the 2M "
                         "operating point: the shard_map + all_gather "
                         "merge overhead")
    args = ap.parse_args()
    from crypto_rec_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.kernel_point:
        kernel_point()
        return

    import jax

    if len(jax.devices()) < 2:
        sys.exit(f"bench_sharded needs >= 2 devices, found "
                 f"{len(jax.devices())} ({jax.devices()[0].platform})")
    block = jax.block_until_ready

    import jax.numpy as jnp
    import numpy as np
    from crypto_rec_tpu.models.rec.engine import RatingSet, recommend
    from crypto_rec_tpu.parallel.mesh import make_mesh
    from crypto_rec_tpu.parallel.sharded import shard_rating_set, sharded_recommend

    devs = jax.devices()
    print(f"devices: {len(devs)} x {devs[0].platform}", file=sys.stderr)

    key = jax.random.PRNGKey(0)
    kq, kn, km = jax.random.split(key, 3)
    C = args.dim
    q_r = jnp.abs(jax.random.normal(kq, (args.queries, C), jnp.float32))
    n_r = jnp.abs(jax.random.normal(kn, (args.rows, C), jnp.float32))
    mk = jax.random.uniform(km, (args.queries, args.rows)) < 0.05
    queries = RatingSet(q_r, q_r > 0.5, jnp.mean(q_r, axis=1))
    neighbors = RatingSet(n_r, n_r > 0.5, jnp.mean(n_r, axis=1))

    results = {}
    # single-device baseline
    t0 = time.perf_counter()
    rec1 = recommend(queries, neighbors, mk, top_p=args.top_p, top_n=5)
    block(rec1.predicted)
    t0 = time.perf_counter()
    rec1 = recommend(queries, neighbors, mk, top_p=args.top_p, top_n=5)
    block(rec1.predicted)
    results["single"] = time.perf_counter() - t0

    for mp in (2, 4, len(devs)):
        if mp > len(devs):
            continue
        mesh = make_mesh((1, mp), devices=devs[:mp])
        nb = shard_rating_set(mesh, neighbors, "mp")
        rec = sharded_recommend(mesh, queries, nb, mk, top_p=args.top_p, top_n=5)
        block(rec.predicted)
        t0 = time.perf_counter()
        rec = sharded_recommend(mesh, queries, nb, mk, top_p=args.top_p, top_n=5)
        block(rec.predicted)
        results[f"mp={mp}"] = time.perf_counter() - t0
        # parity vs single-device
        np.testing.assert_allclose(
            np.asarray(rec.predicted), np.asarray(rec1.predicted), atol=1e-3
        )

    out = {
        "metric": "sharded_recommend_s",
        "queries": args.queries,
        "rows": args.rows,
        "platform": devs[0].platform,
        "timings_s": {k: round(v, 4) for k, v in results.items()},
        "qps": {k: round(args.queries / v, 1) for k, v in results.items()},
    }
    print(json.dumps(out))


def kernel_point() -> None:
    """Comparison at the 2M operating point: local windowed retrieval vs
    the sharded engine on a 1-device (dp=1, mp=1) mesh.

    mp=1 makes the shard_map body identical work to the local path, so
    sharded_qps / local_qps isolates the shard_map + all_gather merge
    machinery."""
    import time

    import numpy as np
    import jax
    import jax.numpy as jnp

    from crypto_rec_tpu.io.synth import planted_clustered_corpus
    from crypto_rec_tpu.models.lsh.index import (
        build_index, pack_index, retrieve_topk_pallas,
    )
    from crypto_rec_tpu.ops.oracle import recall_at_k
    from crypto_rec_tpu.parallel.mesh import make_mesh
    from crypto_rec_tpu.parallel.sharded_index import (
        build_sharded_index, pack_sharded_index, shard_corpus,
        sharded_retrieve_topk,
    )
    block = jax.block_until_ready

    N = int(os.environ.get("BENCH_N", 2_000_000))
    D, Q, K, L, PT, TOPK = 128, 8192, 13, 8, 488, 10

    def timed(fn, reps=5):
        out, times = None, []
        for _ in range(reps):
            del out
            t0 = time.perf_counter()
            out = fn()
            block(out)
            times.append(time.perf_counter() - t0)
        return float(np.median(times))

    key = jax.random.PRNGKey(0)
    corpus, queries, true_idx = planted_clustered_corpus(key, N, D, Q, TOPK)
    corpus, queries = block(corpus), block(queries)

    # local kernel path
    idx = build_index(jax.random.PRNGKey(1), corpus, "cosine", K, L,
                      lsh_bucket_div=4, euclidean_h_w=1.0)
    pidx = pack_index(idx, corpus, dtype=jnp.int8)
    block(jax.tree_util.tree_leaves(pidx))
    run_local = lambda: retrieve_topk_pallas(
        pidx, queries, corpus, top_k=TOPK, per_table=PT, int8_rerank=False)
    block(run_local())
    t_local = timed(run_local)
    _s, lids = run_local()
    local_rec = float(recall_at_k(lids, true_idx))
    del pidx, idx

    # sharded engine, 1-device mesh
    mesh = make_mesh((1, 1), devices=jax.devices()[:1])
    corpus_sh = shard_corpus(mesh, corpus)
    sidx = build_sharded_index(
        mesh, jax.random.PRNGKey(1), corpus_sh, "cosine", K, L)
    sidx = pack_sharded_index(mesh, sidx, corpus_sh, dtype=jnp.int8)
    block(jax.tree_util.tree_leaves(sidx))
    run_sh = lambda: sharded_retrieve_topk(
        mesh, sidx, queries, corpus_sh, budget=1024, top_k=TOPK,
        per_table=PT, int8_rerank=False)
    block(run_sh())
    t_sh = timed(run_sh)
    _ss, sids = run_sh()
    sh_rec = float(recall_at_k(sids, true_idx))

    out = {
        "metric": "sharded_kernel_point",
        "rows": N, "queries": Q, "platform": jax.devices()[0].platform,
        "local_qps": round(Q / t_local, 1),
        "local_recall": round(local_rec, 4),
        "sharded_mp1_qps": round(Q / t_sh, 1),
        "sharded_mp1_recall": round(sh_rec, 4),
        "shard_map_overhead": round(t_sh / t_local, 3),
    }
    print(json.dumps(out))

if __name__ == "__main__":
    main()
