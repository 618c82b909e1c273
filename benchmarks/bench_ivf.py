"""IVF (clustered re-ranking) benchmark on the planted-truth corpus —
the same protocol as bench.py so LSH and IVF numbers are comparable.

Usage: BENCH_N=2000000 python benchmarks/bench_ivf.py
Knobs: BENCH_N/D/Q, IVF_CLUSTERS (default N/1024), IVF_NPROBE (default 16),
IVF_TRAIN (k-means training rows, default 262144), BENCH_BF16.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from crypto_rec_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np
import jax
import jax.numpy as jnp


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main() -> None:
    N = int(os.environ.get("BENCH_N", 2_000_000))
    D = int(os.environ.get("BENCH_D", 128))
    Q = int(os.environ.get("BENCH_Q", 8192))
    TOPK = 10
    K = int(os.environ.get("IVF_CLUSTERS", max(64, N // 1024)))
    NPROBE = int(os.environ.get("IVF_NPROBE", 16))
    TRAIN = int(os.environ.get("IVF_TRAIN", 1 << 18))
    # bf16 blocks are built directly (cast fused into the packing gather),
    # so they are safe — and necessary — at any scale
    BF16 = os.environ.get("BENCH_BF16", "1") == "1"

    from crypto_rec_tpu.models.ivf import build_ivf, ivf_retrieve_topk
    from crypto_rec_tpu.ops.oracle import recall_at_k

    dev = jax.devices()[0]
    log(f"device: {dev}  N={N} D={D} Q={Q} clusters={K} nprobe={NPROBE}")
    key = jax.random.PRNGKey(0)
    from crypto_rec_tpu.io.synth import planted_clustered_corpus

    corpus, queries, true_idx = planted_clustered_corpus(key, N, D, Q, TOPK)
    corpus = jax.block_until_ready(corpus)
    log("corpus ready")

    t0 = time.perf_counter()
    index = build_ivf(
        jax.random.PRNGKey(1), corpus, K, metric="cosine",
        max_iterations=8, train_rows=min(TRAIN, N),
        block_dtype=jnp.bfloat16 if BF16 else None,
    )
    jax.block_until_ready(index.blocks)
    build_s = time.perf_counter() - t0
    cap = index.capacity
    log(f"ivf build (incl. compile): {build_s:.1f}s, capacity={cap}, "
        f"dropped={index.dropped_rows}, rows/query={NPROBE * cap}")


    # nprobe sweep: the standard IVF quality/speed knob.  Report the fastest
    # operating point whose recall (verified against the planted truth)
    # clears the 0.95 target with margin; IVF_NPROBE pins a single value.
    probes = (
        [NPROBE]
        if "IVF_NPROBE" in os.environ
        else sorted({2, 4, 8, NPROBE})
    )
    sweep = {}
    best = None
    for np_i in probes:
        vals, ids = ivf_retrieve_topk(index, queries, np_i, TOPK)
        jax.block_until_ready(ids)
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            vals, ids = ivf_retrieve_topk(index, queries, np_i, TOPK)
            jax.device_get(ids.ravel()[0])
            times.append(time.perf_counter() - t0)
        q_s = float(np.median(times))
        r = float(recall_at_k(ids, true_idx))
        sweep[np_i] = {"qps": round(Q / q_s, 1), "recall": round(r, 4)}
        log(f"nprobe={np_i}: {q_s*1e3:.1f} ms -> {Q/q_s:,.0f} q/s/chip; "
            f"recall@{TOPK}={r:.4f}")
        if r >= 0.97 and (best is None or Q / q_s > sweep[best]["qps"]):
            best = np_i
    if best is None:  # nothing cleared the bar; report the most accurate
        best = max(sweep, key=lambda p: sweep[p]["recall"])
    qps, recall = sweep[best]["qps"], sweep[best]["recall"]

    print(json.dumps({
        "metric": "ivf_recall@10",
        "value": round(recall, 4),
        "unit": "recall",
        "vs_baseline": round(recall / 0.95, 4),
        "qps_per_chip": round(qps, 1),
        "build_s": round(build_s, 2),
        "clusters": K,
        "nprobe": best,
        "nprobe_sweep": sweep,
        "capacity": cap,
        "dropped_rows": index.dropped_rows,
        "corpus_rows": N,
        "bf16": BF16,
        "platform": dev.platform,
    }))


if __name__ == "__main__":
    main()
