"""Standalone clustering CLI over reference-format vector files.

The reference's lineage is a two-part project; part one ("assignment 2") is
an LSH/hypercube/clustering toolkit whose library the recommender reuses
(SURVEY.md overview).  This CLI exposes that toolkit capability directly:
read "id delim v1 v2 ..." vectors, cluster with any init x assignment x
update combination, report per-cluster sizes, silhouettes and timings.

Usage:
  python -m crypto_rec_tpu.cluster_cli -i vectors.csv -o out.txt \
      [-c cluster.conf] [--metric euclidean] [--init kmeans++] \
      [--assignment lloyd|lsh|cube] [--update kmeans|pam] [--complete]

--complete prints full centroid coordinates (the reference's verbose mode
convention for this assignment family).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from crypto_rec_tpu.config import RecConfig, load_config
from crypto_rec_tpu.io.readers import read_dense_vectors


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="crypto_rec_tpu.cluster_cli")
    p.add_argument("-i", dest="input_file", required=True)
    p.add_argument("-o", dest="output_file", required=True)
    p.add_argument("-c", dest="config_file", default=None)
    p.add_argument("--delimiter", default=",")
    p.add_argument("--metric", default=None, choices=["euclidean", "cosine"])
    p.add_argument("--init", default="kmeans++", choices=["kmeans++", "random"])
    p.add_argument(
        "--assignment", default="lloyd", choices=["lloyd", "lsh", "cube"]
    )
    p.add_argument("--update", default="kmeans", choices=["kmeans", "pam"])
    p.add_argument("--clusters", type=int, default=None)
    p.add_argument("--complete", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv=None) -> int:
    from crypto_rec_tpu.utils.compile_cache import enable_compile_cache

    args = build_argparser().parse_args(argv)
    enable_compile_cache()
    cfg = RecConfig(seed=args.seed)
    if args.config_file:
        cfg = load_config(args.config_file, cfg)
    metric = args.metric or cfg.metric_type
    k = args.clusters or cfg.cluster_num

    import jax
    import jax.numpy as jnp
    from crypto_rec_tpu.models.cluster.driver import cluster
    from crypto_rec_tpu.models.cluster.silhouette import silhouette

    try:
        ids, mat = read_dense_vectors(args.input_file, args.delimiter)
    except OSError as e:
        print(f"error: cannot read {args.input_file}: {e}", file=sys.stderr)
        return 1
    if mat.shape[0] == 0:
        print(f"error: no vectors read from {args.input_file}", file=sys.stderr)
        return 1
    k = max(1, min(k, mat.shape[0]))
    x = jnp.asarray(mat)

    t0 = time.perf_counter()
    res = cluster(
        jax.random.PRNGKey(cfg.seed), x, k, metric,
        init=args.init, assignment=args.assignment, update=args.update,
        max_iterations=cfg.max_algo_iterations, min_dist=cfg.min_dist_kmeans,
        lsh_k=cfg.k, lsh_l=cfg.L, lsh_bucket_div=cfg.lsh_bucket_div,
        euclidean_h_w=cfg.euclidean_h_w, probes=cfg.cube_probes,
    )
    jax.block_until_ready(res.labels)
    cluster_ms = int((time.perf_counter() - t0) * 1000)

    sil = np.asarray(silhouette(x, res.labels, res.centroids, k, metric))
    labels = np.asarray(res.labels)
    centroids = np.asarray(res.centroids)

    with open(args.output_file, "w", encoding="utf-8") as out:
        out.write(
            f"Algorithm: I{args.init}A{args.assignment}U{args.update}\n"
        )
        out.write(f"Metric: {metric}\n")
        for c in range(k):
            members = np.where(labels == c)[0]
            out.write(f"CLUSTER-{c + 1} {{size: {len(members)}")
            if args.complete:
                out.write(
                    ", centroid: ["
                    + ", ".join(f"{v:.6f}" for v in centroids[c])
                    + "], members: ["
                    + ", ".join(ids[i] for i in members)
                    + "]"
                )
            else:
                out.write(
                    ", centroid: ["
                    + ", ".join(f"{v:.6f}" for v in centroids[c][:8])
                    + (", ..." if centroids.shape[1] > 8 else "")
                    + "]"
                )
            out.write("}\n")
        out.write(f"clustering_time: {cluster_ms / 1000.0:.3f}\n")
        out.write(
            "Silhouette: ["
            + ", ".join(f"{s:.4f}" for s in sil)
            + "]\n"
        )
    print(
        f"clustered {mat.shape[0]} vectors into {k} clusters "
        f"({cluster_ms} ms, silhouette {sil[-1]:.4f})",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
