"""Synthetic dataset generation in the reference's file formats.

Produces the four files the reference pipeline consumes (main.cpp:120-123):
tokenized tweets (with the "P <value>" header line), coin query variations,
a sentiment lexicon, and "project 2" tweet-embedding vectors — plus a
cluster.conf.  Used by the e2e tests and the benchmark harness; written from
scratch against the formats documented in io/readers.py.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

import functools as _functools

import jax as _jax


@_functools.partial(
    _jax.jit,
    static_argnames=(
        "n", "d", "n_queries", "top_k", "n_centers",
        "cluster_noise", "planted_noise", "n_chunks",
    ),
)
def planted_clustered_corpus(
    key,
    n: int,
    d: int,
    n_queries: int,
    top_k: int,
    n_centers: int = 0,
    cluster_noise: float = 0.3,
    planted_noise: float = 0.15,
    n_chunks: int = 32,
):
    """Clustered corpus with planted ground truth, generated in one pass.

    jit over the whole generator: one dispatch instead of a dozen eager
    ones.

    Returns (corpus [n, d], queries [n_queries, d], true_idx [n_queries,
    top_k]).  Rows [0, n_queries * top_k) are each query's planted true
    neighbors (query + planted_noise), the rest are cluster points
    (center + cluster_noise).  Built chunk-by-chunk inside one lax.map so
    peak device memory is the corpus itself plus one chunk — no concat or
    slice copies (a naive gather+noise+concat holds ~3x the corpus).

    Used by bench.py / benchmarks/* as the recall benchmark protocol: the
    planted rows are the unambiguous top-k (distance margin ~2x), so recall
    measures retrieval rather than float-noise tie ordering.
    """
    import jax
    import jax.numpy as jnp

    if n_centers <= 0:
        n_centers = max(1024, n // 128)
    kc, kq, kb, kn, kg = jax.random.split(key, 5)
    centers = jax.random.normal(kc, (n_centers, d), jnp.float32) * 2.0
    queries = (
        centers[jax.random.randint(kb, (n_queries,), 0, n_centers)]
        + cluster_noise * jax.random.normal(kq, (n_queries, d), jnp.float32)
    )
    n_planted = n_queries * top_k

    pad = (-n) % n_chunks
    total = n + pad
    chunk = total // n_chunks

    def gen_chunk(args):
        ci, ck = args
        ka, kb2, kc2 = jax.random.split(ck, 3)
        rows = ci * chunk + jnp.arange(chunk)
        cidx = jax.random.randint(ka, (chunk,), 0, n_centers)
        cluster_rows = centers[cidx] + cluster_noise * jax.random.normal(
            kb2, (chunk, d), jnp.float32
        )
        qidx = jnp.clip(rows // top_k, 0, n_queries - 1)
        planted_rows = queries[qidx] + planted_noise * jax.random.normal(
            kc2, (chunk, d), jnp.float32
        )
        return jnp.where((rows < n_planted)[:, None], planted_rows, cluster_rows)

    corpus = jax.lax.map(
        gen_chunk,
        (jnp.arange(n_chunks), jax.random.split(kg, n_chunks)),
    ).reshape(total, d)
    if pad:
        corpus = corpus[:n]
    true_idx = (
        jnp.arange(n_queries, dtype=jnp.int32)[:, None] * top_k
        + jnp.arange(top_k, dtype=jnp.int32)[None, :]
    )
    return corpus, queries, true_idx


COIN_NAMES = [
    "bitcoin", "ethereum", "ripple", "litecoin", "cardano",
    "polkadot", "stellar", "dogecoin", "monero", "tezos",
    "eos", "tron", "cosmos", "iota", "dash",
]


def write_synthetic_dataset(
    out_dir: str,
    n_users: int = 60,
    n_tweets: int = 400,
    n_coins: int = 8,
    emb_dim: int = 16,
    p_header: int = 4,
    seed: int = 0,
) -> Tuple[str, str]:
    """Create dataset files under out_dir; returns (input_file, conf_file)."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    n_coins = min(n_coins, len(COIN_NAMES))

    # lexicon: positive + negative words, tab-separated
    pos_words = [f"goodword{i}" for i in range(30)]
    neg_words = [f"badword{i}" for i in range(30)]
    lex_path = os.path.join(out_dir, "lexicon.tsv")
    with open(lex_path, "w") as f:
        for w in pos_words:
            f.write(f"{w}\t{rng.uniform(0.5, 3.0):.3f}\n")
        for w in neg_words:
            f.write(f"{w}\t{-rng.uniform(0.5, 3.0):.3f}\n")

    # coin queries: each row = variations; column 4 is the display name
    coins_path = os.path.join(out_dir, "coins.tsv")
    with open(coins_path, "w") as f:
        for i in range(n_coins):
            base = COIN_NAMES[i]
            row = [base, base.upper(), base[:3], f"#{base}", base.capitalize()]
            f.write("\t".join(row) + "\n")

    # tweets: "user tweet_id w1 w2 ..." with P header
    tweets_path = os.path.join(out_dir, "tweets.tsv")
    # users have latent coin preferences; positive words for liked coins
    prefs = rng.random((n_users, n_coins))
    with open(tweets_path, "w") as f:
        f.write(f"P\t{p_header}\n")
        for t in range(n_tweets):
            u = int(rng.integers(0, n_users))
            coin = int(rng.integers(0, n_coins))
            liked = prefs[u, coin] > 0.4
            words = list(
                rng.choice(pos_words if liked else neg_words, size=rng.integers(1, 5))
            )
            words.append(COIN_NAMES[coin])
            if rng.random() < 0.3:
                words.append(COIN_NAMES[coin].upper())
            f.write("\t".join([f"user{u}", f"tw{t}"] + words) + "\n")

    # proj-2 embeddings: one vector per tweet id (comma-separated)
    emb_path = os.path.join(out_dir, "proj2.csv")
    with open(emb_path, "w") as f:
        for t in range(n_tweets):
            vec = rng.normal(size=emb_dim)
            f.write(",".join([f"tw{t}"] + [f"{v:.5f}" for v in vec]) + "\n")

    conf_path = os.path.join(out_dir, "cluster.conf")
    with open(conf_path, "w") as f:
        f.write(
            "\n".join(
                [
                    f"proj_2_input {emb_path}",
                    "proj_2_csv_delimiter ,",
                    "proj_2_number_of_clusters 10",
                    "number_of_clusters 6",
                    "number_of_hash_functions 4",
                    "number_of_hash_tables 5",
                    "csv_delimiter 9 // ASCII tab",
                    "lsh_bucket_div 4",
                    "euclidean_h_w 0.4",
                    "cube_probes 5",
                    "cube_range_c 1",
                    "max_algo_iterations 10",
                    "min_dist_kmeans 0.05",
                    "metric_type cosine",
                    f"lexicon_file {lex_path}",
                    f"query_file {coins_path}",
                ]
            )
            + "\n"
        )
    return tweets_path, conf_path
