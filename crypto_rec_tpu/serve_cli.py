"""Serving CLI: answer queries from a checkpointed index.

The reference rebuilds all state every run (SURVEY.md §5); this CLI is the
restore-and-serve path that checkpoint.py exists for.

Modes:
  retrieve  — nearest-neighbor lookups against a saved LSH index + corpus:
      python -m crypto_rec_tpu.serve_cli retrieve \
          --index idx.npz --corpus corpus.npz --queries q.csv \
          --top-k 10 -o out.tsv
      (corpus.npz: {"vectors": [n, d]}; queries: "id,v1,v2,..." rows)
  recommend — top-N coin recommendations for users of a saved UserMatrix:
      python -m crypto_rec_tpu.serve_cli recommend \
          --users users.npz --coins coins.tsv --top-n 5 -o out.txt
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="crypto_rec_tpu.serve_cli")
    sub = p.add_subparsers(dest="mode", required=True)

    r = sub.add_parser("retrieve")
    r.add_argument("--index", required=True)
    r.add_argument("--corpus", required=True)
    r.add_argument("--queries", required=True)
    r.add_argument("--delimiter", default=",")
    r.add_argument("--top-k", type=int, default=10)
    r.add_argument("--per-table", type=int, default=256)
    r.add_argument(
        "--pack", action="store_true",
        help="attach the packed-slab layout after restore (L extra bf16 "
             "corpus copies, read as contiguous windows)",
    )
    r.add_argument(
        "--augment", action="store_true",
        help="with --pack on a euclidean index: norm-augmented slabs so "
             "retrieval rides the windowed slab dots",
    )
    r.add_argument(
        "--fast-int8", action="store_true",
        help="global-scale int8 indexes: rank raw dots and dequantize the "
             "scores (skip the exact rerank) — fastest mode when score "
             "margins dominate ~1%% quantization noise",
    )
    r.add_argument("-o", dest="output", required=True)

    c = sub.add_parser("recommend")
    c.add_argument("--users", required=True)
    c.add_argument("--coins", required=True)
    c.add_argument("--delimiter", default="\t")
    c.add_argument("--top-n", type=int, default=5)
    c.add_argument("--top-p", type=int, default=20)
    c.add_argument("--lsh-k", type=int, default=4)
    c.add_argument("--lsh-l", type=int, default=5)
    c.add_argument("--seed", type=int, default=0)
    c.add_argument("-o", dest="output", required=True)
    return p


def _retrieve(args) -> int:
    import jax.numpy as jnp
    from crypto_rec_tpu.checkpoint import load_index
    from crypto_rec_tpu.io.readers import read_dense_vectors
    from crypto_rec_tpu.models.lsh.index import retrieve_topk

    index = load_index(args.index)
    with np.load(args.corpus) as z:
        corpus = jnp.asarray(z["vectors"])
    if corpus.shape[0] != index.n_rows:
        print(
            f"error: corpus rows {corpus.shape[0]} != index rows {index.n_rows}",
            file=sys.stderr,
        )
        return 1
    ids, queries = read_dense_vectors(args.queries, args.delimiter)
    if args.pack:
        if index.packed is not None:
            # checkpoint already carries the packed-slab layout (v2): serve
            # without the multi-second re-pack
            print("restored packed slabs from checkpoint", file=sys.stderr)
        else:
            from crypto_rec_tpu.models.lsh.index import pack_index

            index = pack_index(index, corpus, augment=args.augment)
    t0 = time.perf_counter()
    scores, rows = retrieve_topk(
        index, jnp.asarray(queries), corpus,
        top_k=args.top_k, per_table=args.per_table,
        int8_rerank=not args.fast_int8,
    )
    scores, rows = np.asarray(scores), np.asarray(rows)
    dt = time.perf_counter() - t0
    with open(args.output, "w") as out:
        for i, qid in enumerate(ids):
            pairs = [
                f"{int(r)}:{s:.5f}"
                for r, s in zip(rows[i], scores[i]) if r >= 0
            ]
            out.write("\t".join([qid] + pairs) + "\n")
    print(
        f"{len(ids)} queries in {dt*1e3:.1f} ms ({len(ids)/max(dt,1e-9):,.0f} q/s)",
        file=sys.stderr,
    )
    return 0


def _recommend(args) -> int:
    import jax
    from crypto_rec_tpu.checkpoint import load_user_matrix
    from crypto_rec_tpu.io.ingest import CoinTable
    from crypto_rec_tpu.io.readers import read_str_vectors, write_recommendations
    from crypto_rec_tpu.models.lsh.index import build_index, candidate_mask
    from crypto_rec_tpu.models.rec.engine import RatingSet, recommend

    um = load_user_matrix(args.users)
    coins = CoinTable.from_rows(read_str_vectors(args.coins, args.delimiter)[0])
    users = RatingSet.from_user_matrix(um)
    index = build_index(
        jax.random.PRNGKey(args.seed), users.ratings, "cosine",
        args.lsh_k, args.lsh_l, 4, 1.0,
    )
    mask = candidate_mask(index, users.ratings)
    rec = recommend(users, users, mask, top_p=args.top_p, top_n=args.top_n)
    top = np.asarray(rec.top_n)
    has = np.asarray(rec.has_neighbors)
    with open(args.output, "w") as out:
        for i, uid in enumerate(um.ids):
            if has[i]:
                write_recommendations(out, uid, top[i], coins.queries)
    print(f"recommended for {int(has.sum())}/{len(um.ids)} users", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    from crypto_rec_tpu.utils.compile_cache import enable_compile_cache

    args = build_argparser().parse_args(argv)
    enable_compile_cache()
    return _retrieve(args) if args.mode == "retrieve" else _recommend(args)


if __name__ == "__main__":
    sys.exit(main())
