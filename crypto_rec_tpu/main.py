"""CLI driver: python -m crypto_rec_tpu.main -d <input> -o <output> [-validate]

Mirrors the reference binary's interface (/root/reference/main.cpp:489-509):
-d input tweets file, -o output file, -validate for 10-fold CV.  The config
file defaults to ./cluster.conf (main.cpp:48) but is overridable with -c.
"""

from __future__ import annotations

import argparse
import json
import sys

from crypto_rec_tpu.config import RecConfig, load_config
from crypto_rec_tpu.models.rec.pipeline import run_pipeline


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="crypto_rec_tpu")
    p.add_argument("-d", dest="input_file", required=True, help="input tweets file")
    p.add_argument("-o", dest="output_file", required=True, help="output file")
    p.add_argument("-c", dest="config_file", default="./cluster.conf")
    p.add_argument("-validate", action="store_true", dest="validate")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--profile", default=None, metavar="DIR",
        help="write a jax.profiler trace of the whole run to DIR",
    )
    p.add_argument(
        "--silhouette", action="store_true",
        help="evaluate cluster silhouettes in the clustering phases",
    )
    p.add_argument(
        "--engine", choices=("auto", "mask", "csr", "fused"), default=None,
        help="LSH candidate engine: dense mask (reference-exact, O(q*n)) "
             "or CSR fixed-budget retrieval (scalable); default auto",
    )
    p.add_argument(
        "--budget", type=int, default=None,
        help="per-query candidate budget for the csr engine",
    )
    return p


def main(argv=None) -> int:
    from crypto_rec_tpu.utils.compile_cache import enable_compile_cache

    args = build_argparser().parse_args(argv)
    enable_compile_cache()
    cfg = load_config(args.config_file, RecConfig(seed=args.seed))
    if args.engine is not None:
        cfg = cfg.replace(engine=args.engine)
    if args.budget is not None:
        cfg = cfg.replace(candidate_budget=args.budget)
    import contextlib

    trace_ctx = contextlib.nullcontext()
    if args.profile:
        import jax

        trace_ctx = jax.profiler.trace(args.profile)
    with trace_ctx:
        result = run_pipeline(
            args.input_file, args.output_file, cfg,
            validate=args.validate, with_silhouette=args.silhouette,
        )
    summary = {
        "phase_ms": result.phase_ms,
        "n_users": result.n_users,
        "n_fake_users": result.n_fake_users,
    }
    if result.mae is not None:
        summary["mae_10fold"] = result.mae
    if result.silhouettes is not None:
        summary["silhouettes"] = result.silhouettes
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
