"""Configuration for the recommendation pipeline.

Replaces the reference's ad-hoc flag machinery (ArgParser over flattened
config-file tokens, /root/reference/main.cpp:512-554 + lib/in_out/arg_parser.cpp)
with a single dataclass.  Every key of the reference's cluster.conf is
preserved — including `cube_range_c`, `cube_probes` and `metric_type`, which
the reference file declares but `get_config` never reads (main.cpp:512-554).

Unlike the reference (time-seeded RNG everywhere, e.g. lsh_cube.hpp:49-51),
all randomness flows from one explicit `seed`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class RecConfig:
    # --- LSH (reference defaults: main.cpp:56-59) ---
    k: int = 4                     # hash functions per table ("number_of_hash_functions")
    L: int = 5                     # number of tables ("number_of_hash_tables")
    lsh_bucket_div: int = 4        # euclidean tables get n/lsh_bucket_div buckets (lsh_cube.hpp:61)
    euclidean_h_w: float = 0.01    # p-stable window w (euclidean_h_gen.hpp)

    # --- hypercube (declared in cluster.conf:16-17; reference never reads them) ---
    cube_probes: int = 5
    cube_range_c: float = 1.0

    # --- clustering (main.cpp:55,60-61) ---
    cluster_num: int = 30          # "number_of_clusters"
    proj2_cluster_num: int = 100   # "proj_2_number_of_clusters"
    max_algo_iterations: int = 30
    min_dist_kmeans: float = 0.05
    metric_type: str = "cosine"

    # --- file inputs (cluster.conf:4-26) ---
    proj2_input: str = ""
    proj2_csv_delimiter: str = " "
    csv_delimiter: str = " "
    lexicon_file: str = ""
    query_file: str = ""

    # --- engine knobs new to this build ---
    seed: int = 0
    candidate_budget: int = 256    # fixed per-query candidate budget for CSR path
    topP: int = 20                 # P; usually overridden by the dataset header line
    block_rows: int = 4096         # row-block size for blocked distance matmuls
    # LSH candidate engine for the pipeline's LSH phases:
    #   "mask" — dense [q, n] candidate mask, exact reference semantics,
    #            O(q*n) memory (fine to ~10^5 users);
    #   "csr"  — fixed-budget CSR retrieval (candidate_ids) + gathered
    #            scoring (recommend_from_ids), O(q*budget) memory — the
    #            scalable engine, identical output whenever candidate_budget
    #            covers each query's bucket union;
    #   "fused" — packed fused retrieval straight to the top-P neighbors
    #            (retrieve_topk + recommend_topk_retrieved): the fastest
    #            engine; window truncation (candidate_budget rows per
    #            table) is the recall tradeoff;
    #   "auto" — csr when the mask would exceed ~256 MB, else mask.
    engine: str = "auto"
    # Slab dtype for the fused engine's packed index ("float32" at
    # reference scale; "bfloat16"/"int8" halve/quarter slab memory at
    # large user counts, at a quantization cost to recall).
    pack_dtype: str = "float32"

    def replace(self, **kw) -> "RecConfig":
        return dataclasses.replace(self, **kw)


# cluster.conf key -> (field name, parser).  The csv_delimiter key holds an
# ASCII code in the reference (cluster.conf:12, main.cpp:544-546).
_CONF_KEYS = {
    "number_of_clusters": ("cluster_num", int),
    "proj_2_input": ("proj2_input", str),
    "proj_2_csv_delimiter": ("proj2_csv_delimiter", str),
    "proj_2_number_of_clusters": ("proj2_cluster_num", int),
    "number_of_hash_functions": ("k", int),
    "number_of_hash_tables": ("L", int),
    "lsh_bucket_div": ("lsh_bucket_div", int),
    "euclidean_h_w": ("euclidean_h_w", float),
    "max_algo_iterations": ("max_algo_iterations", int),
    "min_dist_kmeans": ("min_dist_kmeans", float),
    "csv_delimiter": ("csv_delimiter", lambda s: chr(int(s))),
    "lexicon_file": ("lexicon_file", str),
    "query_file": ("query_file", str),
    "cube_probes": ("cube_probes", int),
    "cube_range_c": ("cube_range_c", float),
    "metric_type": ("metric_type", str),
}


def load_config(path: str, base: Optional[RecConfig] = None) -> RecConfig:
    """Parse a reference-format config file (space-delimited key/value lines).

    The reference flattens all file tokens into one flag list and looks up the
    token following each key (main.cpp:516, utils.cpp:53-69); `//` comments are
    skipped only because they are unknown flags.  We parse line-by-line: first
    token is the key, second is the value, anything from `//` on is a comment.
    """
    cfg = base or RecConfig()
    updates = {}
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("//"):
                continue
            if "//" in line:
                line = line.split("//", 1)[0].strip()
            toks = line.split()
            if len(toks) < 2:
                continue
            key, val = toks[0], toks[1]
            if key in _CONF_KEYS:
                field, parse = _CONF_KEYS[key]
                updates[field] = parse(val)
    return cfg.replace(**updates)
