"""Hypercube Hamming-distance probe schedules.

The reference enumerates vertices at increasing Hamming distance from the
query vertex with a recursive bit-flip search at query time
(get_num_hamming_dist_from, /root/reference/lib/utils.cpp:22-50, driven by
get_hypercube_combined_buckets, lib/lsh_cube.hpp:139-177).

Batched form: the schedule depends only on (k, probes), NOT on the query — the
probe vertex list is `query_vertex XOR flip_masks` for a fixed mask table.
We precompute the masks host-side once (tiny: at most 2^k entries) and the
query-time work becomes a single vectorized XOR + gather.
"""

from __future__ import annotations

import functools
from itertools import combinations

import numpy as np


@functools.lru_cache(maxsize=None)
def hamming_probe_order(k: int, probes: int) -> np.ndarray:
    """[probes] int32 XOR masks, ordered like the reference probe walk.

    Order: mask 0 (home vertex) first, then all masks of popcount 1, then 2,
    ... — within a distance class the reference enumerates ascending flipped
    bit positions starting from bit 0 (utils.cpp:22-50 flips the LSB-first
    mask and recurses to higher bits), which matches combinations() order
    over bit positions.  Truncated to `probes` total vertices; if probes
    exceeds the cube, the schedule is the whole cube (lsh_cube.hpp:168-172).
    """
    masks = [0]
    for dist in range(1, k + 1):
        for bits in combinations(range(k), dist):
            masks.append(sum(1 << b for b in bits))
    masks = masks[: max(1, min(probes, 1 << k))]
    return np.asarray(masks, dtype=np.int32)
