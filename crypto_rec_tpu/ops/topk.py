"""Top-k / co-sort primitives.

Replaces the reference's recursive "parallel quicksort" that co-sorts a
similarity array with its neighbor array (/root/reference/lib/
crypto_rec.hpp:234-277) with `jax.lax.top_k`, which returns values and the
permutation indexes in one fused op — gathering any payload (neighbor rows,
ids) by index is the array form of "co-sorting pointers".
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

# numpy scalar, NOT jnp: a module-level jnp constant would initialize the
# XLA backend at import time, which breaks jax.distributed.initialize in
# multi-host processes (it must run before any backend init)
NEG_INF = np.float32(-np.inf)


def topk_desc(values: jax.Array, k: int) -> Tuple[jax.Array, jax.Array]:
    """Descending top-k along the last axis -> (values, indices)."""
    return jax.lax.top_k(values, k)


def masked_topk_desc(
    values: jax.Array, mask: jax.Array, k: int
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Top-k over `values` where mask; returns (vals, idx, valid).

    Invalid slots (mask exhausted before k) have valid=False; their idx still
    points at some row but carries -inf value — callers must weight by
    `valid`.  This is the static-shape answer to the reference's dynamically
    sized candidate sets (get_P_closest truncates only when size > P,
    crypto_rec.hpp:225-228).
    """
    masked = jnp.where(mask, values, NEG_INF)
    vals, idx = jax.lax.top_k(masked, k)
    valid = vals > NEG_INF
    return vals, idx, valid


def topn_indices(scores: jax.Array, mask: jax.Array, n: int) -> jax.Array:
    """Indexes of the n best masked scores, -1 where fewer than n are valid.

    The reference's get_top_N_recom resizes to N even when fewer unknown coins
    exist, returning garbage (crypto_rec.hpp:322) — we return -1 sentinels.
    """
    vals, idx = jax.lax.top_k(jnp.where(mask, scores, NEG_INF), n)
    return jnp.where(vals > NEG_INF, idx, -1)
