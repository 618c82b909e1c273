"""Batched distance / similarity kernels.

The reference computes metrics one pair at a time with virtual dispatch
(CustVector::cosineSimilarity / euclideanDistance / cosineDistance,
/root/reference/lib/data_structures/cust_vector.hpp:105-174).  Here the
same math is one matmul per (query-block, index-block) pair:

    cos_sim(A, B) = (A @ B^T) / (|A| |B|)
    ||a - b||^2   = |a|^2 + |b|^2 - 2 a.b

All functions accept [q, d] x [n, d] and return [q, n].  `preferred_element
_type=float32` keeps accumulation in f32 even for bf16 inputs.  `precision`
is the matmul precision: None (DEFAULT) lets a GPU run f32 products in
TF32; the exact oracle passes HIGHEST (ops/oracle.py).

Zero-norm guards mirror the reference: a zero-norm operand yields
similarity 0 (cust_vector.hpp:158-174 divides and would NaN; our users are
never zero vectors because "useless" rows are dropped, but centroids of
empty clusters can be) — we clamp norms to a tiny epsilon instead.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_NORM_EPS = 1e-30


def _dot(a: jax.Array, b: jax.Array, precision=None) -> jax.Array:
    return jax.lax.dot_general(
        a, b,
        dimension_numbers=(((1,), (1,)), ((), ())),
        precision=precision,
        preferred_element_type=jnp.float32,
    )


def cosine_similarity_matrix(
    a: jax.Array, b: jax.Array, precision=None
) -> jax.Array:
    """[q, d] x [n, d] -> [q, n] cosine similarity."""
    dots = _dot(a, b, precision)
    na = jnp.sqrt(jnp.sum(jnp.square(a.astype(jnp.float32)), axis=1))
    nb = jnp.sqrt(jnp.sum(jnp.square(b.astype(jnp.float32)), axis=1))
    denom = jnp.maximum(na[:, None] * nb[None, :], _NORM_EPS)
    return dots / denom


def cosine_distance_matrix(
    a: jax.Array, b: jax.Array, precision=None
) -> jax.Array:
    """1 - cos_sim (cust_vector.hpp:139-155)."""
    return 1.0 - cosine_similarity_matrix(a, b, precision)


def sq_euclidean_distance_matrix(
    a: jax.Array, b: jax.Array, precision=None
) -> jax.Array:
    """Squared L2 via the |a|^2 + |b|^2 - 2ab identity (never negative)."""
    dots = _dot(a, b, precision)
    na = jnp.sum(jnp.square(a.astype(jnp.float32)), axis=1)
    nb = jnp.sum(jnp.square(b.astype(jnp.float32)), axis=1)
    d2 = na[:, None] + nb[None, :] - 2.0 * dots
    return jnp.maximum(d2, 0.0)


def euclidean_distance_matrix(
    a: jax.Array, b: jax.Array, precision=None
) -> jax.Array:
    return jnp.sqrt(sq_euclidean_distance_matrix(a, b, precision))


def pairwise_distances(
    a: jax.Array, b: jax.Array, metric: str, precision=None
) -> jax.Array:
    """Metric dispatch matching the reference's string dispatch
    (e.g. assignment.hpp:60-65)."""
    if metric == "euclidean":
        return euclidean_distance_matrix(a, b, precision)
    if metric == "cosine":
        return cosine_distance_matrix(a, b, precision)
    raise ValueError(f"unknown metric {metric!r}")


@functools.partial(jax.jit, static_argnames=("metric", "block_rows"))
def blocked_pairwise_distances(
    a: jax.Array, b: jax.Array, metric: str, block_rows: int = 4096
) -> jax.Array:
    """Same as pairwise_distances but streams `a` in row blocks via lax.map so
    huge [q, n] products never materialize more than [block, n] at once."""
    q = a.shape[0]
    pad = (-q) % block_rows
    a_pad = jnp.pad(a, ((0, pad), (0, 0)))
    blocks = a_pad.reshape(-1, block_rows, a.shape[1])
    out = jax.lax.map(lambda blk: pairwise_distances(blk, b, metric), blocks)
    return out.reshape(-1, b.shape[0])[:q]
