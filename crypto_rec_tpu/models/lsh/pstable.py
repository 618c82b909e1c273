"""p-stable (euclidean / E2LSH) LSH.

Reference semantics:
* one h-function: v ~ N(0,1)^d, t ~ U(0, w); h(x) = floor((v.x + t) / w)
  (/root/reference/lib/generators/euclidean_h_gen.hpp:58-82);
* one phi (g) function: k h's plus random integer weights r_i in [0, 100];
  phi(x) = mod(sum_i mod(r_i * h_i, M), M) with M "2^32 - 5"
  (euclidean_phi_gen.hpp:60-97).  The reference's `int M = pow(2,32)-5`
  overflows int (impl-defined constant) and the products overflow too —
  its "modular" hash is really wrap-around arithmetic.  We use deliberate
  int32 wrap-around multiply-add (the same class of hash, well-distributed,
  and deterministic) rather than replicating accidental UB;
* the table keeps each inserted vector's k h-values ("detailed hash") so a
  query only matches bucket members whose full k-tuple equals its own
  (euclidean_phi_gen.hpp:83-94, cust_hashtable.hpp:73-103).

h-values for all n vectors, L tables and k functions come from a single
[n, d] x [d, L*k] matmul + floor; phi is a tiny weighted reduction.
The "detailed hash" filter stores ONE int32 murmur-style FINGERPRINT of the
k-tuple per (row, table) instead of the raw [n, L, k] tuples — equality of
fingerprints stands in for equality of tuples.  Two reasons:

* memory: the [L, n] fingerprint plane is k x smaller than [n, L, k]
  int32 tuples, and has no tiny minor dimension for a tiled layout to pad;
* compare cost: the query-time filter is one int compare per candidate
  instead of k.

A fingerprint collision (probability ~2^-32 per compared pair) can only
ADMIT a candidate the exact-tuple filter would have dropped — it can never
reject a true tuple match — so recall is unaffected and the only effect is
one extra (low-scoring) candidate entering the ranking.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=("proj", "offsets", "weights"),
    meta_fields=("w", "k", "L"),
)
@dataclasses.dataclass
class PStableLsh:
    proj: jax.Array     # [d, L * k] float32 v-vectors
    offsets: jax.Array  # [L, k] float32 t ~ U(0, w)
    weights: jax.Array  # [L, k] int32 r ~ U{0..100} (euclidean_phi_gen.hpp:63-68)
    w: float
    k: int
    L: int

    @classmethod
    def create(cls, key: jax.Array, dim: int, k: int, L: int, w: float) -> "PStableLsh":
        kp, kt, kr = jax.random.split(key, 3)
        proj = jax.random.normal(kp, (dim, L * k), dtype=jnp.float32)
        offsets = jax.random.uniform(kt, (L, k), dtype=jnp.float32, maxval=w)
        weights = jax.random.randint(kr, (L, k), 0, 101, dtype=jnp.int32)
        return cls(proj=proj, offsets=offsets, weights=weights, w=float(w), k=k, L=L)

    def hash_values(self, x: jax.Array) -> jax.Array:
        """[n, d] -> [n, L, k] int32 h-values: floor((v.x + t) / w)."""
        # HIGHEST: bucket ids must not depend on the device (see
        # hyperplane.CosineLsh.hash_bits)
        dots = jnp.dot(
            x.astype(jnp.float32), self.proj,
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        ).reshape(x.shape[0], self.L, self.k)
        return jnp.floor((dots + self.offsets[None]) / self.w).astype(jnp.int32)

    def bucket_ids(self, x: jax.Array, n_buckets: int) -> jax.Array:
        """[n, d] -> [n, L] int32 bucket ids in [0, n_buckets)."""
        h = self.hash_values(x)
        return self.bucket_ids_from_hashes(h, n_buckets)

    def bucket_ids_from_hashes(self, h: jax.Array, n_buckets: int) -> jax.Array:
        """phi over precomputed h-values [n, L, k] -> [n, L]."""
        # int32 wrap-around weighted sum (see module docstring), then a
        # nonnegative mod into the table (utils.hpp:97-98 `mod`).
        phi = jnp.sum(h * self.weights[None], axis=-1, dtype=jnp.int32)
        return jnp.remainder(phi, jnp.int32(n_buckets))

    def fingerprints_from_hashes(self, h: jax.Array) -> jax.Array:
        """[..., L, k] h-values -> [..., L] int32 tuple fingerprints.

        murmur3's stream body over the k lanes (uint32 wrap-around): each
        h-value is avalanche-mixed, then folded into the running state with
        the rotate-multiply round.  Deterministic, order-sensitive, and
        well-distributed even for the near-zero adjacent h-tuples p-stable
        hashing produces.  See the module docstring for why equality of
        fingerprints replaces equality of tuples.
        """
        u = h.astype(jnp.uint32)
        fp = jnp.full(h.shape[:-1], 0x9747B28C, jnp.uint32)
        for i in range(self.k):
            x = u[..., i] * jnp.uint32(0xCC9E2D51)
            x = (x << 15) | (x >> 17)
            x = x * jnp.uint32(0x1B873593)
            fp = fp ^ x
            fp = (fp << 13) | (fp >> 19)
            fp = fp * jnp.uint32(5) + jnp.uint32(0xE6546B64)
        # final avalanche (fmix32)
        fp = fp ^ (fp >> 16)
        fp = fp * jnp.uint32(0x85EBCA6B)
        fp = fp ^ (fp >> 13)
        fp = fp * jnp.uint32(0xC2B2AE35)
        fp = fp ^ (fp >> 16)
        return fp.astype(jnp.int32)
