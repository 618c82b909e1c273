"""Random-hyperplane (cosine / SimHash) LSH.

Reference semantics:
* one h-function = one hyperplane r ~ N(0,1)^d, bit = 1 iff r.x >= 0
  (/root/reference/lib/generators/cosine_h_gen.hpp:53-76);
* one g-function = k h-bits concatenated MSB-first into a bucket id in
  [0, 2^k) (cosine_g_gen.hpp:62-72);
* L independent g-functions = L tables (lsh_cube.hpp:63-66).

The reference's n * L * k virtual-dispatch dot products collapse into ONE
[n, d] x [d, L*k] matmul followed by a sign + bit-pack reduction.  The
projection runs at HIGHEST precision: bucket ids must not depend on the
device (a checkpoint built on one machine is served on another), and a
TF32 product can flip the sign bit of a near-zero projection.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=("proj",),
    meta_fields=("k", "L"),
)
@dataclasses.dataclass
class CosineLsh:
    """Parameters of L tables x k hyperplanes."""

    proj: jax.Array  # [d, L * k] float32, N(0, 1)
    k: int
    L: int

    @property
    def n_buckets(self) -> int:
        return 1 << self.k

    @classmethod
    def create(cls, key: jax.Array, dim: int, k: int, L: int) -> "CosineLsh":
        proj = jax.random.normal(key, (dim, L * k), dtype=jnp.float32)
        return cls(proj=proj, k=k, L=L)

    def hash_bits(self, x: jax.Array) -> jax.Array:
        """[n, d] -> [n, L, k] int32 sign bits (1 iff r.x >= 0)."""
        proj = jnp.dot(
            x.astype(jnp.float32), self.proj,
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )
        bits = (proj >= 0.0).astype(jnp.int32)
        return bits.reshape(x.shape[0], self.L, self.k)

    def bucket_ids(self, x: jax.Array) -> jax.Array:
        """[n, d] -> [n, L] int32 bucket ids, bits packed MSB-first
        (cosine_g_gen.hpp:62-72: first h occupies the highest bit)."""
        bits = self.hash_bits(x)
        weights = (1 << jnp.arange(self.k - 1, -1, -1, dtype=jnp.int32))
        return jnp.sum(bits * weights, axis=-1)
