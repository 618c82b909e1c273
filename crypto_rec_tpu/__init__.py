"""crypto_rec_tpu — a JAX crypto-recommendation framework.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
YannisLamp/crypto-recommendation (reference: /root/reference, C++11,
single-threaded CPU):

* tweet-sentiment ingestion -> user x coin rating matrices
  (reference: lib/data_structures/tweet.cpp, lib/crypto_rec.hpp:78-210)
* random-hyperplane cosine LSH, p-stable euclidean LSH, hypercube probing
  (reference: lib/generators/*, lib/lsh_cube.hpp)
* k-means-family clustering: random/k-means++ init, Lloyd/range assignment,
  mean/PAM update, silhouette (reference: lib/clustering_phases/*)
* neighbor-weighted mean-centered collaborative filtering + 10-fold CV MAE
  (reference: lib/crypto_rec.hpp:213-449, main.cpp:393-437)

Design: everything is batched, statically shaped, and jit-compiled.  Hashing
is matmul, buckets are integer arrays, candidate sets are masks or
fixed-budget CSR gathers, and multi-chip scale goes through jax.sharding
meshes + collectives instead of pointers and loops.
"""

__version__ = "0.1.0"

from crypto_rec_tpu.config import RecConfig, load_config  # noqa: F401
