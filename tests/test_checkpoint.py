"""Checkpoint round-trip tests: saved index answers queries identically."""

import numpy as np
import jax
import jax.numpy as jnp

from crypto_rec_tpu.checkpoint import (
    save_index,
    load_index,
    save_user_matrix,
    load_user_matrix,
    index_nbytes,
)
from crypto_rec_tpu.io.users import UserMatrix
from crypto_rec_tpu.models.lsh.index import build_index, candidate_mask

RNG = np.random.default_rng(11)
KEY = jax.random.PRNGKey(5)


def test_index_roundtrip(tmp_path):
    x = jnp.asarray(RNG.normal(size=(50, 12)).astype(np.float32))
    for metric in ("cosine", "euclidean"):
        idx = build_index(KEY, x, metric, k=3, L=2, lsh_bucket_div=4, euclidean_h_w=2.0)
        p = str(tmp_path / f"{metric}.npz")
        save_index(p, idx)
        idx2 = load_index(p)
        q = jnp.asarray(RNG.normal(size=(7, 12)).astype(np.float32))
        np.testing.assert_array_equal(
            np.asarray(candidate_mask(idx, q)), np.asarray(candidate_mask(idx2, q))
        )
        assert index_nbytes(idx2) > 0


def test_user_matrix_roundtrip(tmp_path):
    um = UserMatrix(
        ratings=RNG.normal(size=(4, 3)).astype(np.float32),
        known=RNG.random((4, 3)) < 0.5,
        mean=RNG.normal(size=4).astype(np.float32),
        ids=["a", "b", "c", "d"],
    )
    p = str(tmp_path / "um.npz")
    save_user_matrix(p, um)
    um2 = load_user_matrix(p)
    np.testing.assert_array_equal(um.ratings, um2.ratings)
    np.testing.assert_array_equal(um.known, um2.known)
    assert um2.ids == um.ids


def test_packed_index_roundtrip(tmp_path):
    """v2: packed slabs (bf16 AND int8) survive save/load and the restored
    index serves the packed retrieval path without re-packing."""
    from crypto_rec_tpu.models.lsh.index import pack_index, retrieve_topk

    x = jnp.asarray(RNG.normal(size=(256, 16)).astype(np.float32))
    q = jnp.asarray(RNG.normal(size=(9, 16)).astype(np.float32))
    idx = build_index(KEY, x, "cosine", k=3, L=3, lsh_bucket_div=4,
                      euclidean_h_w=1.0)
    for dtype in (jnp.bfloat16, jnp.int8):
        pidx = pack_index(idx, x, dtype=dtype, pad=512)
        p = str(tmp_path / f"packed_{np.dtype(dtype).name}.npz")
        save_index(p, pidx)
        pidx2 = load_index(p)
        assert pidx2.packed is not None and pidx2.packed.dtype == dtype
        if dtype == jnp.int8:
            # cosine int8 packs global-scale: no packed_scale plane to save
            assert pidx2.packed_scale is None
        s1, i1 = retrieve_topk(pidx, q, x, top_k=5, per_table=64)
        s2, i2 = retrieve_topk(pidx2, q, x, top_k=5, per_table=64)
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
        np.testing.assert_allclose(np.asarray(s1), np.asarray(s2), atol=1e-6)


def test_euclidean_packed_roundtrip(tmp_path):
    from crypto_rec_tpu.models.lsh.index import pack_index, retrieve_topk

    x = jnp.asarray(RNG.normal(size=(256, 16)).astype(np.float32))
    q = jnp.asarray(RNG.normal(size=(5, 16)).astype(np.float32))
    idx = build_index(KEY, x, "euclidean", k=3, L=2, lsh_bucket_div=4,
                      euclidean_h_w=4.0)
    pidx = pack_index(idx, x, dtype=jnp.bfloat16, pad=512)
    p = str(tmp_path / "packed_euc.npz")
    save_index(p, pidx)
    pidx2 = load_index(p)
    assert pidx2.packed_sqnorm is not None
    assert pidx2.packed_detailed is not None
    s1, i1 = retrieve_topk(pidx, q, x, top_k=4, per_table=64)
    s2, i2 = retrieve_topk(pidx2, q, x, top_k=4, per_table=64)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))


def test_sharded_index_roundtrip(tmp_path):
    """Per-shard save + direct-to-device restore on the 8-device mesh; the
    restored index retrieves identically to the original (incl. int8 packed)."""
    from crypto_rec_tpu.checkpoint import save_sharded_index, load_sharded_index
    from crypto_rec_tpu.parallel.mesh import make_mesh
    from crypto_rec_tpu.parallel.sharded_index import (
        build_sharded_index, pack_sharded_index, shard_corpus,
        sharded_retrieve_topk,
    )

    mesh = make_mesh((1, 8), axis_names=("dp", "mp"))
    n, d, q = 512, 16, 8
    corpus = jnp.asarray(RNG.normal(size=(n, d)).astype(np.float32))
    queries = jnp.asarray(RNG.normal(size=(q, d)).astype(np.float32))
    corpus_sh = shard_corpus(mesh, corpus)
    idx = build_sharded_index(mesh, KEY, corpus_sh, "cosine", k=3, L=3)
    idx = pack_sharded_index(mesh, idx, corpus_sh, dtype=jnp.int8, pad=512)

    prefix = str(tmp_path / "shidx")
    paths = save_sharded_index(prefix, idx)
    assert len(paths) == 1 + 8  # meta + one per shard

    idx2 = load_sharded_index(prefix, mesh)
    assert idx2.packed is not None and idx2.packed.dtype == jnp.int8
    s1, i1 = sharded_retrieve_topk(
        mesh, idx, queries, corpus_sh, budget=64, top_k=5, per_table=32)
    s2, i2 = sharded_retrieve_topk(
        mesh, idx2, queries, corpus_sh, budget=64, top_k=5, per_table=32)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_allclose(np.asarray(s1), np.asarray(s2), atol=1e-6)


def test_sharded_augmented_roundtrip(tmp_path):
    """Augmented-euclidean sharded slabs: packed_aug_scale must survive the
    save/load round trip (round-3 bug: load_sharded_index dropped it, so a
    restored index silently fell onto the non-augmented path)."""
    from crypto_rec_tpu.checkpoint import save_sharded_index, load_sharded_index
    from crypto_rec_tpu.parallel.mesh import make_mesh
    from crypto_rec_tpu.parallel.sharded_index import (
        build_sharded_index, pack_sharded_index, shard_corpus,
        sharded_retrieve_topk,
    )

    mesh = make_mesh((1, 8), axis_names=("dp", "mp"))
    n, d, q = 8 * 512, 32, 6
    corpus = jnp.asarray(RNG.normal(size=(n, d)).astype(np.float32))
    queries = jnp.asarray(RNG.normal(size=(q, d)).astype(np.float32))
    corpus_sh = shard_corpus(mesh, corpus)
    idx = build_sharded_index(
        mesh, KEY, corpus_sh, "euclidean", k=3, L=3, euclidean_h_w=8.0)
    idx = pack_sharded_index(
        mesh, idx, corpus_sh, dtype=jnp.int8, pad=512, augment=True)
    assert idx.packed_aug_scale is not None

    prefix = str(tmp_path / "shaug")
    save_sharded_index(prefix, idx)
    idx2 = load_sharded_index(prefix, mesh)
    assert idx2.packed_aug_scale is not None
    np.testing.assert_allclose(
        np.asarray(idx2.packed_aug_scale), np.asarray(idx.packed_aug_scale))
    s1, i1 = sharded_retrieve_topk(
        mesh, idx, queries, corpus_sh, budget=64, top_k=5, per_table=64)
    s2, i2 = sharded_retrieve_topk(
        mesh, idx2, queries, corpus_sh, budget=64, top_k=5, per_table=64)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_allclose(np.asarray(s1), np.asarray(s2), atol=1e-6)
