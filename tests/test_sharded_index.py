"""Sharded-index parity: per-shard CSR build + sharded retrieval equals the
single-device oracle on an 8-virtual-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp

from crypto_rec_tpu.ops.oracle import exact_nearest, recall_at_k
from crypto_rec_tpu.parallel.mesh import make_mesh
from crypto_rec_tpu.parallel.sharded_index import (
    build_sharded_index,
    sharded_retrieve_topk,
    shard_corpus,
)

RNG = np.random.default_rng(31)
KEY = jax.random.PRNGKey(9)


def _clustered(n, d, n_centers=32, spread=0.1):
    centers = RNG.normal(size=(n_centers, d)).astype(np.float32) * 4
    pts = centers[RNG.integers(0, n_centers, size=n)] + spread * RNG.normal(
        size=(n, d)
    ).astype(np.float32)
    return pts.astype(np.float32)


def test_sharded_cosine_retrieval_recall():
    mesh = make_mesh((1, 8))
    n, d, q = 8 * 256, 32, 64
    corpus_np = _clustered(n, d)
    corpus = shard_corpus(mesh, jnp.asarray(corpus_np))
    queries = jnp.asarray(corpus_np[:q] + 0.01 * RNG.normal(size=(q, d)).astype(np.float32))

    index = build_sharded_index(mesh, KEY, corpus, "cosine", k=6, L=6)
    vals, ids = sharded_retrieve_topk(
        mesh, index, queries, corpus, budget=256, top_k=10
    )
    assert vals.shape == (q, 10) and ids.shape == (q, 10)
    # descending scores
    v = np.asarray(vals)
    assert np.all(np.diff(v, axis=1) <= 1e-6)
    _d, true_idx = exact_nearest(queries, jnp.asarray(corpus_np), "cosine", 10)
    r = float(recall_at_k(ids, true_idx))
    assert r > 0.95, r


def test_sharded_euclidean_with_detailed_filter():
    mesh = make_mesh((1, 8))
    n, d, q = 8 * 128, 16, 32
    corpus_np = _clustered(n, d, n_centers=16)
    corpus = shard_corpus(mesh, jnp.asarray(corpus_np))
    queries = jnp.asarray(corpus_np[:q])

    index = build_sharded_index(
        mesh, KEY, corpus, "euclidean", k=3, L=4,
        lsh_bucket_div=4, euclidean_h_w=4.0,
    )
    vals, ids = sharded_retrieve_topk(
        mesh, index, queries, corpus, budget=128, top_k=5
    )
    # each query is an exact corpus row: nearest hit must be itself at
    # distance 0 (score 0 after negation)
    assert np.allclose(np.asarray(vals)[:, 0], 0.0, atol=1e-4)
    assert np.array_equal(np.asarray(ids)[:, 0], np.arange(q))


def test_global_ids_cover_all_shards():
    mesh = make_mesh((1, 8))
    n, d = 8 * 64, 8
    corpus_np = RNG.normal(size=(n, d)).astype(np.float32)
    corpus = shard_corpus(mesh, jnp.asarray(corpus_np))
    queries = jnp.asarray(corpus_np)  # every row queries itself
    index = build_sharded_index(mesh, KEY, corpus, "cosine", k=4, L=8)
    _vals, ids = sharded_retrieve_topk(
        mesh, index, queries, corpus, budget=64, top_k=1
    )
    # self-retrieval: every row finds itself regardless of owning shard
    assert np.array_equal(np.asarray(ids)[:, 0], np.arange(n))


def test_sharded_packed_matches_unpacked():
    """pack_sharded_index + retrieval == the unpacked sharded path (f32
    packing keeps scores bit-comparable for cosine)."""
    from crypto_rec_tpu.parallel.sharded_index import pack_sharded_index

    mesh = make_mesh((1, 8))
    n, d, q = 8 * 256, 32, 48
    corpus_np = _clustered(n, d)
    corpus = shard_corpus(mesh, jnp.asarray(corpus_np))
    queries = jnp.asarray(
        corpus_np[:q] + 0.01 * RNG.normal(size=(q, d)).astype(np.float32)
    )
    index = build_sharded_index(mesh, KEY, corpus, "cosine", k=6, L=6)
    pidx = pack_sharded_index(mesh, index, corpus, dtype=jnp.float32, pad=512)
    ws, wi = sharded_retrieve_topk(
        mesh, index, queries, corpus, budget=256, top_k=10, per_table=256
    )
    gs, gi = sharded_retrieve_topk(
        mesh, pidx, queries, corpus, budget=256, top_k=10, per_table=256
    )
    ws, wi, gs, gi = map(np.asarray, (ws, wi, gs, gi))
    mask = np.isfinite(ws)
    np.testing.assert_allclose(gs[mask], ws[mask], atol=1e-4)
    for qi in range(q):
        want = set(wi[qi][wi[qi] >= 0].tolist())
        got = set(gi[qi][gi[qi] >= 0].tolist())
        assert len(want & got) >= len(want) - 1, (qi, want, got)


def test_sharded_packed_euclidean_filtered():
    """Packed sharded euclidean retrieval (detailed-tuple filter) finds the
    same neighbors as the single-device packed index."""
    from crypto_rec_tpu.models.lsh.index import (
        build_index, pack_index, retrieve_topk,
    )
    from crypto_rec_tpu.parallel.sharded_index import pack_sharded_index

    mesh = make_mesh((1, 8))
    n, d, q = 8 * 128, 16, 32
    corpus_np = _clustered(n, d, n_centers=16)
    corpus = shard_corpus(mesh, jnp.asarray(corpus_np))
    queries = jnp.asarray(corpus_np[:q])
    index = build_sharded_index(
        mesh, KEY, corpus, "euclidean", k=3, L=4,
        lsh_bucket_div=4, euclidean_h_w=4.0,
    )
    pidx = pack_sharded_index(mesh, index, corpus, dtype=jnp.float32, pad=512)
    vals, ids = sharded_retrieve_topk(
        mesh, pidx, queries, corpus, budget=128, top_k=5, per_table=128
    )
    vals, ids = np.asarray(vals), np.asarray(ids)
    # each query indexed its own row: top-1 must be itself at distance 0
    assert np.array_equal(ids[:, 0], np.arange(q)), ids[:, 0]
    np.testing.assert_allclose(vals[:, 0], 0.0, atol=2e-2)
    assert np.all(np.diff(vals, axis=1) <= 1e-6)


def test_sharded_packed_int8_rerank_matches_unpacked():
    """int8 sharded slabs + shard-local exact rerank: the merged global
    top-k matches the unpacked sharded path — the rerank rescores in f32,
    so only a true neighbor missing from the 4x-overfetched survivor set
    (not mere quantization rounding) could differ, and scores of returned
    ids are exact."""
    from crypto_rec_tpu.parallel.sharded_index import pack_sharded_index

    mesh = make_mesh((1, 8))
    n, d, q = 8 * 256, 32, 48
    corpus_np = _clustered(n, d)
    corpus = shard_corpus(mesh, jnp.asarray(corpus_np))
    queries = jnp.asarray(
        corpus_np[:q] + 0.01 * RNG.normal(size=(q, d)).astype(np.float32)
    )
    index = build_sharded_index(mesh, KEY, corpus, "cosine", k=6, L=6)
    pidx = pack_sharded_index(mesh, index, corpus, dtype=jnp.int8, pad=512)
    # cosine int8 auto-packs global-scale: no per-row scale plane
    assert pidx.packed.dtype == jnp.int8 and pidx.packed_scale is None
    ws, wi = sharded_retrieve_topk(
        mesh, index, queries, corpus, budget=256, top_k=10, per_table=256
    )
    gs, gi = sharded_retrieve_topk(
        mesh, pidx, queries, corpus, budget=256, top_k=10, per_table=256
    )
    ws, wi, gs, gi = map(np.asarray, (ws, wi, gs, gi))
    # rerank scores are exact f32 — returned (id -> score) pairs must agree
    # with the unpacked path wherever the ids coincide
    for qi in range(q):
        want = {int(i): float(s) for i, s in zip(wi[qi], ws[qi]) if i >= 0}
        got = {int(i): float(s) for i, s in zip(gi[qi], gs[qi]) if i >= 0}
        shared = set(want) & set(got)
        assert len(shared) >= len(want) - 1, (qi, want, got)
        for c in shared:
            assert abs(want[c] - got[c]) < 1e-4, (qi, c, want[c], got[c])


def test_sharded_pallas_leg_matches_xla():
    """The windowed slab dots inside the shard_map (per-shard leg of
    sharded_retrieve_topk) return the same merged top-k as the per-shard
    XLA packed core merged by hand — bf16 and global-scale int8."""
    from crypto_rec_tpu.models.lsh.index import (
        packed_retrieve_core, rerank_exact,
    )
    from crypto_rec_tpu.parallel.sharded_index import pack_sharded_index

    mesh = make_mesh((1, 8))
    n, d, q, top_k = 8 * 512, 128, 16, 8
    corpus_np = _clustered(n, d)
    corpus = shard_corpus(mesh, jnp.asarray(corpus_np))
    queries = jnp.asarray(
        corpus_np[:q] + 0.01 * RNG.normal(size=(q, d)).astype(np.float32)
    )
    index = build_sharded_index(mesh, KEY, corpus, "cosine", k=5, L=4)
    qb = index.family.bucket_ids(queries)
    for dtype in (jnp.bfloat16, jnp.int8):
        pidx = pack_sharded_index(mesh, index, corpus, dtype=dtype, pad=1024)
        assert pidx.packed_scale is None  # scale-free: the windowed leg
        # reference: the blocked XLA core on each shard's slabs, int8
        # survivors reranked exactly (as the sharded engine does), then the
        # global top-k over all shards
        quantized = dtype == jnp.int8
        n_local = pidx.n_local
        vals, gids = [], []
        for sh in range(pidx.n_shards):
            core_k = 4 * top_k if quantized else top_k
            s_, i_ = packed_retrieve_core(
                pidx.packed[sh], pidx.packed_rows[sh], None, None,
                pidx.bucket_starts[sh], n_local, "cosine", queries, qb, None,
                core_k, 256,
            )
            if quantized:
                blk = jnp.asarray(corpus_np[sh * n_local:(sh + 1) * n_local])
                s_, i_ = rerank_exact(blk, "cosine", queries, i_, top_k)
            vals.append(np.asarray(s_))
            gids.append(np.where(np.asarray(i_) >= 0,
                                 np.asarray(i_) + sh * n_local, -1))
        vals, gids = np.concatenate(vals, 1), np.concatenate(gids, 1)
        order = np.argsort(-vals, axis=1, kind="stable")[:, :top_k]
        xs = np.take_along_axis(vals, order, 1)
        xi = np.take_along_axis(gids, order, 1)
        ps, pi = sharded_retrieve_topk(
            mesh, pidx, queries, corpus, budget=256, top_k=top_k,
            per_table=256,
        )
        ps, pi = np.asarray(ps), np.asarray(pi)
        # the windowed leg's maskless windows only ADD candidates and its
        # f32 products differ from the core's slab-dtype einsum, so genuine
        # near-ties may permute: any slot where the ids differ must be a
        # tie within the slab rounding band
        xn = corpus_np / np.linalg.norm(corpus_np, axis=1, keepdims=True)
        qn = np.asarray(queries)
        qn = qn / np.linalg.norm(qn, axis=1, keepdims=True)
        diff = xi != pi
        assert diff.mean() < 0.25, f"{dtype}: {diff.mean():.3f} ids differ"
        for qi, slot in zip(*np.where(diff)):
            sa = float(qn[qi] @ xn[xi[qi, slot]])
            sb = float(qn[qi] @ xn[pi[qi, slot]])
            assert abs(sa - sb) < 2e-2, (dtype, qi, slot, sa, sb)
        np.testing.assert_allclose(xs, ps, rtol=1e-2, atol=2e-2)


def test_sharded_euclidean_augmented_kernel_leg():
    """pack_sharded_index(augment=True): each shard's euclidean retrieval
    runs the slab kernel on augmented slabs + exact survivor rerank; the
    merged global top-k must find the planted twins with true -distance
    scores, bf16 AND int8 (per-shard scale pairs)."""
    from crypto_rec_tpu.parallel.sharded_index import pack_sharded_index

    mesh = make_mesh((1, 8))
    rng = np.random.default_rng(41)
    n, d, q = 8 * 512, 128, 24
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    target = rng.choice(n, size=q, replace=False)
    queries = corpus[target] + 1e-3 * rng.normal(size=(q, d)).astype(np.float32)
    sharded = build_sharded_index(
        mesh, jax.random.PRNGKey(3), shard_corpus(mesh, jnp.asarray(corpus)),
        "euclidean", k=4, L=6, lsh_bucket_div=4, euclidean_h_w=8.0,
    )
    for dt in (jnp.bfloat16, jnp.int8):
        pidx = pack_sharded_index(
            mesh, sharded, shard_corpus(mesh, jnp.asarray(corpus)),
            dtype=dt, pad=512, augment=True,
        )
        assert pidx.packed_aug_scale is not None
        assert pidx.packed.shape[-1] == 256  # 128 + 1 -> padded
        vals, gids = sharded_retrieve_topk(
            mesh, pidx, jnp.asarray(queries),
            shard_corpus(mesh, jnp.asarray(corpus)),
            budget=128, top_k=5, per_table=128,
        )
        gids = np.asarray(gids)
        assert (gids[:, 0] == target).all(), dt
        vals = np.asarray(vals)
        assert (vals[:, 0] > -0.05).all(), dt
        # exact -distance scores after the per-shard rerank
        for qi in range(0, q, 5):
            r = gids[qi, 0]
            true_d = float(np.linalg.norm(queries[qi] - corpus[r]))
            assert abs(-vals[qi, 0] - true_d) < 1e-4, dt
