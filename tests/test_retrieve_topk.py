"""Fused retrieve_topk: equals scoring the deduplicated candidate set."""

import numpy as np
import jax
import jax.numpy as jnp

from crypto_rec_tpu.models.lsh.index import (
    build_index,
    candidate_ids,
    retrieve_topk,
)
from crypto_rec_tpu.ops.oracle import exact_nearest, recall_at_k

RNG = np.random.default_rng(41)
KEY = jax.random.PRNGKey(11)


def _clustered(n, d, n_centers=16, spread=0.1):
    centers = RNG.normal(size=(n_centers, d)).astype(np.float32) * 4
    return (
        centers[RNG.integers(0, n_centers, size=n)]
        + spread * RNG.normal(size=(n, d)).astype(np.float32)
    ).astype(np.float32)


def _topk_from_candidates(x, ids, metric, k):
    """Oracle: brute-force score the deduplicated candidate set (float64)."""
    x64 = np.asarray(x, np.float64)
    out_ids = np.full((ids.shape[0], k), -1, np.int64)
    out_scores = np.full((ids.shape[0], k), -np.inf, np.float64)
    for qi in range(ids.shape[0]):
        cand = sorted(set(int(i) for i in ids[qi] if i >= 0))
        if metric == "cosine":
            score = {
                c: float(
                    x64[qi] @ x64[c]
                    / (np.linalg.norm(x64[qi]) * np.linalg.norm(x64[c]))
                )
                for c in cand
            }
        else:
            score = {c: -float(np.linalg.norm(x64[qi] - x64[c])) for c in cand}
        best = sorted(cand, key=lambda c: (-score[c], c))[:k]
        for j, c in enumerate(best):
            out_ids[qi, j] = c
            out_scores[qi, j] = score[c]
    return out_scores, out_ids


def test_retrieve_topk_matches_candidate_scoring():
    for metric in ("cosine", "euclidean"):
        x = jnp.asarray(_clustered(256, 12))
        idx = build_index(KEY, x, metric, k=4, L=4, lsh_bucket_div=8, euclidean_h_w=3.0)
        # same windows for both paths: per_table = 256 covers everything
        ids = np.asarray(candidate_ids(idx, x, budget=256, per_table=256))
        want_s, want_i = _topk_from_candidates(np.asarray(x), ids, metric, 5)
        got_s, got_i = retrieve_topk(idx, x, x, top_k=5, per_table=256)
        got_s, got_i = np.asarray(got_s), np.asarray(got_i)
        # score sequences must agree (near-ties may permute ids between the
        # two float paths, so ids are compared as sets)
        mask = want_i >= 0
        np.testing.assert_allclose(
            got_s[mask], want_s[mask], atol=5e-3, err_msg=metric
        )
        for q in range(got_i.shape[0]):
            want_set = set(want_i[q][want_i[q] >= 0].tolist())
            got_set = set(got_i[q][got_i[q] >= 0].tolist())
            assert len(want_set & got_set) >= len(want_set) - 1, (
                metric, q, want_set, got_set
            )


def test_retrieve_topk_recall():
    x = jnp.asarray(_clustered(2048, 24, n_centers=64))
    idx = build_index(KEY, x, "cosine", k=7, L=8, lsh_bucket_div=4, euclidean_h_w=1.0)
    _s, ids = retrieve_topk(idx, x, x, top_k=10, per_table=128)
    _d, true_idx = exact_nearest(x, x, "cosine", 10)
    r = float(recall_at_k(ids, true_idx))
    assert r > 0.95, r


def test_retrieve_topk_no_duplicate_ids():
    x = jnp.asarray(_clustered(300, 8))
    idx = build_index(KEY, x, "cosine", k=3, L=6, lsh_bucket_div=4, euclidean_h_w=1.0)
    _s, ids = retrieve_topk(idx, x, x, top_k=20, per_table=128)
    for row in np.asarray(ids):
        real = row[row >= 0]
        assert len(real) == len(set(real.tolist()))


def test_packed_matches_unpacked():
    """pack_index + retrieve_topk == unpacked retrieve_topk (f32 pack dtype
    removes the bf16 rounding so the comparison is tight)."""
    from crypto_rec_tpu.models.lsh.index import pack_index

    for metric in ("cosine", "euclidean"):
        x = jnp.asarray(_clustered(512, 16, n_centers=24))
        q = x[:64]
        idx = build_index(
            KEY, x, metric, k=4, L=5, lsh_bucket_div=6, euclidean_h_w=2.0
        )
        pidx = pack_index(idx, x, dtype=jnp.float32, pad=256)
        ws, wi = retrieve_topk(idx, q, x, top_k=8, per_table=128)
        gs, gi = retrieve_topk(pidx, q, x, top_k=8, per_table=128)
        ws, wi, gs, gi = map(np.asarray, (ws, wi, gs, gi))
        mask = np.isfinite(ws)
        # packed euclidean uses |c|^2 - 2cq + |q|^2: near-zero distances see
        # sqrt-amplified f32 cancellation (sqrt(eps*|c|^2) ~ 2e-2 here)
        atol = 1e-4 if metric == "cosine" else 2.5e-2
        np.testing.assert_allclose(gs[mask], ws[mask], atol=atol, err_msg=metric)
        # near-ties may permute ids; compare as sets per query
        for qi in range(wi.shape[0]):
            want = set(wi[qi][wi[qi] >= 0].tolist())
            got = set(gi[qi][gi[qi] >= 0].tolist())
            assert len(want & got) >= len(want) - 1, (metric, qi, want, got)


def test_packed_bf16_recall():
    """bf16 packing keeps recall vs a same-precision oracle.

    bf16 input quantization (~0.4% relative) cannot rank neighbors whose
    similarities differ by less than that — a scoring-precision property,
    not an index property — so the oracle here scores the same bf16-rounded
    corpus exactly.  Residual recall loss is then pure LSH truncation."""
    from crypto_rec_tpu.models.lsh.index import pack_index

    x = jnp.asarray(_clustered(2048, 24, n_centers=64))
    idx = build_index(KEY, x, "cosine", k=7, L=8, lsh_bucket_div=4, euclidean_h_w=1.0)
    pidx = pack_index(idx, x, dtype=jnp.bfloat16, pad=256)
    _s, ids = retrieve_topk(pidx, x, x, top_k=10, per_table=128)
    # oracle at bf16 scoring precision: normalize, round to bf16, exact top-k
    xn = np.asarray(x, np.float64)
    xn = xn / np.linalg.norm(xn, axis=1, keepdims=True)
    xb = np.asarray(jnp.asarray(xn, jnp.bfloat16).astype(jnp.float64))
    sims = xb @ xb.T
    true_idx = np.argsort(-sims, axis=1)[:, :10]
    r = float(recall_at_k(jnp.asarray(ids), jnp.asarray(true_idx)))
    assert r > 0.95, r


def test_packed_rejects_oversized_window():
    from crypto_rec_tpu.models.lsh.index import pack_index
    import pytest

    x = jnp.asarray(_clustered(128, 8))
    idx = build_index(KEY, x, "cosine", k=3, L=2, lsh_bucket_div=4, euclidean_h_w=1.0)
    pidx = pack_index(idx, x, pad=16)  # rounded up to a 512 multiple -> 384
    # per_table=400 needs a 512-row window past the last row (> 384 pad)
    with pytest.raises(ValueError, match="per_table"):
        retrieve_topk(pidx, x[:4], x, top_k=3, per_table=400)


def test_packed_int8_matches_unpacked():
    """int8 quantized slabs: same top-k ids (set-wise) as the unpacked f32
    path, scores within symmetric-quantization error (|err| per element
    <= scale/2 = max|row|/254, so dot error ~ d * qerr * |q|)."""
    from crypto_rec_tpu.models.lsh.index import pack_index

    for metric in ("cosine", "euclidean"):
        x = jnp.asarray(_clustered(512, 16, n_centers=24))
        q = x[:64]
        idx = build_index(
            KEY, x, metric, k=4, L=5, lsh_bucket_div=6, euclidean_h_w=2.0
        )
        pidx = pack_index(idx, x, dtype=jnp.int8, pad=256)
        assert pidx.packed.dtype == jnp.int8
        # cosine auto-packs with ONE global scale (order-preserving raw
        # dots, no scale plane); euclidean needs per-row scales
        assert (pidx.packed_scale is None) == (metric == "cosine")
        ws, wi = retrieve_topk(idx, q, x, top_k=8, per_table=128)
        gs, gi = retrieve_topk(pidx, q, x, top_k=8, per_table=128)
        ws, wi, gs, gi = map(np.asarray, (ws, wi, gs, gi))
        mask = np.isfinite(ws)
        x64 = np.asarray(x, np.float64)
        # symmetric per-row quantization error bound: |row_hat - row| <=
        # scale/2 elementwise with scale = max|row|/127, so
        # |q.(row_hat - row)| <= ||q||_1 * max_scale / 2.
        if metric == "cosine":
            dot_err = np.abs(x64 / np.linalg.norm(x64, axis=1, keepdims=True))
            dot_err = dot_err.sum(axis=1).max() * (1.0 / 127.0) / 2
            atol = float(dot_err) + 1e-3
            np.testing.assert_allclose(gs[mask], ws[mask], atol=atol)
        else:
            # distances compare in SQUARED space (sqrt amplifies the error
            # bound without limit as the distance -> 0)
            max_scale = np.abs(x64).max(axis=1).max() / 127.0
            sq_err = np.abs(x64[:64]).sum(axis=1).max() * max_scale + 1e-2
            np.testing.assert_allclose(
                gs[mask] ** 2, ws[mask] ** 2, atol=float(sq_err)
            )
            atol = None
        # quantization permutes genuine near-ties (clustered rows are ~tied
        # within the quantization step), so assert neighbor QUALITY instead
        # of id identity: every returned id's exact f64 score must reach the
        # unpacked path's worst returned score, minus the error bound.
        for qi in range(wi.shape[0]):
            floor = ws[qi][np.isfinite(ws[qi])].min()
            for c in gi[qi][gi[qi] >= 0]:
                if metric == "cosine":
                    s = x64[qi] @ x64[c] / (
                        np.linalg.norm(x64[qi]) * np.linalg.norm(x64[c])
                    )
                    assert s >= floor - atol, (metric, qi, int(c), s, floor)
                else:
                    s_sq = float(np.sum((x64[qi] - x64[c]) ** 2))
                    assert s_sq <= floor**2 + sq_err, (
                        metric, qi, int(c), s_sq, floor**2
                    )


def test_packed_int8_recall():
    """Recall vs the EXACT f32 oracle survives int8 slab quantization."""
    from crypto_rec_tpu.models.lsh.index import pack_index

    x = jnp.asarray(_clustered(2048, 24, n_centers=64))
    idx = build_index(KEY, x, "cosine", k=7, L=8, lsh_bucket_div=4, euclidean_h_w=1.0)
    pidx = pack_index(idx, x, dtype=jnp.int8, pad=256)
    _s, ids = retrieve_topk(pidx, x, x, top_k=10, per_table=128)
    _d, true_idx = exact_nearest(x, x, "cosine", 10)
    r = float(recall_at_k(ids, true_idx))
    assert r > 0.95, r


def test_packed_int8_no_rerank_mode():
    """int8_rerank=False ranks raw global-scale dots (no exact rerank):
    exact on planted twins whose margin dominates the ~1% quantization
    noise, and scores come back dequantized to the cosine range."""
    from crypto_rec_tpu.models.lsh.index import pack_index

    rng = np.random.default_rng(3)
    n, d, q = 4096, 64, 32
    x = rng.normal(size=(n, d)).astype(np.float32)
    target = rng.choice(n, size=q, replace=False)
    qs = x[target] + 1e-3 * rng.normal(size=(q, d)).astype(np.float32)
    idx = build_index(KEY, jnp.asarray(x), "cosine", k=6, L=8,
                      lsh_bucket_div=4, euclidean_h_w=1.0)
    pidx = pack_index(idx, jnp.asarray(x), dtype=jnp.int8, pad=512)
    s, ids = retrieve_topk(
        pidx, jnp.asarray(qs), jnp.asarray(x), top_k=5, per_table=128,
        int8_rerank=False,
    )
    ids = np.asarray(ids)
    assert (ids[:, 0] == target).all()
    s = np.asarray(s)
    assert np.abs(s).max() < 1.05       # dequantized to cosine range
    assert (s[:, 0] > 0.95).all()       # planted twin similarity


def test_euclidean_augmented_kernel_path():
    """pack_index(augment=True): euclidean retrieval through the slab
    kernel (rank = x.q - |x|^2/2 as a plain augmented dot).  Planted twins
    must come back first with true -distance scores, for bf16 AND int8
    augmented slabs; scores must match exact distances to the layout's
    quantization band."""
    from crypto_rec_tpu.models.lsh.index import pack_index

    rng = np.random.default_rng(9)
    n, d, q = 4096, 64, 32
    x = rng.normal(size=(n, d)).astype(np.float32) * 2.0
    target = rng.choice(n, size=q, replace=False)
    qs = x[target] + 1e-3 * rng.normal(size=(q, d)).astype(np.float32)
    idx = build_index(KEY, jnp.asarray(x), "euclidean", k=4, L=8,
                      lsh_bucket_div=4, euclidean_h_w=8.0)
    for dt, band in ((jnp.bfloat16, 1e-4), (jnp.int8, 1e-4)):
        pidx = pack_index(idx, jnp.asarray(x), dtype=dt, pad=512,
                          augment=True)
        assert pidx.packed_aug_scale is not None
        assert pidx.packed.shape[-1] == 128  # 64 + 1 -> padded to 128
        s, ids = retrieve_topk(pidx, jnp.asarray(qs), jnp.asarray(x),
                               top_k=5, per_table=128)
        ids = np.asarray(ids)
        assert (ids[:, 0] == target).all(), dt
        # scores are EXACT -distances after the survivor rerank
        s = np.asarray(s)
        assert (s[:, 0] > -0.05).all(), (dt, s[:, 0].min())
        # exact-distance agreement on the returned ids
        for qi in range(0, q, 7):
            for slot in range(5):
                r = ids[qi, slot]
                if r < 0:
                    continue
                true_d = float(np.linalg.norm(qs[qi] - x[r]))
                assert abs(-s[qi, slot] - true_d) < band, (dt, qi, slot)
