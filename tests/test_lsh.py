"""LSH family + index tests: bit semantics, collision properties, retrieval
paths (dense mask vs CSR budget), detailed-hash filtering, hypercube."""

import pytest
import numpy as np
import jax
import jax.numpy as jnp

from crypto_rec_tpu.models.lsh.hyperplane import CosineLsh
from crypto_rec_tpu.models.lsh.pstable import PStableLsh
from crypto_rec_tpu.models.lsh.index import (
    build_index,
    candidate_mask,
    candidate_ids,
    mask_from_candidate_ids,
)
from crypto_rec_tpu.models.lsh.hypercube import (
    build_hypercube,
    cube_candidate_mask,
    cube_candidate_ids,
)
from crypto_rec_tpu.ops.oracle import exact_nearest, recall_at_k

RNG = np.random.default_rng(1)
KEY = jax.random.PRNGKey(0)


def test_cosine_bits_match_manual_projection():
    fam = CosineLsh.create(KEY, dim=8, k=3, L=2)
    x = jnp.asarray(RNG.normal(size=(5, 8)).astype(np.float32))
    bits = np.asarray(fam.hash_bits(x))
    manual = (np.asarray(x) @ np.asarray(fam.proj) >= 0).astype(np.int32)
    np.testing.assert_array_equal(bits.reshape(5, -1), manual)
    # MSB-first packing (cosine_g_gen.hpp:62-72)
    ids = np.asarray(fam.bucket_ids(x))
    want = manual.reshape(5, 2, 3) @ np.array([4, 2, 1])
    np.testing.assert_array_equal(ids, want)
    assert ids.min() >= 0 and ids.max() < fam.n_buckets


def test_cosine_collision_prob_tracks_angle():
    # SimHash property: P[bit collision] = 1 - theta / pi.
    fam = CosineLsh.create(KEY, dim=32, k=1, L=512)
    a = np.zeros((1, 32), np.float32)
    a[0, 0] = 1.0
    b = np.zeros((1, 32), np.float32)
    theta = 0.5
    b[0, 0], b[0, 1] = np.cos(theta), np.sin(theta)
    ba = np.asarray(fam.bucket_ids(jnp.asarray(a)))
    bb = np.asarray(fam.bucket_ids(jnp.asarray(b)))
    frac = (ba == bb).mean()
    assert abs(frac - (1 - theta / np.pi)) < 0.06


def test_pstable_hash_values_formula():
    fam = PStableLsh.create(KEY, dim=6, k=2, L=3, w=0.5)
    x = jnp.asarray(RNG.normal(size=(4, 6)).astype(np.float32))
    h = np.asarray(fam.hash_values(x))
    dots = (np.asarray(x) @ np.asarray(fam.proj)).reshape(4, 3, 2)
    want = np.floor((dots + np.asarray(fam.offsets)[None]) / 0.5).astype(np.int32)
    np.testing.assert_array_equal(h, want)


def test_dense_mask_includes_self_and_matches_csr():
    x = jnp.asarray(RNG.normal(size=(64, 16)).astype(np.float32))
    for metric in ("cosine", "euclidean"):
        idx = build_index(KEY, x, metric, k=4, L=3, lsh_bucket_div=4, euclidean_h_w=2.0)
        mask = np.asarray(candidate_mask(idx, x, filtered=True))
        assert np.all(np.diag(mask)), metric  # every row collides with itself
        ids = np.asarray(candidate_ids(idx, x, budget=64, filtered=True))
        mask2 = np.asarray(mask_from_candidate_ids(jnp.asarray(ids), idx.n_rows))
        # with budget >= n the CSR union must equal the dense mask
        np.testing.assert_array_equal(mask2, mask, err_msg=metric)


def test_detailed_filter_is_stricter():
    x = jnp.asarray(RNG.normal(size=(128, 8)).astype(np.float32))
    idx = build_index(KEY, x, "euclidean", k=3, L=2, lsh_bucket_div=16, euclidean_h_w=4.0)
    unfiltered = np.asarray(candidate_mask(idx, x, filtered=False))
    filtered = np.asarray(candidate_mask(idx, x, filtered=True))
    assert not np.any(filtered & ~unfiltered)
    assert filtered.sum() <= unfiltered.sum()


def test_fingerprint_filter_matches_tuple_oracle():
    """The [L, n] int32 fingerprint filter (models/lsh/index.LshIndex.detailed)
    must produce the SAME filtered candidate mask as the reference's exact
    k-tuple comparison (euclidean_phi_gen.hpp:83-94, cust_hashtable.hpp:73-103)
    computed here from the raw h-values — i.e., no false negatives ever, and
    no collisions at this scale."""
    x = jnp.asarray(RNG.normal(size=(256, 12)).astype(np.float32))
    idx = build_index(
        KEY, x, "euclidean", k=4, L=3, lsh_bucket_div=8, euclidean_h_w=2.0
    )
    got = np.asarray(candidate_mask(idx, x, filtered=True))

    fam = idx.family
    h = np.asarray(fam.hash_values(x))                      # [n, L, k] raw tuples
    b = np.asarray(fam.bucket_ids_from_hashes(jnp.asarray(h), idx.n_buckets))
    same_bucket = b[:, None, :] == b[None, :, :]            # [q, n, L]
    same_tuple = (h[:, None, :, :] == h[None, :, :, :]).all(-1)
    want = (same_bucket & same_tuple).any(-1)
    np.testing.assert_array_equal(got, want)

    # same-tuple rows share a fingerprint; the distinct tuples here (a few
    # hundred) must not collide
    fp = np.asarray(fam.fingerprints_from_hashes(jnp.asarray(h)))  # [n, L]
    flat_h = h.transpose(1, 0, 2).reshape(-1, h.shape[-1])
    flat_fp = fp.T.reshape(-1)
    uniq = {}
    for tup, f in zip(map(tuple, flat_h.tolist()), flat_fp.tolist()):
        assert uniq.setdefault(tup, f) == f               # tuple -> one fp
    assert len(set(uniq.values())) == len(uniq)           # no fp collisions


def test_lsh_recall_on_clustered_data():
    # Clustered data: LSH with enough tables should retrieve true neighbors.
    centers = RNG.normal(size=(8, 24)).astype(np.float32) * 5
    pts = (centers[RNG.integers(0, 8, size=400)] + 0.1 * RNG.normal(size=(400, 24))).astype(
        np.float32
    )
    x = jnp.asarray(pts)
    idx = build_index(KEY, x, "cosine", k=6, L=8, lsh_bucket_div=4, euclidean_h_w=1.0)
    ids = candidate_ids(idx, x, budget=256)
    _d, true_idx = exact_nearest(x, x, "cosine", 5)
    r = float(recall_at_k(ids, true_idx))
    assert r > 0.95, r


def test_hypercube_paths_agree():
    x = jnp.asarray(RNG.normal(size=(96, 12)).astype(np.float32))
    for metric in ("cosine", "euclidean"):
        cube = build_hypercube(KEY, x, metric, k=4, euclidean_h_w=2.0)
        mask = np.asarray(cube_candidate_mask(cube, x, probes=5))
        ids = np.asarray(cube_candidate_ids(cube, x, probes=5, budget=96))
        mask2 = np.asarray(mask_from_candidate_ids(jnp.asarray(ids), cube.n_rows))
        np.testing.assert_array_equal(mask2, mask, err_msg=metric)
        # probes == full cube covers everything
        full = np.asarray(cube_candidate_mask(cube, x, probes=16))
        assert np.all(full)


def test_hypercube_home_vertex_contains_self():
    x = jnp.asarray(RNG.normal(size=(50, 10)).astype(np.float32))
    cube = build_hypercube(KEY, x, "euclidean", k=3, euclidean_h_w=1.0)
    mask = np.asarray(cube_candidate_mask(cube, x, probes=1))
    assert np.all(np.diag(mask))


def test_cube_retrieve_topk_matches_probe_mask():
    """Fused packed hypercube retrieval == brute-force scoring restricted to
    the probe-union mask (per_probe sized to cover whole buckets)."""
    from crypto_rec_tpu.models.lsh.hypercube import (
        build_hypercube, cube_candidate_mask, pack_cube, cube_retrieve_topk,
    )

    rng = np.random.default_rng(17)
    n, d, q, kk, probes, tk = 512, 24, 16, 4, 5, 6
    x = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
    qs = jnp.asarray(rng.normal(size=(q, d)).astype(np.float32))
    for metric in ("cosine", "euclidean"):
        cube = build_hypercube(
            jax.random.PRNGKey(2), x, metric, kk, euclidean_h_w=4.0
        )
        cube = pack_cube(cube, x, dtype=jnp.bfloat16, pad=1024)
        # directed=False: this is the Hamming-order reference-parity check
        vals, ids = cube_retrieve_topk(
            cube, qs, x, top_k=tk, probes=probes, per_probe=n, directed=False
        )
        vals, ids = np.asarray(vals), np.asarray(ids)

        mask = np.asarray(cube_candidate_mask(cube, qs, probes))
        xn = np.asarray(x)
        qn = np.asarray(qs)
        if metric == "cosine":
            a = xn / np.linalg.norm(xn, axis=1, keepdims=True)
            b = qn / np.linalg.norm(qn, axis=1, keepdims=True)
            score = b @ a.T
        else:
            score = -np.sqrt(
                np.maximum(
                    (qn * qn).sum(1)[:, None] - 2 * qn @ xn.T
                    + (xn * xn).sum(1)[None, :], 0,
                )
            )
        score = np.where(mask, score, -np.inf)
        ref_ids = np.argsort(-score, axis=1)[:, :tk]
        ref_vals = np.take_along_axis(score, ref_ids, axis=1)
        ref_ids = np.where(np.isfinite(ref_vals), ref_ids, -1)
        # ids match wherever the reference has a finite (unmasked) slot;
        # bf16 slab rounding can permute near-ties, so compare by score
        finite = np.isfinite(ref_vals)
        np.testing.assert_allclose(
            vals[finite], ref_vals[finite], atol=2e-2
        )
        match = (ids[finite] == ref_ids[finite]).mean()
        assert match > 0.95, f"{metric}: id match {match}"
        assert (ids[~finite] == -1).all()


def test_cube_directed_probing_beats_hamming():
    """Query-directed multiprobe (round 5): on clustered data, probing the
    margin-likeliest vertices at the SAME probe budget must recall at least
    as many true neighbors as blind Hamming order, for both metrics; the
    home vertex (empty flip set) must always lead the schedule."""
    from crypto_rec_tpu.models.lsh.hypercube import (
        build_hypercube, directed_probe_vertices, _vertex_ids,
        pack_cube, cube_retrieve_topk,
    )
    from crypto_rec_tpu.ops.oracle import exact_nearest, recall_at_k

    rng = np.random.default_rng(41)
    n, d, q, kk, probes, tk = 4096, 32, 64, 8, 8, 10
    centers = rng.normal(size=(32, d)).astype(np.float32) * 4
    base = (centers[rng.integers(0, 32, n)]
            + 0.15 * rng.normal(size=(n, d))).astype(np.float32)
    x = jnp.asarray(base)
    target = rng.choice(n, size=q, replace=False)
    qs = jnp.asarray(base[target] + 0.01 * rng.normal(size=(q, d)).astype(np.float32))
    for metric in ("cosine", "euclidean"):
        cube = build_hypercube(jax.random.PRNGKey(6), x, metric, kk,
                               euclidean_h_w=6.0)
        pv = np.asarray(directed_probe_vertices(cube, qs, probes))
        home = np.asarray(_vertex_ids(
            cube.metric, cube.k, cube.family, cube.mix_mul, cube.mix_add, qs
        ))
        assert pv.shape == (q, probes)
        assert (pv[:, 0] == home).all(), metric      # home vertex first
        for row in pv:                                # distinct vertices
            assert len(set(row.tolist())) == probes
        cube = pack_cube(cube, x, dtype=jnp.float32, pad=1024)
        _d, true_idx = exact_nearest(qs, x, metric, tk)
        _vd, ids_dir = cube_retrieve_topk(
            cube, qs, x, top_k=tk, probes=probes, per_probe=512,
            directed=True)
        _vh, ids_ham = cube_retrieve_topk(
            cube, qs, x, top_k=tk, probes=probes, per_probe=512,
            directed=False)
        r_dir = float(recall_at_k(ids_dir, true_idx))
        r_ham = float(recall_at_k(ids_ham, true_idx))
        assert r_dir >= r_ham - 1e-6, (metric, r_dir, r_ham)
        # directed must find the planted twin (it lives in the home bucket)
        assert (np.asarray(ids_dir)[:, 0] == target).all(), metric


def test_cube_euclid_augmented_kernel():
    """Euclidean cube on AUGMENTED slabs (round 5): the rank-dot kernel
    path must find the planted twin with true -distance scores and recall
    at least as much as the unaugmented XLA core path at the same probe
    budget (its maskless windows are a coverage superset)."""
    from crypto_rec_tpu.models.lsh.hypercube import (
        build_hypercube, pack_cube, cube_retrieve_topk,
    )
    from crypto_rec_tpu.ops.oracle import exact_nearest, recall_at_k

    rng = np.random.default_rng(53)
    n, d, q, kk, probes, tk = 4096, 128, 32, 8, 8, 10
    centers = rng.normal(size=(32, d)).astype(np.float32) * 2
    base = (centers[rng.integers(0, 32, n)]
            + 0.5 * rng.normal(size=(n, d))).astype(np.float32)
    x = jnp.asarray(base)
    target = rng.choice(n, size=q, replace=False)
    qs = jnp.asarray(base[target] + 0.01 * rng.normal(size=(q, d)).astype(np.float32))

    cube = build_hypercube(jax.random.PRNGKey(6), x, "euclidean", kk, 6.0)
    aug = pack_cube(cube, x, dtype=jnp.float32, pad=1024, augment=True)
    assert aug.packed_aug_scale is not None
    vals, ids = cube_retrieve_topk(
        aug, qs, x, top_k=tk, probes=probes, per_probe=256)
    vals, ids = np.asarray(vals), np.asarray(ids)
    assert (ids[:, 0] == target).all()
    # scores are true negated distances for valid ids
    xn, qn = np.asarray(x), np.asarray(qs)
    for qi in range(q):
        j = ids[qi, 0]
        true_d = -np.linalg.norm(qn[qi] - xn[j])
        assert abs(vals[qi, 0] - true_d) < 1e-2
    _d, true_idx = exact_nearest(qs, x, "euclidean", tk)
    r_aug = float(recall_at_k(jnp.asarray(ids), true_idx))
    plain = pack_cube(cube, x, dtype=jnp.float32, pad=1024)
    _v2, i2 = cube_retrieve_topk(
        plain, qs, x, top_k=tk, probes=probes, per_probe=256)
    r_plain = float(recall_at_k(i2, true_idx))
    assert r_aug >= r_plain - 0.02, (r_aug, r_plain)


def test_multicube_union_beats_single_cube():
    """MultiCube (round 5): the C-cube union in one shared-slab kernel
    launch must recall at least as much as any single member cube at the
    same per-cube budget, return valid deduplicated GLOBAL ids, and find
    the planted twin."""
    from crypto_rec_tpu.models.lsh.hypercube import (
        build_hypercube, build_multicube, multicube_retrieve_topk,
        pack_cube, cube_retrieve_topk,
    )
    from crypto_rec_tpu.ops.oracle import exact_nearest, recall_at_k

    rng = np.random.default_rng(47)
    n, d, q, kk, probes, tk = 4096, 128, 48, 8, 8, 10
    centers = rng.normal(size=(32, d)).astype(np.float32) * 2
    base = (centers[rng.integers(0, 32, n)]
            + 0.5 * rng.normal(size=(n, d))).astype(np.float32)
    x = jnp.asarray(base)
    target = rng.choice(n, size=q, replace=False)
    qs = jnp.asarray(base[target] + 0.01 * rng.normal(size=(q, d)).astype(np.float32))

    mc = build_multicube(jax.random.PRNGKey(3), x, "cosine", n_cubes=2,
                         k=kk, euclidean_h_w=1.0, corpus_dtype=jnp.float32,
                         pad=1024)
    vals, ids = multicube_retrieve_topk(
        mc, qs, top_k=tk, probes=probes, per_probe=256)
    vals, ids = np.asarray(vals), np.asarray(ids)
    assert ids.shape == (q, tk) and ids.max() < n
    for row in ids:
        real = row[row >= 0]
        assert len(set(real.tolist())) == len(real)
    assert (ids[:, 0] == target).all()
    _d, true_idx = exact_nearest(qs, x, "cosine", tk)
    r_mc = float(recall_at_k(jnp.asarray(ids), true_idx))

    # single member cube at the same per-cube budget
    single = build_hypercube(jax.random.fold_in(jax.random.PRNGKey(3), 0),
                             x, "cosine", kk, 1.0)
    single = pack_cube(single, x, dtype=jnp.float32, pad=1024)
    _v1, i1 = cube_retrieve_topk(single, qs, x, top_k=tk, probes=probes,
                                 per_probe=256, directed=True)
    r_one = float(recall_at_k(i1, true_idx))
    assert r_mc >= r_one - 1e-6, (r_mc, r_one)


def test_multicube_euclidean_union():
    """Euclidean MultiCube (round 5): C augmented-slab cubes unioned in
    one shared-slab kernel launch — the rank-dot layout of
    _cube_retrieve_kernel_euclid under the multicube segment scheme.
    Must return valid deduplicated global ids, find the planted twin,
    and recall at least as much as a single member cube."""
    from crypto_rec_tpu.models.lsh.hypercube import (
        build_hypercube, build_multicube, multicube_retrieve_topk,
        pack_cube, cube_retrieve_topk,
    )
    from crypto_rec_tpu.ops.oracle import exact_nearest, recall_at_k

    rng = np.random.default_rng(53)
    n, d, q, kk, probes, tk, w = 4096, 128, 48, 8, 8, 10, 4.0
    centers = rng.normal(size=(32, d)).astype(np.float32) * 2
    base = (centers[rng.integers(0, 32, n)]
            + 0.5 * rng.normal(size=(n, d))).astype(np.float32)
    x = jnp.asarray(base)
    target = rng.choice(n, size=q, replace=False)
    qs = jnp.asarray(
        base[target] + 0.01 * rng.normal(size=(q, d)).astype(np.float32))

    mc = build_multicube(jax.random.PRNGKey(5), x, "euclidean", n_cubes=2,
                         k=kk, euclidean_h_w=w, corpus_dtype=jnp.float32,
                         pad=1024)
    assert mc.packed_aug_scale is not None
    assert mc.packed.shape[-1] == 256  # 128 rows + norm col, 128-padded
    vals, ids = multicube_retrieve_topk(
        mc, qs, top_k=tk, probes=probes, per_probe=256)
    vals, ids = np.asarray(vals), np.asarray(ids)
    assert ids.shape == (q, tk) and ids.max() < n
    for row in ids:
        real = row[row >= 0]
        assert len(set(real.tolist())) == len(real)
    assert (ids[:, 0] == target).all()
    # scores are -euclidean distances (descending nearest-first)
    assert (vals[:, 0] <= 0).all() and (vals[:, 0] >= vals[:, -1] - 1e-5).all()
    _d, true_idx = exact_nearest(qs, x, "euclidean", tk)
    r_mc = float(recall_at_k(jnp.asarray(ids), true_idx))

    single = build_hypercube(jax.random.fold_in(jax.random.PRNGKey(5), 0),
                             x, "euclidean", kk, w)
    single = pack_cube(single, x, dtype=jnp.float32, pad=1024, augment=True)
    _v1, i1 = cube_retrieve_topk(single, qs, x, top_k=tk, probes=probes,
                                 per_probe=256, directed=True)
    r_one = float(recall_at_k(i1, true_idx))
    assert r_mc >= r_one - 1e-6, (r_mc, r_one)


def test_cube_retrieve_topk_int8_exact_rerank():
    """int8 cube slabs: over-fetch + exact f32 rerank must return the same
    ids as the bf16 path on well-separated data."""
    from crypto_rec_tpu.models.lsh.hypercube import (
        build_hypercube, pack_cube, cube_retrieve_topk,
    )

    rng = np.random.default_rng(23)
    n, d, q, kk, probes, tk = 512, 24, 12, 4, 6, 5
    x = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
    qs = x[:q] + 0.01 * jnp.asarray(rng.normal(size=(q, d)).astype(np.float32))
    cube = build_hypercube(jax.random.PRNGKey(4), x, "cosine", kk, 1.0)
    c_bf16 = pack_cube(cube, x, dtype=jnp.bfloat16, pad=1024)
    c_int8 = pack_cube(cube, x, dtype=jnp.int8, pad=1024)
    _v1, i1 = cube_retrieve_topk(c_bf16, qs, x, top_k=tk, probes=probes, per_probe=n)
    _v2, i2 = cube_retrieve_topk(c_int8, qs, x, top_k=tk, probes=probes, per_probe=n)
    # planted self-neighbor always first in both
    np.testing.assert_array_equal(np.asarray(i1)[:, 0], np.arange(q))
    np.testing.assert_array_equal(np.asarray(i2)[:, 0], np.arange(q))
    match = (np.asarray(i1) == np.asarray(i2)).mean()
    assert match > 0.9


def test_cube_retrieve_kernel_branch():
    """approx_stage1=True routes cosine cube retrieval through the
    shared-slab windowed dots.  Its maskless windows are a candidate SUPERSET of the probe-union mask,
    so scores must dominate the masked brute force rank-for-rank, planted
    twins must come back first, and ids must be valid + deduplicated."""
    from crypto_rec_tpu.models.lsh.hypercube import (
        build_hypercube, cube_candidate_mask, pack_cube, cube_retrieve_topk,
    )

    rng = np.random.default_rng(29)
    n, d, q, kk, probes, tk = 2048, 128, 16, 5, 8, 6
    x = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
    target = rng.choice(n, size=q, replace=False)
    qs = jnp.asarray(
        np.asarray(x)[target] + 1e-3 * rng.normal(size=(q, d)).astype(np.float32)
    )
    for dt in (jnp.bfloat16, jnp.int8):
        cube = build_hypercube(jax.random.PRNGKey(2), x, "cosine", kk, 1.0)
        cube = pack_cube(cube, x, dtype=dt, pad=1024)
        if dt == jnp.int8:
            assert cube.packed_gscale is not None
        vals, ids = cube_retrieve_topk(
            cube, qs, x, top_k=tk, probes=probes, per_probe=256,
            directed=False,  # domination is against the HAMMING probe mask
            approx_stage1=True,
        )
        vals, ids = np.asarray(vals), np.asarray(ids)
        assert (ids[:, 0] == target).all(), dt
        assert ids.max() < n
        for row in ids:
            real = row[row >= 0]
            assert len(set(real.tolist())) == len(real)
        # domination over the probe-union masked brute force
        mask = np.asarray(cube_candidate_mask(cube, qs, probes))
        xn = np.asarray(x) / np.linalg.norm(np.asarray(x), axis=1, keepdims=True)
        qn = np.asarray(qs) / np.linalg.norm(np.asarray(qs), axis=1, keepdims=True)
        score = np.where(mask, qn @ xn.T, -np.inf)
        ref = -np.sort(-score, axis=1)[:, :tk]
        got = np.where(ids >= 0, vals, -np.inf)
        band = 0.02 if dt == jnp.bfloat16 else 0.05
        ok = np.isfinite(ref)
        assert (got[ok] + band >= ref[ok]).all(), dt


def test_candidate_ids_scored_contains_topk():
    """candidate_ids_scored (the round-4 scored candidate engine): the set
    must contain every retrieve_topk survivor for top_k <= budget // L
    (the per-table selection guarantee), hold only valid deduplicated ids,
    and respect the budget."""
    from crypto_rec_tpu.models.lsh.index import (
        build_index, pack_index, candidate_ids_scored, retrieve_topk,
    )

    rng = np.random.default_rng(33)
    n, d, q, L, budget = 4096, 128, 12, 4, 64
    x = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
    qs = jnp.asarray(rng.normal(size=(q, d)).astype(np.float32))
    idx = build_index(jax.random.PRNGKey(7), x, "cosine", k=4, L=L,
                      lsh_bucket_div=4, euclidean_h_w=1.0)
    pidx = pack_index(idx, x, dtype=jnp.float32, pad=512)
    ids = np.asarray(candidate_ids_scored(
        pidx, qs, budget=budget, per_table=128))
    assert ids.shape == (q, budget)
    assert ids.max() < n
    for row in ids:
        real = row[row >= 0]
        assert len(set(real.tolist())) == len(real)
    top_k = budget // L
    _s, tids = retrieve_topk(pidx, qs, x, top_k=top_k, per_table=128)
    tids = np.asarray(tids)
    for qi in range(q):
        want = set(tids[qi][tids[qi] >= 0].tolist())
        got = set(ids[qi][ids[qi] >= 0].tolist())
        # approx stage-1 (recall_target 0.9) may drop near-ties; require
        # near-total containment rather than bit equality
        assert len(want & got) >= len(want) - 1, (qi, want - got)


def test_candidate_ids_scored_euclidean_augmented():
    """Euclidean sets off the scored engine (VERDICT r4 missing #4): the
    augmented-slab rank dot is order-preserving, so the scored set must
    contain every augmented retrieve_topk survivor for top_k <= budget//L
    and rank the planted nearest row first."""
    from crypto_rec_tpu.models.lsh.index import (
        build_index, pack_index, candidate_ids_scored, retrieve_topk,
    )

    rng = np.random.default_rng(35)
    n, d, q, L, budget = 4096, 128, 12, 4, 64
    base = rng.normal(size=(n, d)).astype(np.float32)
    x = jnp.asarray(base)
    target = rng.choice(n, size=q, replace=False)
    qs = jnp.asarray(base[target] + 1e-3 * rng.normal(size=(q, d)).astype(np.float32))
    idx = build_index(jax.random.PRNGKey(7), x, "euclidean", k=3, L=L,
                      lsh_bucket_div=4, euclidean_h_w=8.0)
    pidx = pack_index(idx, x, dtype=jnp.float32, pad=512, augment=True)
    ids = np.asarray(candidate_ids_scored(
        pidx, qs, budget=budget, per_table=128))
    assert ids.shape == (q, budget)
    assert ids.max() < n
    for row in ids:
        real = row[row >= 0]
        assert len(set(real.tolist())) == len(real)
    # the planted twin collides in its exact-fingerprint run -> must lead
    assert (ids[:, 0] == target).all()
    top_k = budget // L
    _s, tids = retrieve_topk(pidx, qs, x, top_k=top_k, per_table=128,
                             int8_rerank=False)
    tids = np.asarray(tids)
    for qi in range(q):
        want = set(tids[qi][tids[qi] >= 0].tolist())
        got = set(ids[qi][ids[qi] >= 0].tolist())
        assert len(want & got) >= len(want) - 1, (qi, want - got)


def test_candidate_ids_scored_requires_packed_cosine():
    from crypto_rec_tpu.models.lsh.index import (
        build_index, candidate_ids_scored,
    )

    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=(256, 16)).astype(np.float32))
    idx = build_index(jax.random.PRNGKey(1), x, "cosine", k=3, L=2,
                      lsh_bucket_div=4, euclidean_h_w=1.0)
    with pytest.raises(ValueError):
        candidate_ids_scored(idx, x[:4], budget=16)


def test_pack_index_host_matches_device():
    """pack_index_host (round 4: host-side pack so 10M L=6 fits a chip)
    must produce byte-identical slabs/scales to the device pack_index for
    cosine int8/bf16 and augmented-euclidean int8."""
    from crypto_rec_tpu.models.lsh.index import (
        build_index, pack_index, pack_index_host,
    )

    rng = np.random.default_rng(44)
    n, d = 1500, 32
    x = rng.normal(size=(n, d)).astype(np.float32)
    xj = jnp.asarray(x)

    idx_c = build_index(jax.random.PRNGKey(2), xj, "cosine", k=4, L=3,
                        lsh_bucket_div=4, euclidean_h_w=1.0)
    for dt in (jnp.int8, jnp.bfloat16):
        a = pack_index(idx_c, xj, dtype=dt, pad=512)
        b = pack_index_host(idx_c, x, dtype=dt, pad=512)
        np.testing.assert_array_equal(
            np.asarray(a.packed_rows), np.asarray(b.packed_rows))
        if dt == jnp.int8:
            np.testing.assert_allclose(
                float(a.packed_gscale), float(b.packed_gscale), rtol=1e-6)
            # int8 rounding can differ by 1 ulp at .5 boundaries between
            # XLA and numpy round-half-to-even; allow that band
            diff = np.abs(np.asarray(a.packed, np.int32)
                          - np.asarray(b.packed, np.int32))
            assert diff.max() <= 1
        else:
            np.testing.assert_allclose(
                np.asarray(a.packed, np.float32),
                np.asarray(b.packed, np.float32), atol=2e-2)

    idx_e = build_index(jax.random.PRNGKey(3), xj, "euclidean", k=3, L=3,
                        lsh_bucket_div=4, euclidean_h_w=6.0)
    a = pack_index(idx_e, xj, dtype=jnp.int8, augment=True, pad=512)
    b = pack_index_host(idx_e, x, dtype=jnp.int8, augment=True, pad=512)
    np.testing.assert_allclose(
        float(a.packed_aug_scale), float(b.packed_aug_scale), rtol=1e-5)
    np.testing.assert_allclose(
        float(a.packed_gscale), float(b.packed_gscale), rtol=1e-6)
    np.testing.assert_array_equal(
        np.asarray(a.packed_detailed), np.asarray(b.packed_detailed))
    diff = np.abs(np.asarray(a.packed, np.int32)
                  - np.asarray(b.packed, np.int32))
    assert diff.max() <= 1
