"""Windowed slab dots (ops/pallas/slabscore.py) in the retrieval wrappers
vs the blocked XLA packed core (on the CPU the dots take the plain XLA
form; tests/test_window_dots.py covers the Triton kernel itself)."""

import numpy as np
import jax
import jax.numpy as jnp


class TestSlabScore:
    """Parity of the windowed-dots retrieval vs the XLA packed core (bf16
    AND int8)."""

    def _setup(self, dtype, scale_mode="auto"):
        from crypto_rec_tpu.models.lsh.index import build_index, pack_index

        rng = np.random.default_rng(7)
        n, d, q, L = 4096, 128, 24, 5
        x = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
        qs = x[:q] + 0.01 * jnp.asarray(
            rng.normal(size=(q, d)).astype(np.float32)
        )
        idx = build_index(
            jax.random.PRNGKey(1), x, "cosine", k=5, L=L,
            lsh_bucket_div=4, euclidean_h_w=1.0,
        )
        return pack_index(idx, x, dtype=dtype, pad=1024,
                          scale_mode=scale_mode), x, qs

    def _parity(self, dtype, scale_mode="auto"):
        from crypto_rec_tpu.models.lsh.index import (
            packed_retrieve_core, query_hashes,
        )
        from crypto_rec_tpu.ops.pallas.slabscore import packed_retrieve_pallas

        pidx, x, qs = self._setup(dtype, scale_mode)
        qb, _ = query_hashes(pidx, qs)
        s_ref, ids_ref = packed_retrieve_core(
            pidx.packed, pidx.packed_rows, None, None, pidx.bucket_starts,
            pidx.n_rows, "cosine", qs, qb, None, 10, 200, 128,
            packed_scale=pidx.packed_scale,
        )
        # strict=True pins the kernel to the XLA core's exact window
        # semantics (the production default is a multiprobe superset —
        # covered by test_maskless_dominates_strict)
        s_pal, ids_pal = packed_retrieve_pallas(
            pidx.packed, pidx.packed_rows, pidx.packed_scale,
            pidx.bucket_starts, pidx.n_rows, qs, qb, 10, 200, strict=True,
        )
        ids_ref, ids_pal = np.asarray(ids_ref), np.asarray(ids_pal)
        s_ref, s_pal = np.asarray(s_ref), np.asarray(s_pal)
        # the XLA core einsums in the slab dtype (bf16-rounded products),
        # the windowed dots multiply in exact f32 — scores agree only to the
        # slab rounding band, and genuine near-ties may permute ids.  Same
        # contract as test_sharded_index.test_sharded_pallas_leg_matches_xla.
        diff = ids_ref != ids_pal
        assert diff.mean() < 0.15, f"{diff.mean():.3f} ids differ"
        # rtol: global-scale int8 ranks RAW dots (magnitude ~d*127), where
        # rounding noise is relative, not absolute
        band = 5e-3 * max(1.0, float(np.abs(s_ref).max()))
        np.testing.assert_allclose(s_ref, s_pal, rtol=5e-3, atol=band)
        # every differing slot must be a genuine near-tie against the
        # exact f32 similarity — a windowing bug that swapped ids within
        # the band could not pass this (advisor r2 finding #3)
        xn = np.asarray(x) / np.linalg.norm(np.asarray(x), axis=1, keepdims=True)
        qn = np.asarray(qs) / np.linalg.norm(np.asarray(qs), axis=1, keepdims=True)
        for qi, slot in zip(*np.nonzero(diff)):
            a, b = ids_ref[qi, slot], ids_pal[qi, slot]
            if a < 0 or b < 0:
                continue
            sim_a = float(qn[qi] @ xn[a])
            sim_b = float(qn[qi] @ xn[b])
            assert abs(sim_a - sim_b) < 6e-3, (
                f"q{qi} slot{slot}: ids {a}/{b} not a near-tie "
                f"({sim_a:.5f} vs {sim_b:.5f})"
            )

    def test_parity_bf16(self):
        self._parity(jnp.bfloat16)

    def test_parity_int8_global_scale(self):
        # cosine auto = global scale: scale-free kernel, raw dots ranked
        self._parity(jnp.int8)

    def test_parity_int8_row_scale(self):
        # per-row scales exercise the XLA aligned-block dequant epilogue
        self._parity(jnp.int8, scale_mode="row")

    def test_retrieve_topk_pallas_end_to_end(self):
        """The wrapper (hash + windowed dots + dedup top-k + global-scale
        score dequant) against the blocked XLA core on the same packed
        index, strict window semantics on both sides."""
        from crypto_rec_tpu.models.lsh.index import (
            packed_retrieve_core, query_hashes, retrieve_topk_pallas,
        )

        pidx, x, qs = self._setup(jnp.int8)
        assert pidx.packed_gscale is not None  # global-scale stores the scalar
        # int8_rerank=False: rank raw int8 dots, dequant the scores with the
        # stored scalar (the fast large-margin mode)
        qb, _ = query_hashes(pidx, qs)
        s_x, i_x = packed_retrieve_core(
            pidx.packed, pidx.packed_rows, None, None, pidx.bucket_starts,
            pidx.n_rows, "cosine", qs, qb, None, 8, 200, 128,
        )
        s_x = s_x * pidx.packed_gscale
        s_p, i_p = retrieve_topk_pallas(
            pidx, qs, x, top_k=8, per_table=200, strict=True,
            int8_rerank=False,
        )
        # both paths rank the same raw int8 dots and dequant by the same
        # scalar; the XLA core rounds the QUERY to bf16 while the windowed
        # dots keep it f32, so scores agree to the bf16 band and any id
        # difference is a genuine near-tie
        i_x, i_p = np.asarray(i_x), np.asarray(i_p)
        diff = i_x != i_p
        assert diff.mean() < 0.05, f"{diff.mean():.3f} ids differ"
        np.testing.assert_allclose(
            np.asarray(s_x), np.asarray(s_p), rtol=5e-3, atol=2e-3
        )
        # scaled scores are approximate cosine sims: bounded by 1 + quant noise
        assert float(np.abs(np.asarray(s_p)).max()) < 1.05

    def test_maskless_dominates_strict(self):
        """Production mode (maskless multiprobe windows + approx stage-1)
        must return scores >= the strict reference-window mode
        rank-for-rank, with well-formed ids (no pad rows, no duplicates) —
        the aligned overfetch can only ADD real candidates."""
        from crypto_rec_tpu.models.lsh.index import retrieve_topk_pallas

        pidx, x, qs = self._setup(jnp.bfloat16)
        s_strict, i_strict = retrieve_topk_pallas(
            pidx, qs, x, top_k=8, per_table=200, strict=True
        )
        s_prod, i_prod = retrieve_topk_pallas(
            pidx, qs, x, top_k=8, per_table=200
        )
        s_strict, s_prod = np.asarray(s_strict), np.asarray(s_prod)
        i_prod = np.asarray(i_prod)
        ok = s_strict > -np.inf
        assert (s_prod[ok] + 1e-5 >= s_strict[ok]).all()
        assert i_prod.max() < pidx.n_rows
        for row in i_prod:
            real = row[row >= 0]
            assert len(set(real.tolist())) == len(real)
