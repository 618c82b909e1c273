"""Windowed slab dots (ops/pallas/slabscore.py): the plain XLA form against
numpy, the Triton kernel (interpret mode) against the XLA form, the window
semantics of the entry point, the choice of implementation — plus the
precision and compile-cache rules the GPU port relies on.

Tolerance (used by every dots comparison below): both forms accumulate an
f32 sum of d products, in different orders.  Each partial sum is bounded
by d * max|q| * max|row|, and f32 rounding of a sum of d <= 256 terms stays
within ~d * 2^-24 of that bound per step, so |Δdot| <= 1e-5 * d * max|q| *
max|row| covers every reordering with margin while still catching a wrong
row, a wrong column or a product in reduced precision (TF32 or bf16 errors
are ~1e-3 relative, orders of magnitude above the band).
"""

import pathlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from crypto_rec_tpu.ops.pallas.slabscore import (
    _window_dots_triton,
    _window_dots_xla,
    slab_window_dots,
    window_dots_impl,
    window_width,
)

REPO = pathlib.Path(__file__).resolve().parent.parent
PER_TABLE = 200            # -> win = 256
N_PAD = 1024
DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}


def _slabs(layout, dtype, d, seed=0):
    """-> (packed [S, N_PAD, d], starts [q, T], sizes [q, T], queries)."""
    rng = np.random.default_rng(seed)
    T = 3
    S = 1 if layout == "shared" else T
    if dtype == jnp.int8:
        packed = rng.integers(-127, 128, size=(S, N_PAD, d))
    else:
        packed = rng.normal(size=(S, N_PAD, d))
    packed = jnp.asarray(packed).astype(dtype)
    q = 5
    starts = jnp.asarray(rng.integers(0, N_PAD - 40, size=(q, T)), jnp.int32)
    sizes = jnp.asarray(rng.integers(1, PER_TABLE + 1, size=(q, T)), jnp.int32)
    queries = jnp.asarray(rng.normal(size=(q, d)), jnp.float32)
    return packed, starts, sizes, queries


def _numpy_dots(packed, starts, queries, shared):
    """Reference semantics of slab_window_dots(mask=False), in float64."""
    win = window_width(PER_TABLE)
    p = np.asarray(packed.astype(jnp.float32), np.float64)
    st = np.asarray(starts)
    qv = np.asarray(queries, np.float64)
    n_pad = p.shape[1]
    aligned = np.minimum(st // 32 * 32, n_pad - win)
    out = np.empty(st.shape + (win,))
    for i in range(st.shape[0]):
        for t in range(st.shape[1]):
            slab = p[0 if shared else t]
            out[i, t] = slab[aligned[i, t]:aligned[i, t] + win] @ qv[i]
    return out, aligned


def _band(packed, queries):
    d = packed.shape[-1]
    return 1e-5 * d * float(jnp.max(jnp.abs(queries))) * float(
        jnp.max(jnp.abs(packed.astype(jnp.float32))))


def _flat_rows(packed, starts, shared):
    """The (flat slab, absolute window rows) pair the implementations take."""
    n_pad, d = packed.shape[1], packed.shape[2]
    win = window_width(PER_TABLE)
    aligned = jnp.minimum(starts // 32 * 32, n_pad - win)
    T = starts.shape[1]
    off = jnp.zeros((T,), jnp.int32) if shared else jnp.arange(T) * n_pad
    return packed.reshape(-1, d), (aligned + off).astype(jnp.int32), win


CASES = [
    (layout, dt, d)
    for layout in ("per_table", "shared")
    for dt in DTYPES
    for d in (128, 100)
]


@pytest.mark.parametrize("layout,dt,d", CASES)
def test_xla_form_matches_numpy(layout, dt, d):
    packed, starts, sizes, queries = _slabs(layout, DTYPES[dt], d)
    shared = layout == "shared"
    dots, aligned = slab_window_dots(
        packed, None, starts, sizes, queries, per_table=PER_TABLE,
        mask=False, shared_slab=shared,
    )
    want, want_aligned = _numpy_dots(packed, starts, queries, shared)
    np.testing.assert_array_equal(np.asarray(aligned), want_aligned)
    np.testing.assert_allclose(
        np.asarray(dots), want, rtol=0, atol=_band(packed, queries))


@pytest.mark.parametrize("layout,dt,d", CASES)
def test_triton_kernel_matches_xla_form(layout, dt, d):
    packed, starts, _sizes, queries = _slabs(layout, DTYPES[dt], d, seed=1)
    flat, rows0, win = _flat_rows(packed, starts, layout == "shared")
    want = _window_dots_xla(flat, rows0, queries, win)
    got = _window_dots_triton(flat, rows0, queries, win, interpret=True)
    assert got.shape == want.shape == (queries.shape[0], starts.shape[1], win)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=0,
        atol=_band(packed, queries))


def test_ragged_query_count():
    """A query count that is no power of two (7) and a single query both
    give the XLA and kernel forms the same [q, T, win] dots."""
    packed, starts, _s, queries = _slabs("per_table", jnp.int8, 128, seed=2)
    rng = np.random.default_rng(3)
    for q in (7, 1):
        st = jnp.asarray(rng.integers(0, N_PAD - 40, size=(q, 3)), jnp.int32)
        qv = jnp.asarray(rng.normal(size=(q, 128)), jnp.float32)
        flat, rows0, win = _flat_rows(packed, st, False)
        want = _window_dots_xla(flat, rows0, qv, win)
        got = _window_dots_triton(flat, rows0, qv, win, interpret=True)
        assert got.shape == (q, 3, win)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=0, atol=_band(packed, qv))


def test_window_clamped_at_slab_end():
    """A start within one window of the slab end is clamped so the window
    stays inside the slab; the valid lanes still sit at [head, head+size)
    with head = start - aligned."""
    packed, _st, _sz, queries = _slabs("per_table", jnp.float32, 128, seed=4)
    q = queries.shape[0]
    starts = jnp.full((q, 3), N_PAD - 50, jnp.int32)
    sizes = jnp.full((q, 3), 40, jnp.int32)
    dots, aligned = slab_window_dots(
        packed, None, starts, sizes, queries, per_table=PER_TABLE, mask=True)
    win = window_width(PER_TABLE)
    assert (np.asarray(aligned) == N_PAD - win).all()
    head = N_PAD - 50 - (N_PAD - win)
    d = np.asarray(dots)
    assert np.isfinite(d[..., head:head + 40]).all()
    assert np.isneginf(d[..., :head]).all()
    assert np.isneginf(d[..., head + 40:]).all()
    want, _ = _numpy_dots(packed, starts, queries, False)
    np.testing.assert_allclose(d[..., head:head + 40],
                               want[..., head:head + 40], rtol=0,
                               atol=_band(packed, queries))


def test_strict_mask_sets_out_of_window_lanes_to_minus_inf():
    packed, starts, sizes, queries = _slabs("per_table", jnp.bfloat16, 128, 5)
    strict, aligned = slab_window_dots(
        packed, None, starts, sizes, queries, per_table=PER_TABLE, mask=True)
    loose, _ = slab_window_dots(
        packed, None, starts, sizes, queries, per_table=PER_TABLE, mask=False)
    strict, loose = np.asarray(strict), np.asarray(loose)
    head = np.asarray(starts - aligned)[..., None]
    size = np.asarray(sizes)[..., None]
    lane = np.arange(strict.shape[-1])
    valid = (lane >= head) & (lane < head + size)
    assert np.isneginf(strict[~valid]).all()
    np.testing.assert_array_equal(strict[valid], loose[valid])


def test_impl_choice_cpu_is_xla():
    flat = jnp.zeros((1024, 128), jnp.int8)
    assert window_dots_impl("cpu", flat) is _window_dots_xla


def test_impl_choice_gpu_is_triton_kernel():
    """On a CUDA platform the kernel is chosen, and a computation lowered
    for CUDA carries the Triton call (lowered here without a GPU)."""
    flat = jnp.zeros((1024, 128), jnp.int8)
    assert window_dots_impl("cuda", flat) is _window_dots_triton
    packed, starts, sizes, queries = _slabs("per_table", jnp.int8, 128)
    fn = jax.jit(slab_window_dots,
                 static_argnames=("per_table", "mask", "shared_slab"))
    cuda = fn.trace(packed, None, starts, sizes, queries,
                    per_table=PER_TABLE, mask=False).lower(
                        lowering_platforms=("cuda",)).as_text()
    cpu = fn.trace(packed, None, starts, sizes, queries,
                   per_table=PER_TABLE, mask=False).lower(
                       lowering_platforms=("cpu",)).as_text()
    assert "xla.gpu.triton" in cuda
    assert "xla.gpu.triton" not in cpu


def test_impl_choice_unknown_platform_raises():
    flat = jnp.zeros((1024, 128), jnp.int8)
    with pytest.raises(NotImplementedError):
        window_dots_impl("rocm", flat)


def _dot_precisions(jaxpr):
    """Every dot_general precision in a jaxpr, sub-jaxprs included."""
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            p = eqn.params["precision"]
            found.append(p if isinstance(p, tuple) else (p, p))
        for v in eqn.params.values():
            for sub in v if isinstance(v, (tuple, list)) else (v,):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    found += _dot_precisions(inner)
    return found


def test_oracle_runs_at_highest_precision():
    from crypto_rec_tpu.ops.oracle import exact_nearest

    q = jnp.ones((4, 16), jnp.float32)
    x = jnp.ones((32, 16), jnp.float32)
    for metric in ("cosine", "euclidean"):
        jaxpr = jax.make_jaxpr(
            lambda a, b: exact_nearest(a, b, metric, 3, block_rows=4))(q, x)
        precs = _dot_precisions(jaxpr.jaxpr)
        assert precs, metric
        hi = jax.lax.Precision.HIGHEST
        assert all(p == (hi, hi) for p in precs), (metric, precs)


def test_hash_projections_run_at_highest_precision():
    from crypto_rec_tpu.models.lsh.hyperplane import CosineLsh
    from crypto_rec_tpu.models.lsh.pstable import PStableLsh

    key = jax.random.PRNGKey(0)
    x = jnp.ones((8, 16), jnp.float32)
    hi = jax.lax.Precision.HIGHEST
    for fam, fn in (
        (CosineLsh.create(key, 16, 4, 2), lambda f, v: f.bucket_ids(v)),
        (PStableLsh.create(key, 16, 4, 2, 4.0), lambda f, v: f.hash_values(v)),
    ):
        precs = _dot_precisions(jax.make_jaxpr(fn)(fam, x).jaxpr)
        assert precs and all(p == (hi, hi) for p in precs), precs


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    from crypto_rec_tpu.utils.compile_cache import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # sets nothing


def test_compile_cache_defaults_into_repo(monkeypatch):
    from crypto_rec_tpu.utils.compile_cache import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = enable_compile_cache()
        assert path == str(REPO / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
