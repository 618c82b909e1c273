"""Windowed slab dots — the packed-index hot loop — and their top-k epilogue.

Every packed retrieval path (cosine and augmented-euclidean LSH tables,
scored candidate sets, CF neighbours, the hypercube and MultiCube, streamed
chunks and sharded legs) reduces to one operation: for each (query, window)
pair, the dots of the query against `win` consecutive rows of a CSR-ordered
slab.  `slab_window_dots` is that operation's single entry point; only the
[q, T, win] f32 dots leave it.  Candidate row ids are recovered afterwards
by gathering `packed_rows` at just the top-k survivors' positions
(slab_topk).

Two implementations compute the same dots, chosen by `window_dots_impl`
from the platform the computation is lowered for:

* `_window_dots_xla` (CPU; the plain reference): gather the [q, T, win]
  window rows from the flattened slab, then an f32 multiply and sum over d.
  It is written as a multiply-reduce, not a `dot`, so that XLA fuses the
  gather into the reduction and no product runs in reduced precision.
* `_window_dots_triton` (GPU): a Pallas kernel on the Triton route.  One
  program per (query, window) loads its own window start, walks the window
  in `_BLOCK_ROWS`-row blocks at that dynamic start, upcasts int8/bf16 rows
  to f32 in registers and reduces against the f32 query — no [q, T, win, d]
  temporary, and no TF32 (it does not use `pl.dot`).

Window semantics (shared by both implementations, unchanged from the
original design so recall stays comparable): a window's start is aligned
DOWN to `_ALIGN` rows and the window is `win = round_up(per_table +
_ALIGN, 128)` rows wide, so it always covers the requested
[start, start + per_table) run.  With mask=False ("maskless", the
production mode) every lane carries its raw dot: the out-of-window lanes
are real neighbouring CSR rows, i.e. free multiprobe, and pad-sentinel rows
are killed by id in the dedup stage.  mask=True sets the lanes outside
[start, start + size) to -inf, the exact reference window semantics for
parity tests.

Slab layouts: bf16/f32 slabs, GLOBAL-scale int8 slabs (pack_index
scale_mode="global" — one scalar scale, so the raw dots are
order-preserving and callers dequantize just the top-k scores), per-row
scale int8 slabs (the scale window is applied to the dots), and augmented
euclidean slabs (pack_index augment=True: the plain dot against the
augmented query is the monotone rank x·q - |x|²/2).  Reference semantics
mirrored: one window per hash table per query, L-table union downstream
(/root/reference/lib/lsh_cube.hpp:77-106).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

_ALIGN = 32  # window starts align down to this many rows

# Triton kernel shape, fixed for the H100: a [_BLOCK_ROWS, d] slab block
# per loop step (8 KB of int8 at d=128) keeps the f32 upcast in registers
# at 4 warps; num_stages pipelines the block loads across loop steps.
_BLOCK_ROWS = 64
_NUM_WARPS = 4
_NUM_STAGES = 3

# The XLA form gathers at most this many slab elements per query block, so
# an unfused gather can never materialize more than a few GB.
_XLA_BLOCK_ELEMS = 1 << 30


def window_width(per_table: int) -> int:
    """Lanes per window: the requested run plus the alignment slack,
    rounded up to a 128 multiple."""
    return (per_table + _ALIGN + 127) // 128 * 128


def _window_dots_xla(
    flat: jax.Array,      # [R, d] slab rows
    rows0: jax.Array,     # [q, T] int32 absolute first row of each window
    queries: jax.Array,   # [q, d] f32
    win: int,
) -> jax.Array:
    """Plain reference: gather rows, f32 multiply, sum over d."""
    q, T = rows0.shape
    d = flat.shape[1]
    lanes = jnp.arange(win, dtype=jnp.int32)

    def block(args):
        r0, qv = args
        x = flat[r0[:, :, None] + lanes].astype(jnp.float32)
        return jnp.sum(x * qv[:, None, None, :], axis=-1)

    qb = max(1, min(q, _XLA_BLOCK_ELEMS // (T * win * d)))
    if qb >= q:
        return block((rows0, queries))
    pad = (-q) % qb
    r0 = jnp.pad(rows0, ((0, pad), (0, 0))).reshape(-1, qb, T)
    qv = jnp.pad(queries, ((0, pad), (0, 0))).reshape(-1, qb, d)
    return jax.lax.map(block, (r0, qv)).reshape(-1, T, win)[:q]


def _window_dots_kernel(win: int, d: int, dp: int):
    def kernel(rows_ref, q_ref, slab_ref, out_ref):
        i = pl.program_id(0)
        t = pl.program_id(1)
        r0 = rows_ref[i, t]
        qv = q_ref[i, :]                                   # [dp] f32
        col = jax.lax.broadcasted_iota(jnp.int32, (1, dp), 1)
        lane = jax.lax.broadcasted_iota(jnp.int32, (_BLOCK_ROWS, 1), 0)

        def step(j, carry):
            r = r0 + j * _BLOCK_ROWS
            if dp == d:
                x = slab_ref[pl.ds(pl.multiple_of(r, _ALIGN), _BLOCK_ROWS), :]
            else:
                # d is not a power of two: load a dp-wide block and mask
                # the columns past d (the padded query columns are zero)
                x = pltriton.load(
                    slab_ref.at[r + lane, col], mask=col < d, other=0
                )
            dots = jnp.sum(x.astype(jnp.float32) * qv[None, :], axis=1)
            out_ref[i, t, pl.ds(pl.multiple_of(j * _BLOCK_ROWS, _BLOCK_ROWS),
                                _BLOCK_ROWS)] = dots
            return carry

        jax.lax.fori_loop(0, win // _BLOCK_ROWS, step, 0)

    return kernel


def _window_dots_triton(
    flat: jax.Array,
    rows0: jax.Array,
    queries: jax.Array,
    win: int,
    interpret: bool = False,
) -> jax.Array:
    """Pallas kernel on the Triton route (see the module docstring).
    `interpret` exists for the CPU tests only."""
    q, T = rows0.shape
    d = flat.shape[1]
    dp = pl.next_power_of_2(d)
    qv = jnp.pad(queries, ((0, 0), (0, dp - d)))
    return pl.pallas_call(
        _window_dots_kernel(win, d, dp),
        grid=(q, T),
        out_shape=jax.ShapeDtypeStruct((q, T, win), jnp.float32),
        compiler_params=pltriton.CompilerParams(
            num_warps=_NUM_WARPS, num_stages=_NUM_STAGES),
        interpret=interpret,
        name="slab_window_dots",
    )(rows0, qv, flat)


def _kernel_fits(flat: jax.Array) -> bool:
    """The Triton route addresses the slab with 32-bit element offsets, so
    it takes slabs of fewer than 2^31 elements (8 x 2M x 128 int8 fits)."""
    return flat.shape[0] * flat.shape[1] < (1 << 31)


def window_dots_impl(platform: str, flat: jax.Array):
    """The one place that chooses how windowed dots run on `platform` (the
    platform a computation is lowered for): the Triton kernel on a CUDA
    GPU, the plain XLA form on the CPU."""
    if platform == "cuda":
        return _window_dots_triton if _kernel_fits(flat) else _window_dots_xla
    if platform == "cpu":
        return _window_dots_xla
    raise NotImplementedError(
        f"no windowed-dots implementation for platform {platform!r}")


def _window_dots(flat, rows0, queries, win):
    # lax.platform_dependent lowers only the branch of the platform the
    # computation is placed on, so a CPU-placed call in a GPU process
    # still gets the XLA form; an unknown platform fails to lower
    return jax.lax.platform_dependent(
        flat, rows0, queries,
        cpu=functools.partial(window_dots_impl("cpu", flat), win=win),
        cuda=functools.partial(window_dots_impl("cuda", flat), win=win),
    )


@functools.partial(
    jax.jit, static_argnames=("per_table", "mask", "shared_slab")
)
def slab_window_dots(
    packed: jax.Array,           # [L, n_pad, d] bf16/int8/f32 CSR-ordered slabs
    packed_scale: Optional[jax.Array],  # [L, n_pad] f32 (row-scale int8 only)
    starts: jax.Array,           # [q, T] int32 window starts within a slab
    sizes: jax.Array,            # [q, T] int32 valid rows per window
    queries: jax.Array,          # [q, d] f32, pre-normalized for cosine
    per_table: int,
    mask: bool = True,
    shared_slab: bool = False,
) -> Tuple[jax.Array, jax.Array]:
    """-> (dots [q, T, win] f32, aligned window starts [q, T] int32, LOCAL
    to each slab).

    Window t of a query reads slab t (T == L), or with shared_slab=True
    every window reads the ONE slab `packed[0]` — the hypercube form, where
    a query's probe windows all live in the single vertex-CSR slab (the
    MultiCube passes absolute segment offsets as starts).

    Lane j of window (q, t) holds the dot against CSR position
    aligned[q, t] + j.  With mask=True the valid rows sit at lanes
    [head, head + size) where head = starts - aligned (< _ALIGN unless the
    window was clamped at the slab end), and every other lane is -inf; with mask=False every lane carries its raw dot
    (see the module docstring).  Feed (dots, aligned) to slab_topk to
    recover row ids for the survivors.
    """
    n_pad, d = packed.shape[1], packed.shape[2]
    T = starts.shape[1]
    if shared_slab and packed.shape[0] != 1:
        raise ValueError("shared_slab expects packed [1, n_pad, d]")
    if not shared_slab and packed.shape[0] != T:
        raise ValueError(f"{T} windows per query need {T} slabs, got "
                         f"{packed.shape[0]}")
    win = window_width(per_table)
    if n_pad < win:
        raise ValueError(f"window {win} exceeds packed length {n_pad}")

    # align starts down; clamp so start + win stays inside the slab
    aligned = jnp.minimum((starts // _ALIGN) * _ALIGN, n_pad - win)
    # absolute rows in the flattened [L * n_pad, d] slab array
    l_off = (
        jnp.zeros((T,), jnp.int32) if shared_slab
        else jnp.arange(T, dtype=jnp.int32) * n_pad
    )
    rows0 = (aligned + l_off[None, :]).astype(jnp.int32)
    flat = packed.reshape(-1, d)
    dots = _window_dots(flat, rows0, queries.astype(jnp.float32), win)

    if mask:
        head = starts - aligned
        size = jnp.minimum(jnp.minimum(sizes, per_table), win - head)
        lane = jnp.arange(win, dtype=jnp.int32)
        valid = (lane >= head[..., None]) & (lane < (head + size)[..., None])
        dots = jnp.where(valid, dots, -jnp.inf)
    if packed_scale is not None:
        # per-row dequant: masked lanes stay -inf (scale > 0, pad scale 1)
        scale = packed_scale.reshape(-1)[
            rows0[..., None] + jnp.arange(win, dtype=jnp.int32)
        ]
        dots = dots * scale
    return dots, aligned


def _dedup_topk_pairs(
    scores: jax.Array,   # [q, m] with -inf pads
    ids: jax.Array,      # [q, m] with sentinel >= n_rows on pads
    n_rows: int,
    top_k: int,
) -> Tuple[jax.Array, jax.Array]:
    """Sort-dedup (score, id) pairs by id and re-select top_k — the same
    stage-2 epilogue as packed_retrieve_core.

    One multi-operand lax.sort carries the score payload THROUGH the id
    sort instead of argsort + take_along_axis, so the [q, m] payloads need
    no separate gathers."""
    q = scores.shape[0]
    raw_sorted, s_sorted = jax.lax.sort((ids, scores), num_keys=1)
    dup = jnp.concatenate(
        [jnp.zeros((q, 1), bool), raw_sorted[:, 1:] == raw_sorted[:, :-1]],
        axis=1,
    )
    s_sorted = jnp.where(
        dup | (raw_sorted >= n_rows) | ~jnp.isfinite(s_sorted),
        -jnp.inf, s_sorted,
    )
    s2, pos2 = jax.lax.top_k(s_sorted, top_k)
    ids_sorted = jnp.minimum(raw_sorted, n_rows - 1)
    out_ids = jnp.where(
        s2 > -jnp.inf, jnp.take_along_axis(ids_sorted, pos2, axis=1), -1
    )
    return s2, out_ids


def slab_topk(
    dots: jax.Array,          # [q, L, win] from slab_window_dots
    aligned_starts: jax.Array,  # [q, L] local CSR positions of lane 0
    packed_rows: jax.Array,   # [L, n_pad] int32 CSR-ordered row ids
    n_rows: int,
    top_k: int,
    exact: bool = True,
    stage1_width: int = 0,
    stage1_per_table: int = 0,
) -> Tuple[jax.Array, jax.Array]:
    """Two-stage dedup top-k over kernel dots.

    Stage 1 (exact=False, production) selects PER TABLE-WINDOW: an
    approx_max_k of top_k lanes over each [win] row of the [q*L, win]
    reshape.  Rows within one window are DISTINCT corpus rows (a row
    appears once per table), so if >= top_k lanes beat a lane in its own
    window, >= top_k distinct rows beat it globally — the union of
    per-window top-k's provably contains the global dedup top-k, the same
    worst-case guarantee as a flat L*top_k selection, with the selector run
    on win-wide rows instead of L*win-wide ones.  Stage 2 gathers the
    survivors' row ids from packed_rows and sort-dedups to the final top_k.

    NOT viable instead: any segmented pre-max along the CSR lane axis
    (group-max over 8/16/32 lanes) collapses recall — near-ties are
    ADJACENT in their bucket's CSR run in every table, so one group shadows
    all but one of them.  Co-location of near neighbours is intrinsic to
    LSH layouts.

    exact=True keeps the bit-stable flat lax.top_k form for parity tests.

    stage1_width (approx flat form only) caps the stage-1 survivor count
    below the L*top_k worst-case guarantee.  When set, the flat selector is
    used.

    stage1_per_table overrides the per-table selector's per-window kk
    BELOW top_k (keeps the cheap win-wide selector rows while relaxing the
    containment guarantee from top_k to kk) — the top-P>10 CF form, where
    rank-P-tail neighbour weights tolerate approximation.  Takes precedence
    over stage1_width.

    -> (scores [q, top_k] descending, row ids [q, top_k], -1 pad)."""
    q, L, win = dots.shape
    n_pad = packed_rows.shape[1]
    if not exact and (stage1_per_table or not stage1_width):
        # per-table stage 1 (see docstring guarantee); kk floor keeps
        # L * kk >= top_k so stage 2 can still emit top_k survivors
        kk = min(max(stage1_per_table or top_k, -(-top_k // L)), win)
        rows = dots.reshape(q * L, win)
        s1, lane = jax.lax.approx_max_k(rows, kk, recall_target=0.9)
        s1 = s1.reshape(q, L * kk)
        lane = lane.reshape(q, L, kk)
        gpos = (
            jnp.arange(L, dtype=jnp.int32)[None, :, None] * n_pad
            + jnp.minimum(aligned_starts[:, :, None] + lane, n_pad - 1)
        ).reshape(q, L * kk)
        ids1 = packed_rows.reshape(-1)[gpos]
        ids1 = jnp.where(s1 > -jnp.inf, ids1, n_rows)
        return _dedup_topk_pairs(s1, ids1, n_rows, top_k)
    flat = dots.reshape(q, L * win)
    m1 = min(L * top_k, L * win)
    if stage1_width:
        m1 = min(m1, max(stage1_width, top_k))
    if exact:
        s1, pos1 = jax.lax.top_k(flat, m1)             # [q, m1]
    else:
        s1, pos1 = jax.lax.approx_max_k(flat, m1, recall_target=0.9)
    l_of = pos1 // win
    lane = pos1 % win
    a0 = jnp.take_along_axis(aligned_starts, l_of, axis=1)     # [q, m1]
    gpos = l_of * n_pad + jnp.minimum(a0 + lane, n_pad - 1)
    ids1 = packed_rows.reshape(-1)[gpos]               # [q, m1]
    ids1 = jnp.where(s1 > -jnp.inf, ids1, n_rows)
    return _dedup_topk_pairs(s1, ids1, n_rows, top_k)


def packed_retrieve_pallas(
    packed: jax.Array,           # [L, n_pad, d] CSR-ordered corpus copies
    packed_rows: jax.Array,      # [L, n_pad] int32, sentinel n past the end
    packed_scale: Optional[jax.Array],  # [L, n_pad] f32 (int8 slabs)
    bucket_starts: jax.Array,    # [L, n_buckets + 1]
    n_rows: int,
    queries: jax.Array,          # [q, d]
    q_buckets: jax.Array,        # [q, L]
    top_k: int,
    per_table: int,
    strict: bool = False,
    stage1_width: int = 0,
    stage1_per_table: int = 0,
) -> Tuple[jax.Array, jax.Array]:
    """Windowed-dots counterpart of packed_retrieve_core (cosine,
    unfiltered): same pseudo-random window offsets, same dedup top-k
    epilogue.

    strict=False (production): maskless aligned-overfetch windows (a
    recall-superset of the reference's bucket windows) + approx stage-1
    selection.
    strict=True: exact reference window semantics + exact top_k, for
    parity against packed_retrieve_core."""
    L, n_pad = packed.shape[0], packed.shape[1]
    if strict and n_pad - n_rows < window_width(per_table):
        # a window starting at the last row must still fit before the slab
        # end, or the clamp would cut the exact reference window short
        raise ValueError(
            f"per_table={per_table} needs a {window_width(per_table)}-row "
            f"window past the last row but the packed pad is "
            f"{n_pad - n_rows}; re-pack with pack_index(..., "
            f"pad>={window_width(per_table)})"
        )
    l_idx = jnp.arange(L, dtype=jnp.int32)
    start = bucket_starts[l_idx[None, :], q_buckets]            # [q, L]
    end = bucket_starts[l_idx[None, :], q_buckets + 1]
    size = end - start
    # identical window-offset derivation to packed_retrieve_core
    golden = jnp.int32(-1640531527)
    mix = (q_buckets * golden) ^ (l_idx[None, :] * jnp.int32(40503))
    s0 = start + jnp.remainder(
        jnp.abs(mix), jnp.maximum(size - per_table, 0) + 1
    )
    sizes = jnp.minimum(end - s0, per_table)

    qv = queries.astype(jnp.float32)
    qv = qv / jnp.maximum(jnp.linalg.norm(qv, axis=1, keepdims=True), 1e-30)
    dots, a0 = slab_window_dots(
        packed, packed_scale, s0, sizes, qv,
        per_table=per_table, mask=strict,
    )
    return slab_topk(dots, a0, packed_rows, n_rows, top_k, exact=strict,
                     stage1_width=stage1_width,
                     stage1_per_table=stage1_per_table)


def packed_retrieve_pallas_euclid(
    packed: jax.Array,           # [L, n_pad, d_aug] AUGMENTED slabs
    packed_rows: jax.Array,      # [L, n_pad] int32, sentinel n past the end
    packed_detailed,             # [L, n_pad] fingerprints or None
    bucket_starts: jax.Array,    # [L, n_buckets + 1]
    n_rows: int,
    d: int,                      # original (un-augmented) dimensionality
    queries: jax.Array,          # [q, d] RAW euclidean queries
    q_buckets: jax.Array,        # [q, L]
    q_detailed,                  # [q, L] fingerprints or None
    gscale,                      # f32 scalar (int8 slabs) or None (bf16)
    aug_scale: jax.Array,        # f32 scalar: the norm column's query comp
    top_k: int,
    per_table: int,
) -> Tuple[jax.Array, jax.Array]:
    """Euclidean retrieval over AUGMENTED slabs (pack_index augment=True):
    the kernel's plain dot against the augmented query [q, s, 0-pad] is
    the monotone rank x·q - |x|²/2, so euclidean rides the exact same
    maskless windowed dots + approx epilogue as cosine; final scores are
    -sqrt(max(|q|² - 2·rank, 0)) = -distance, computed on the top_k
    survivors only.

    Window starts jump to the query's exact-fingerprint run when the
    fingerprint plane is present (the same (bucket, fingerprint) CSR
    contract as packed_retrieve_core) — lanes past the run are the
    aligned-overfetch multiprobe bonus, scored by TRUE distance, so recall
    is a superset of the reference's filtered bucket fetch
    (/root/reference/lib/data_structures/cust_hashtable.hpp:73-103)."""
    from crypto_rec_tpu.models.lsh.index import _fp_run_starts

    L, n_pad, d_aug = packed.shape
    q = queries.shape[0]
    l_idx = jnp.arange(L, dtype=jnp.int32)
    start = bucket_starts[l_idx[None, :], q_buckets]            # [q, L]
    end = bucket_starts[l_idx[None, :], q_buckets + 1]
    size = end - start
    if packed_detailed is not None and q_detailed is not None:
        flat_fp = packed_detailed.reshape(-1)
        base = l_idx[None, :] * n_pad
        s0 = _fp_run_starts(
            lambda p: flat_fp[base + p], start, end, q_detailed, n_pad
        )
    else:
        golden = jnp.int32(-1640531527)
        mix = (q_buckets * golden) ^ (l_idx[None, :] * jnp.int32(40503))
        s0 = start + jnp.remainder(
            jnp.abs(mix), jnp.maximum(size - per_table, 0) + 1
        )
    sizes = jnp.minimum(end - s0, per_table)

    qv = queries.astype(jnp.float32)
    q_aug = jnp.concatenate(
        [
            qv,
            jnp.broadcast_to(
                jnp.asarray(aug_scale, jnp.float32), (q, 1)
            ),
            jnp.zeros((q, d_aug - d - 1), jnp.float32),
        ],
        axis=1,
    )
    dots, a0 = slab_window_dots(
        packed, None, s0, sizes, q_aug,
        per_table=per_table, mask=False,
    )
    rank, ids = slab_topk(dots, a0, packed_rows, n_rows, top_k, exact=False)
    if gscale is not None:
        rank = rank * gscale                       # int8: dequant the rank
    qsq = jnp.sum(qv * qv, axis=1, keepdims=True)
    score = -jnp.sqrt(jnp.maximum(qsq - 2.0 * rank, 0.0))
    return jnp.where(ids >= 0, score, -jnp.inf), ids
