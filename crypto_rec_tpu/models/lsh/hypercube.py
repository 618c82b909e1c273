"""Hypercube LSH variant with Hamming-distance probing.

Reference semantics (/root/reference/lib/lsh_cube.hpp:108-177):
* k bit-valued functions map each vector to a vertex of a k-cube
  (2^k buckets).  Cosine metric: the bits are hyperplane signs
  (CosineHGen).  Euclidean metric: each bit is f(h(x)) where h is a p-stable
  hash and f memoizes a random bit per h-value (EuclideanFGen);
* a query starts at its own vertex and expands to vertices at increasing
  Hamming distance until `probes` buckets are consumed
  (get_hypercube_combined_buckets, lsh_cube.hpp:139-177).

Deviations (deliberate fixes, SURVEY.md §5 quirk list):
* EuclideanFGen draws its modulus from {1, 2} so about half its bit
  functions are constant 0 (euclidean_f_gen.hpp:65-79); we use an unbiased
  stateless integer mix of the h-value instead of a memo table — same role,
  better bits, no host-side state;
* the reference's probe loop skips Hamming distance 1 entirely when
  probes == 1 (lsh_cube.hpp:147-171); our `probes` means "total vertices
  visited, home vertex included", via a precomputed XOR-mask schedule
  (ops/hamming.py) — query-time probing is one vectorized XOR + gather.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp

from crypto_rec_tpu.models.lsh.hyperplane import CosineLsh
from crypto_rec_tpu.models.lsh.pstable import PStableLsh
from crypto_rec_tpu.models.lsh.index import _csr_from_buckets, _dedup_fixed
from crypto_rec_tpu.ops.hamming import hamming_probe_order


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=(
        "family", "mix_mul", "mix_add", "vertices", "sorted_rows",
        "bucket_starts", "packed", "packed_rows", "packed_sqnorm",
        "packed_scale", "packed_gscale", "packed_aug_scale",
    ),
    meta_fields=("metric", "k", "n_rows"),
)
@dataclasses.dataclass
class Hypercube:
    """One 2^k-bucket table keyed by cube vertex.

    The optional packed fields are the single-table packed-slab layout
    (pack_cube): the corpus rewritten in vertex-CSR order so each probed
    vertex's bucket is one contiguous slab — the same trick as
    index.pack_index, paid only ONCE (the cube has one table)."""

    metric: str
    k: int
    n_rows: int
    family: object          # CosineLsh (L=1) | PStableLsh (L=1, k h-functions)
    mix_mul: Optional[jax.Array]  # [k] int32 odd multipliers (euclidean f-bits)
    mix_add: Optional[jax.Array]  # [k] int32
    vertices: jax.Array     # [n] int32 vertex per indexed row
    sorted_rows: jax.Array  # [1, n]
    bucket_starts: jax.Array  # [1, 2^k + 1]
    packed: Optional[jax.Array] = None         # [1, n + pad, d]
    packed_rows: Optional[jax.Array] = None    # [1, n + pad]
    packed_sqnorm: Optional[jax.Array] = None  # [1, n + pad] (euclidean)
    packed_scale: Optional[jax.Array] = None   # [1, n + pad] (int8)
    # global-scale int8 only: the one dequant scalar (raw dots x it are
    # approximate sims; see index.LshIndex.packed_gscale)
    packed_gscale: Optional[jax.Array] = None
    # augmented-euclidean layout (pack_cube augment=True): dequant scale
    # for the -|x|^2/2 norm column (index.LshIndex.packed_aug_scale)
    packed_aug_scale: Optional[jax.Array] = None


def _f_bits(h: jax.Array, mul: jax.Array, add: jax.Array) -> jax.Array:
    """Stateless pseudorandom bit per (function, h-value): parity of a mixed
    product — replaces EuclideanFGen's memoized random bit."""
    mixed = h * mul[None, :] + add[None, :]
    mixed = mixed ^ (mixed >> 16) * jnp.int32(0x45D9F3B)
    return (mixed ^ (mixed >> 8)) & 1


def _pack_msb_first(bits: jax.Array, k: int) -> jax.Array:
    weights = (1 << jnp.arange(k - 1, -1, -1, dtype=jnp.int32))
    return jnp.sum(bits * weights, axis=-1)


def _vertex_ids(metric, k, family, mix_mul, mix_add, x: jax.Array) -> jax.Array:
    if metric == "cosine":
        bits = family.hash_bits(x)[:, 0, :]  # [n, k]
    else:
        h = family.hash_values(x)[:, 0, :]   # [n, k]
        bits = _f_bits(h, mix_mul, mix_add)
    return _pack_msb_first(bits, k)


def build_hypercube(
    key: jax.Array,
    vectors: jax.Array,
    metric: str,
    k: int,
    euclidean_h_w: float,
) -> Hypercube:
    """create_hypercube, batched (lsh_cube.hpp:108-136)."""
    d = vectors.shape[1]
    kf, km = jax.random.split(key)
    mix_mul = mix_add = None
    if metric == "cosine":
        fam = CosineLsh.create(kf, d, k, L=1)
    elif metric == "euclidean":
        fam = PStableLsh.create(kf, d, k, L=1, w=euclidean_h_w)
        k1, k2 = jax.random.split(km)
        mix_mul = jax.random.randint(k1, (k,), 0, 1 << 30, dtype=jnp.int32) * 2 + 1
        mix_add = jax.random.randint(k2, (k,), 0, 1 << 30, dtype=jnp.int32)
    else:
        raise ValueError(f"unknown metric {metric!r}")

    vertices = _vertex_ids(metric, k, fam, mix_mul, mix_add, vectors)
    sorted_rows, starts = _csr_from_buckets(vertices[:, None], 1 << k)
    return Hypercube(
        metric=metric,
        k=k,
        n_rows=vectors.shape[0],
        family=fam,
        mix_mul=mix_mul,
        mix_add=mix_add,
        vertices=vertices,
        sorted_rows=sorted_rows,
        bucket_starts=starts,
    )


def _bit_margins(cube: Hypercube, queries: jax.Array) -> jax.Array:
    """[q, k] per-bit confidence margins — how far each query sits from the
    decision boundary of each cube bit (small margin = the bit is likely to
    differ for a true near neighbor).

    cosine: |r_i . x| (distance to the hyperplane, up to |r_i| scaling);
    euclidean f-bits: the bit is a pseudorandom function of the p-stable
    cell index, so it can only differ when the cell changes — margin =
    distance of (v.x + t)/w to the nearest cell boundary."""
    dots = jnp.dot(
        queries.astype(jnp.float32), cube.family.proj,
        preferred_element_type=jnp.float32,
    )                                                     # [q, k] (L = 1)
    if cube.metric == "cosine":
        return jnp.abs(dots)
    z = (dots + cube.family.offsets[0][None]) / cube.family.w
    frac = z - jnp.floor(z)
    return jnp.minimum(frac, 1.0 - frac)


def directed_probe_vertices(
    cube: Hypercube, queries: jax.Array, probes: int,
    m_bits: Optional[int] = None,
) -> jax.Array:
    """Query-DIRECTED multiprobe: [q, d] -> [q, probes] vertex ids, home
    vertex first.

    The reference probes vertices in pure Hamming-distance order
    (get_hypercube_combined_buckets, lsh_cube.hpp:139-177) — blind to WHICH
    bits are uncertain.  Here each query enumerates the subsets of its m
    least-confident bits (margins from _bit_margins), scores each subset by
    its summed margin, and probes the `probes` lowest-scoring vertices —
    the query-directed scheme of multi-probe LSH (Lv et al., VLDB'07),
    fully vectorized: one top_k for the m soft bits, one [q, m] x [m, 2^m]
    subset-score matmul, one top_k over the 2^m subsets.  The empty subset
    scores 0, so the home vertex always leads.  Hamming order remains on
    the reference-parity paths (cube_candidate_mask / cube_candidate_ids).
    """
    k = cube.k
    q = queries.shape[0]
    margins = _bit_margins(cube, queries)                 # [q, k]
    if m_bits is None:
        # enough soft bits that the 2^m enumeration comfortably covers
        # `probes` subsets: 2 bits beyond ceil(log2(probes))
        m_bits = (max(2, probes - 1)).bit_length() + 2
    m = min(m_bits, k, 13)                                # cap 8192 subsets
    neg_m, pos = jax.lax.top_k(-margins, m)               # softest m bits
    small = -neg_m                                        # [q, m] ascending
    subsets = (
        (jnp.arange(1 << m, dtype=jnp.int32)[:, None]
         >> jnp.arange(m, dtype=jnp.int32)[None, :]) & 1
    )                                                     # [2^m, m]
    score = small @ subsets.astype(jnp.float32).T         # [q, 2^m]
    # per-query XOR masks: bits are packed MSB-first (_pack_msb_first)
    bitw = (1 << (k - 1 - pos)).astype(jnp.float32)       # [q, m]
    xor_masks = jnp.einsum(
        "sm,qm->qs", subsets.astype(jnp.float32), bitw,
        preferred_element_type=jnp.float32,
    ).astype(jnp.int32)                                   # [q, 2^m]
    _, sel = jax.lax.top_k(-score, min(probes, 1 << m))
    masks = jnp.take_along_axis(xor_masks, sel, axis=1)
    if masks.shape[1] < probes:                           # tiny-k fallback
        masks = jnp.pad(masks, ((0, 0), (0, probes - masks.shape[1])))
    home = _vertex_ids(
        cube.metric, cube.k, cube.family, cube.mix_mul, cube.mix_add, queries
    )
    return home[:, None] ^ masks


def cube_candidate_mask(cube: Hypercube, queries: jax.Array, probes: int) -> jax.Array:
    """Dense [q, n] mask — union of buckets over the probe schedule
    (get_hypercube_combined_buckets, lsh_cube.hpp:139-177)."""
    qv = _vertex_ids(cube.metric, cube.k, cube.family, cube.mix_mul, cube.mix_add, queries)
    masks = jnp.asarray(hamming_probe_order(cube.k, probes))  # [p]
    probe_vertices = qv[:, None] ^ masks[None, :]             # [q, p]
    return jnp.any(
        probe_vertices[:, :, None] == cube.vertices[None, None, :], axis=1
    )


@functools.partial(
    jax.jit, static_argnames=("dtype", "pad", "scale_mode", "augment")
)
def pack_cube(
    cube: Hypercube,
    corpus: jax.Array,
    dtype=jnp.bfloat16,
    pad: int = 4096,
    scale_mode: str = "auto",
    augment: bool = False,
) -> Hypercube:
    """Attach the packed-slab layout: the corpus rewritten in vertex-CSR
    order (index.pack_index applied to the cube's single table).  Cosine
    rows are pre-normalized.  scale_mode as in pack_index: int8 cosine
    defaults to one GLOBAL scalar scale (order-preserving raw dots, no
    packed_scale plane); euclidean keeps per-row scales.

    augment=True (euclidean only): the AUGMENTED rank layout of
    pack_index — raw rows plus a -|x|^2/2 column, one global scale — so
    euclidean cube probing rides the shared-slab windowed dots (the plain dot
    against [q, aug_scale, 0...] is the monotone euclidean rank)."""
    n = cube.n_rows
    d = corpus.shape[1]
    rows = cube.sorted_rows[0]
    quantized = jnp.issubdtype(jnp.dtype(dtype), jnp.integer)
    if augment and cube.metric != "euclidean":
        raise ValueError("augment=True is the euclidean rank layout")
    if scale_mode == "auto":
        if augment:
            scale_mode = "global" if quantized else "none"
        else:
            scale_mode = "global" if cube.metric == "cosine" else "row"
    if scale_mode not in ("global", "row", "none"):
        raise ValueError(f"unknown scale_mode {scale_mode!r}")

    g = corpus[rows].astype(jnp.float32)
    if cube.metric == "cosine":
        g = g / jnp.maximum(jnp.linalg.norm(g, axis=1, keepdims=True), 1e-30)
        sq = None
    else:
        sq = jnp.sum(g * g, axis=1)
    scale = g_scale = aug_scale = None
    if augment:
        d_aug = -(-(d + 1) // 128) * 128
        norm_half_max = jnp.max(sq) / 2.0
        if quantized:
            g_scale = jnp.maximum(jnp.max(jnp.abs(g)), 1e-30) / 127.0
            aug_scale = jnp.maximum(norm_half_max, 1e-30) / (127.0 * g_scale)
            body = jnp.clip(jnp.round(g / g_scale), -127, 127)
            norm_col = jnp.clip(
                jnp.round((-sq / 2.0) / (g_scale * aug_scale)), -127, 0)
        else:
            aug_scale = jnp.float32(1.0)
            body = g
            norm_col = -sq / 2.0
        g = jnp.concatenate(
            [body, norm_col[:, None],
             jnp.zeros((n, d_aug - d - 1), jnp.float32)], axis=1)
        sq = None
    elif quantized and scale_mode == "global":
        g_scale = jnp.maximum(jnp.max(jnp.abs(g)), 1e-30) / 127.0
        g = jnp.clip(jnp.round(g / g_scale), -127, 127)
    elif quantized:
        amax = jnp.max(jnp.abs(g), axis=1, keepdims=True)
        scale = jnp.maximum(amax, 1e-30) / 127.0
        g = jnp.clip(jnp.round(g / scale), -127, 127)
        scale = scale[:, 0]
    packed = g.astype(dtype)

    pad = -(n + pad) % 512 + pad  # align to the aligned-block grid
    kw: dict = {
        "packed": jnp.pad(packed, ((0, pad), (0, 0)))[None],
        "packed_rows": jnp.pad(rows, (0, pad), constant_values=n)[None],
    }
    if scale is not None:
        kw["packed_scale"] = jnp.pad(scale, (0, pad), constant_values=1.0)[None]
    if sq is not None:
        kw["packed_sqnorm"] = jnp.pad(sq, (0, pad))[None]
    if g_scale is not None:
        kw["packed_gscale"] = jnp.asarray(g_scale, jnp.float32)
    if augment:
        kw["packed_aug_scale"] = jnp.asarray(aug_scale, jnp.float32)
    return dataclasses.replace(cube, **kw)


@functools.partial(
    jax.jit,
    static_argnames=("top_k", "probes", "per_probe", "q_block",
                     "approx_stage1", "directed"),
)
def cube_retrieve_topk(
    cube: Hypercube,
    queries: jax.Array,   # [q, d]
    corpus: jax.Array,    # [n, d] — full-precision rows (int8 rerank)
    top_k: int,
    probes: int,
    per_probe: int = 256,
    q_block: int = 256,
    approx_stage1: bool = False,
    directed: bool = True,
):
    """Fused hypercube retrieval over the packed layout: probe schedule ->
    per-vertex slab windows -> score -> top-k.  Reuses the multi-table
    packed_retrieve_core by treating the `probes` probed vertices as virtual
    tables over the SAME single slab (probe buckets are disjoint, so the
    dedup stage is a no-op and every window reads table 0's slab).

    directed=True (default) probes each query's most-likely vertices by
    bit-confidence margins (directed_probe_vertices) instead of blind
    Hamming order — the same budget buys the vertices a near neighbor is
    actually likely to land in.  directed=False restores the reference's
    Hamming-order schedule (lsh_cube.hpp:139-177) for parity.

    approx_stage1=True selects the production path on cosine scale-free
    slabs (maskless shared-slab windowed dots + approximate stage-1);
    augmented euclidean slabs always ride the windowed dots.

    -> (scores [q, top_k] descending nearest-first, row ids [q, top_k]).
    """
    from crypto_rec_tpu.models.lsh.index import (
        packed_retrieve_core, rerank_exact,
    )

    if cube.packed is None:
        raise ValueError("pack_cube first (packed layout required)")
    quantized = jnp.issubdtype(cube.packed.dtype, jnp.integer)
    # approx_stage1 on cosine scale-free slabs (bf16/f32 or global-scale
    # int8) takes the production path: maskless shared-slab windowed dots
    # (the `probes` vertex windows of a query all read the one vertex-CSR
    # slab) + approximate stage-1.  Otherwise the blocked core below keeps
    # the exact probe-union semantics.
    if (cube.metric == "cosine" and cube.packed_scale is None
            and approx_stage1):
        return _cube_retrieve_kernel(
            cube, queries, corpus, top_k, probes, per_probe,
            directed=directed,
        )
    if cube.packed_aug_scale is not None:
        # augmented slabs: euclidean probing rides the same windowed dots
        # (rank dot) the euclidean LSH tables use
        return _cube_retrieve_kernel_euclid(
            cube, queries, top_k, probes, per_probe, directed=directed,
        )
    masks = jnp.asarray(hamming_probe_order(cube.k, probes))  # [p]
    core_k = min(4 * top_k, probes * top_k) if quantized else top_k

    q = queries.shape[0]
    pad_q = (-q) % q_block
    queries_p = jnp.pad(queries, ((0, pad_q), (0, 0)))

    def one_block(blk):
        if directed:
            probe_vertices = directed_probe_vertices(cube, blk, probes)
        else:
            qv = _vertex_ids(
                cube.metric, cube.k, cube.family, cube.mix_mul, cube.mix_add,
                blk,
            )
            probe_vertices = qv[:, None] ^ masks[None, :]      # [q, p]
        s, ids = packed_retrieve_core(
            cube.packed, cube.packed_rows, cube.packed_sqnorm, None,
            cube.bucket_starts, cube.n_rows, cube.metric,
            blk, probe_vertices, None, core_k, per_probe,
            packed_scale=cube.packed_scale, approx_stage1=approx_stage1,
        )
        if quantized:
            s, ids = rerank_exact(corpus, cube.metric, blk, ids, top_k)
        return s, ids

    vals, ids = jax.lax.map(
        one_block, queries_p.reshape(-1, q_block, queries.shape[1])
    )
    return vals.reshape(-1, vals.shape[-1])[:q], ids.reshape(-1, ids.shape[-1])[:q]


def _cube_retrieve_kernel_euclid(
    cube: Hypercube,
    queries: jax.Array,   # [q, d] RAW euclidean queries
    top_k: int,
    probes: int,
    per_probe: int,
    directed: bool = True,
):
    """Euclidean hypercube probing on the shared-slab windowed dots over
    the AUGMENTED layout (pack_cube augment=True): the plain dot of the
    augmented query against a slab row is the monotone rank x.q - |x|^2/2,
    so the probe windows take the identical maskless path as the cosine
    cube; per-window stage-1 + id-dedup epilogue (the multicube lesson),
    then the top_k ranks are dequantized and mapped to -distance."""
    from crypto_rec_tpu.ops.pallas.slabscore import (
        _dedup_topk_pairs, slab_window_dots,
    )

    q, d = queries.shape
    n_pad = cube.packed.shape[1]
    d_aug = cube.packed.shape[2]
    qv = queries.astype(jnp.float32)
    if directed:
        pv = directed_probe_vertices(cube, queries, probes)       # [q, T]
    else:
        masks = jnp.asarray(hamming_probe_order(cube.k, probes))
        home = _vertex_ids(
            cube.metric, cube.k, cube.family, cube.mix_mul, cube.mix_add,
            queries,
        )
        pv = home[:, None] ^ masks[None, :]
    starts = cube.bucket_starts[0]
    start = starts[pv]
    end = starts[pv + 1]
    size = end - start
    golden = jnp.int32(-1640531527)
    t_idx = jnp.arange(probes, dtype=jnp.int32)
    mix = (pv * golden) ^ (t_idx[None, :] * jnp.int32(40503))
    s0 = start + jnp.remainder(
        jnp.abs(mix), jnp.maximum(size - per_probe, 0) + 1
    )
    sizes = jnp.minimum(end - s0, per_probe)

    q_aug = jnp.concatenate(
        [
            qv,
            jnp.broadcast_to(
                jnp.asarray(cube.packed_aug_scale, jnp.float32), (q, 1)),
            jnp.zeros((q, d_aug - d - 1), jnp.float32),
        ],
        axis=1,
    )
    dots, a_flat = slab_window_dots(
        cube.packed, None, s0, sizes, q_aug,
        per_table=per_probe, mask=False, shared_slab=True,
    )                                                 # [q, probes, win]
    win = dots.shape[2]
    kk = min(top_k, win)
    rows2 = dots.reshape(q * probes, win)
    s1, lane = jax.lax.approx_max_k(rows2, kk, recall_target=0.9)
    s1 = s1.reshape(q, probes * kk)
    lane = lane.reshape(q, probes, kk)
    gpos = (a_flat[:, :, None] + lane).reshape(q, probes * kk)
    ids1 = cube.packed_rows[0][jnp.minimum(gpos, n_pad - 1)]
    ids1 = jnp.where(s1 > -jnp.inf, ids1, cube.n_rows)
    rank, ids = _dedup_topk_pairs(s1, ids1, cube.n_rows, top_k)
    if cube.packed_gscale is not None:
        rank = rank * cube.packed_gscale
    qsq = jnp.sum(qv * qv, axis=1, keepdims=True)
    score = -jnp.sqrt(jnp.maximum(qsq - 2.0 * rank, 0.0))
    return jnp.where(ids >= 0, score, -jnp.inf), ids


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=("cubes", "packed", "packed_rows", "bucket_starts",
                 "packed_gscale", "packed_aug_scale"),
    meta_fields=("metric", "k", "n_rows", "n_cubes", "n_pad"),
)
@dataclasses.dataclass
class MultiCube:
    """C independent hypercubes over the same corpus, slabs CONCATENATED
    into one shared-slab segment array — the cube analog of L LSH tables.

    A single cube's recall ceiling is structural: query-directed probing
    enumerates subsets of the m least-confident bits, so a true neighbor
    that differs in a CONFIDENT bit is unreachable at any probe budget
    (recall plateaus near 0.978 on the 2M planted corpus for k=13 AND
    k=14, probes 16..48).  C independent cubes make those misses
    independent: 1 - (1 - 0.978)^2 ~ 0.9995.  Probing runs the
    shared-slab windowed dots ONCE over all C x probes windows (each
    cube's windows offset into its own slab segment), so the union costs
    one call, not C.

    Euclidean cubes use the AUGMENTED slab layout (pack_cube
    augment=True): each segment carries raw rows plus the -|x|^2/2
    column, so the same plain dot computes the monotone euclidean
    rank — the scales are identical across segments (same row set)."""

    metric: str
    k: int
    n_rows: int
    n_cubes: int
    n_pad: int                  # per-cube slab segment length
    cubes: tuple                # C unpacked Hypercubes (families + mixes)
    packed: jax.Array           # [1, C * n_pad, d]
    packed_rows: jax.Array      # [1, C * n_pad]
    bucket_starts: jax.Array    # [C, 2^k + 1] (segment-LOCAL)
    packed_gscale: Optional[jax.Array]
    packed_aug_scale: Optional[jax.Array] = None  # euclidean layout only


def build_multicube(
    key: jax.Array,
    vectors: jax.Array,
    metric: str,
    n_cubes: int,
    k: int,
    euclidean_h_w: float,
    corpus_dtype=jnp.bfloat16,
    pad: int = 4096,
) -> MultiCube:
    """C independent build_hypercube + pack_cube, slabs concatenated into
    the shared-slab layout.  All cubes pack the same normalized row set,
    so the int8 global scale is identical across cubes (asserted).
    Euclidean cubes pack the augmented rank layout (pack_cube
    augment=True) — one aug_scale, shared by every segment."""
    augment = metric == "euclidean"
    cubes = []
    packed, rows = [], []
    starts = []
    gscale = aug_scale = None
    for ci in range(n_cubes):
        cube = build_hypercube(
            jax.random.fold_in(key, ci), vectors, metric, k, euclidean_h_w
        )
        pc = pack_cube(cube, vectors, dtype=corpus_dtype, pad=pad,
                       augment=augment)
        if pc.packed_scale is not None:
            raise ValueError("multicube covers scale-free slabs only")
        packed.append(pc.packed[0])
        rows.append(pc.packed_rows[0])
        starts.append(pc.bucket_starts[0])
        if pc.packed_gscale is not None:
            gscale = pc.packed_gscale  # identical row set => same scale
        if pc.packed_aug_scale is not None:
            aug_scale = pc.packed_aug_scale
        cubes.append(
            dataclasses.replace(
                cube, packed=None, packed_rows=None, packed_sqnorm=None,
                packed_scale=None, packed_gscale=None,
            )
        )
    return MultiCube(
        metric=metric, k=k, n_rows=vectors.shape[0], n_cubes=n_cubes,
        n_pad=packed[0].shape[0],
        cubes=tuple(cubes),
        packed=jnp.concatenate(packed, axis=0)[None],
        packed_rows=jnp.concatenate(rows, axis=0)[None],
        bucket_starts=jnp.stack(starts),
        packed_gscale=gscale,
        packed_aug_scale=aug_scale,
    )


@functools.partial(
    jax.jit,
    static_argnames=("top_k", "probes", "per_probe", "directed"),
)
def multicube_retrieve_topk(
    mc: MultiCube,
    queries: jax.Array,   # [q, d]
    top_k: int,
    probes: int,          # PER-CUBE probe count
    per_probe: int = 256,
    directed: bool = True,
):
    """Union retrieval over C cubes in ONE shared-slab windowed-dots call:
    each cube contributes its `probes` (directed) vertex windows, offset
    into its slab segment; the maskless windows + approx stage-1 +
    id-dedup epilogue are exactly the LSH production path.  Euclidean
    multicubes ride the augmented rank layout (plain dot = monotone
    x.q - |x|^2/2), scores mapped to -distance after the dedup.

    -> (scores [q, top_k] descending nearest-first, row ids, -1 pad)."""
    from crypto_rec_tpu.ops.pallas.slabscore import (
        _dedup_topk_pairs, slab_window_dots,
    )

    C, n_pad = mc.n_cubes, mc.n_pad
    q, d = queries.shape
    T = C * probes
    qv = queries.astype(jnp.float32)
    if mc.metric == "cosine":
        qv = qv / jnp.maximum(
            jnp.linalg.norm(qv, axis=1, keepdims=True), 1e-30)
        q_kernel = qv
    else:
        if mc.packed_aug_scale is None:
            raise ValueError(
                "euclidean multicube requires the augmented slab layout")
        d_aug = mc.packed.shape[2]
        q_kernel = jnp.concatenate(
            [
                qv,
                jnp.broadcast_to(
                    jnp.asarray(mc.packed_aug_scale, jnp.float32), (q, 1)),
                jnp.zeros((q, d_aug - d - 1), jnp.float32),
            ],
            axis=1,
        )

    pv_l, s0_l, sz_l = [], [], []
    for ci, cube in enumerate(mc.cubes):
        if directed:
            pv = directed_probe_vertices(cube, queries, probes)
        else:
            masks = jnp.asarray(hamming_probe_order(mc.k, probes))
            home = _vertex_ids(
                mc.metric, mc.k, cube.family, cube.mix_mul, cube.mix_add,
                queries,
            )
            pv = home[:, None] ^ masks[None, :]
        starts = mc.bucket_starts[ci]
        b0 = starts[pv]
        b1 = starts[pv + 1]
        size = b1 - b0
        golden = jnp.int32(-1640531527)
        t_idx = jnp.arange(probes, dtype=jnp.int32)
        mix = (pv * golden) ^ ((t_idx + ci * probes)[None, :]
                               * jnp.int32(40503))
        s0 = b0 + jnp.remainder(
            jnp.abs(mix), jnp.maximum(size - per_probe, 0) + 1
        )
        s0_l.append(s0 + ci * n_pad)          # absolute segment offset
        sz_l.append(jnp.minimum(b1 - s0, per_probe))
    s0 = jnp.concatenate(s0_l, axis=1)        # [q, T]
    sizes = jnp.concatenate(sz_l, axis=1)

    dots, a_flat = slab_window_dots(
        mc.packed, None, s0, sizes, q_kernel,
        per_table=per_probe, mask=False, shared_slab=True,
    )                                         # [q, T, win]
    win = dots.shape[2]
    # PER-WINDOW stage 1 (the LSH production epilogue, slab_topk's
    # per-table branch with absolute window offsets): a flat approx
    # selector over all T windows loses duplicate-crowded near-ties (a
    # twin found by BOTH cubes occupies two survivor slots).
    kk = min(top_k, win)
    rows2 = dots.reshape(q * T, win)
    s1, lane = jax.lax.approx_max_k(rows2, kk, recall_target=0.9)
    s1 = s1.reshape(q, T * kk)
    lane = lane.reshape(q, T, kk)
    total = C * n_pad
    gpos = (a_flat[:, :, None] + lane).reshape(q, T * kk)
    ids1 = mc.packed_rows[0][jnp.minimum(gpos, total - 1)]
    ids1 = jnp.where(s1 > -jnp.inf, ids1, mc.n_rows)
    s2, ids = _dedup_topk_pairs(s1, ids1, mc.n_rows, top_k)
    if mc.metric == "euclidean":
        # rank -> -distance (the _cube_retrieve_kernel_euclid epilogue)
        if mc.packed_gscale is not None:
            s2 = s2 * mc.packed_gscale
        qsq = jnp.sum(qv * qv, axis=1, keepdims=True)
        score = -jnp.sqrt(jnp.maximum(qsq - 2.0 * s2, 0.0))
        return jnp.where(ids >= 0, score, -jnp.inf), ids
    if mc.packed_gscale is not None:
        s2 = jnp.where(ids >= 0, s2 * mc.packed_gscale, -jnp.inf)
    return s2, ids


@functools.partial(jax.jit, static_argnames=("probes", "budget"))
def cube_candidate_ids(
    cube: Hypercube, queries: jax.Array, probes: int, budget: int
) -> jax.Array:
    """CSR fixed-budget probe: [q, d] -> [q, budget] row ids (-1 pad)."""
    qv = _vertex_ids(cube.metric, cube.k, cube.family, cube.mix_mul, cube.mix_add, queries)
    masks = jnp.asarray(hamming_probe_order(cube.k, probes))
    # Any single probed vertex may supply the whole candidate budget (the
    # reference unions whole buckets, lsh_cube.hpp:139-177).
    per_probe = budget
    sentinel = cube.n_rows

    def per_query(v):
        def gather(b):
            start = cube.bucket_starts[0, b]
            end = cube.bucket_starts[0, b + 1]
            offs = start + jnp.arange(per_probe, dtype=jnp.int32)
            rows = cube.sorted_rows[0, jnp.minimum(offs, cube.n_rows - 1)]
            return jnp.where(offs < end, rows, sentinel)

        gathered = jax.vmap(gather)(v ^ masks).reshape(-1)
        return _dedup_fixed(gathered, sentinel, budget)

    return jax.vmap(per_query)(qv)


def _cube_retrieve_kernel(
    cube: Hypercube,
    queries: jax.Array,   # [q, d]
    corpus: jax.Array,    # [n, d] (int8 no-rerank: unused)
    top_k: int,
    probes: int,
    per_probe: int,
    directed: bool = True,
):
    """Cosine hypercube probing on the shared-slab windowed dots: each
    query's `probes` vertex windows all read the one vertex-CSR slab.
    Maskless multiprobe + approx stage-1 + id-dedup, exactly the cosine
    production epilogue; global-scale int8 dots are dequantized with the
    stored scalar."""
    from crypto_rec_tpu.ops.pallas.slabscore import (
        _dedup_topk_pairs, slab_window_dots,
    )

    q, d = queries.shape
    n_pad = cube.packed.shape[1]
    qv = queries.astype(jnp.float32)
    qv = qv / jnp.maximum(jnp.linalg.norm(qv, axis=1, keepdims=True), 1e-30)
    if directed:
        pv = directed_probe_vertices(cube, queries, probes)       # [q, T]
    else:
        masks = jnp.asarray(hamming_probe_order(cube.k, probes))  # [T]
        home = _vertex_ids(
            cube.metric, cube.k, cube.family, cube.mix_mul, cube.mix_add,
            queries,
        )
        pv = home[:, None] ^ masks[None, :]                       # [q, T]
    starts = cube.bucket_starts[0]
    start = starts[pv]
    end = starts[pv + 1]
    size = end - start
    golden = jnp.int32(-1640531527)
    t_idx = jnp.arange(probes, dtype=jnp.int32)
    mix = (pv * golden) ^ (t_idx[None, :] * jnp.int32(40503))
    s0 = start + jnp.remainder(
        jnp.abs(mix), jnp.maximum(size - per_probe, 0) + 1
    )
    sizes = jnp.minimum(end - s0, per_probe)

    dots, a_flat = slab_window_dots(
        cube.packed, None, s0, sizes, qv,
        per_table=per_probe, mask=False, shared_slab=True,
    )                                                 # [q, probes, win]
    win = dots.shape[2]
    flat = dots.reshape(q, probes * win)
    m1 = min(max(4 * top_k, 16), probes * win)
    s1, pos1 = jax.lax.approx_max_k(flat, m1, recall_target=0.9)
    # recover CSR positions: window t = pos1 // win, lane = pos1 % win
    t_of = pos1 // win
    lane = pos1 % win
    gpos = jnp.take_along_axis(a_flat, t_of, axis=1) + lane
    ids1 = cube.packed_rows[0][jnp.minimum(gpos, n_pad - 1)]
    ids1 = jnp.where(s1 > -jnp.inf, ids1, cube.n_rows)
    s2, ids = _dedup_topk_pairs(s1, ids1, cube.n_rows, top_k)
    if cube.packed_gscale is not None:
        s2 = jnp.where(ids >= 0, s2 * cube.packed_gscale, -jnp.inf)
    return s2, ids
