"""Proof that the system runs on an NVIDIA GPU: `python chip_smoke.py`.

Drives the main paths once, through the entry points a user calls, at real
size, and checks every result against the repo's own references.  Phases
(one card, the default):

  0. device check: stops with a non-zero exit unless JAX's first device is
     a GPU; prints nvidia-smi's name and power limit.
  1. the reference-binary pipeline CLI (crypto_rec_tpu.main) on a
     synthetic dataset, default and fused engine, run on the GPU and again
     on the CPU as the plain reference: MAE and >= 99% of the
     recommendation lines agree.
  2. serving at 2M x 128: the int8 cosine index checkpointed and served by
     serve_cli, then every windowed-dots layout in-process at 32,768
     planted queries, each held to its recall floor; the exact oracle (at
     HIGHEST precision) agrees with the planted truth.
  3. the Triton windowed-dots kernel against the plain XLA form at phase
     2's shapes: dots within the f32 sum-order band, top-k ids equal
     outside it; both forms timed, dots alone and end to end.

`--multi` runs only the four-card path (sharded index, sharded CF,
routing, placement) and its single-card comparison.  `--phases 0,3` runs a
subset of the one-card phases.  The last line printed is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
Any failed check raises, so the exit code is non-zero and no such line is
printed.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# one-card sizes; the rehearsal on a CPU passes smaller ones
SIZES = dict(
    users=20_000, tweets=400_000,
    n=2_000_000, d=128, q=32_768, serve_q=4096, oracle_q=1024,
    multi_n=8_000_000, multi_q=16_384, route_n=1_000_000, route_q=4096,
)
TOPK = 10
REPS = 5


def log(*a):
    print(*a, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def timed(fn, reps=REPS):
    """Median wall time of fn() over warm repetitions, each ended by
    jax.block_until_ready."""
    import jax
    import numpy as np

    jax.block_until_ready(fn())            # warm: compile + first run
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


# --------------------------------------------------------------- phase 0
def phase_device(count):
    import jax

    devs = jax.devices()
    d0 = devs[0]
    if d0.platform != "gpu":
        raise SystemExit(
            f"chip_smoke needs a GPU; JAX found platform {d0.platform!r}")
    if len(devs) < count:
        raise SystemExit(f"chip_smoke needs {count} GPUs, found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    for line in smi[:count]:
        log(line)
    limit = (d0.memory_stats() or {}).get("bytes_limit")
    log(f"device_kind={d0.device_kind} bytes_limit={limit} "
        f"devices={len(devs)}")
    return devs[:count]


# --------------------------------------------------------------- phase 1
def _run_cli(argv):
    from crypto_rec_tpu.main import main as cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli(argv)
    check(rc == 0, f"pipeline exit code {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _rec_lines(path):
    """-> (phase headers, [(phase number, recommendation line)])."""
    heads, recs = [], []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line in ("Cosine LSH", "Clustering Recommendation"):
                heads.append(line)
            elif line.startswith("Execution Time:"):
                heads.append("time")
            elif line:
                recs.append((sum(h != "time" for h in heads), line))
    return heads, recs


def _identical(ra, rb):
    """-> (fraction of identical lines, per-phase fractions, differing
    line indices)."""
    check(len(ra) == len(rb) and all(x[0] == y[0] for x, y in zip(ra, rb)),
          "outputs differ in shape")
    diff = [i for i, (x, y) in enumerate(zip(ra, rb)) if x[1] != y[1]]
    per = {}
    for ph in sorted({p for p, _ in ra}):
        idx = [i for i, (p, _) in enumerate(ra) if p == ph]
        bad = len(set(idx) & set(diff))
        per[ph] = round(1 - bad / len(idx), 5)
    return 1 - len(diff) / max(1, len(ra)), per, diff


def phase_pipeline(work, sizes):
    """The CLI on the card, then on the CPU (the plain reference).  CF dots
    run at DEFAULT precision, which the card may execute in TF32; k-means
    distances run at HIGHEST.  A recommendation line may still differ where
    two candidates tie within the rounding band (a TF32 CF dot, or an f32
    sum taken in another order inside the Lloyd iterations), so at least
    99% of the lines must be identical, and a differing line must still
    answer the same user."""
    import jax

    from crypto_rec_tpu.io.synth import write_synthetic_dataset
    from crypto_rec_tpu.ops.pallas import slabscore

    tw, conf = write_synthetic_dataset(
        os.path.join(work, "ds"), n_users=sizes["users"],
        n_tweets=sizes["tweets"], n_coins=15, seed=7)
    cpu = jax.devices("cpu")[0]
    runs = {
        "gpu": contextlib.nullcontext,
        "cpu": lambda: jax.default_device(cpu),
    }
    traced = []
    choose = slabscore.window_dots_impl
    slabscore.window_dots_impl = lambda p, f: (traced.append(p), choose(p, f))[1]
    try:
        for engine in ("default", "fused"):
            extra = [] if engine == "default" else ["--engine", "fused"]
            out = {}
            for where, ctx in runs.items():
                path = os.path.join(work, f"pipe_{engine}_{where}.txt")
                n0 = len(traced)
                t0 = time.perf_counter()
                with ctx():
                    summary = _run_cli(
                        ["-d", tw, "-o", path, "-c", conf, "-validate"]
                        + extra)
                wall = time.perf_counter() - t0
                if engine == "fused":
                    check(len(traced) > n0,
                          f"fused {where} run never reached the windowed dots")
                heads, recs = _rec_lines(path)
                check(heads.count("Cosine LSH") == 2
                      and heads.count("Clustering Recommendation") == 2
                      and heads.count("time") == 4,
                      f"{engine}/{where}: output lacks its 4 phases")
                mae = summary["mae_10fold"]
                check(math.isfinite(mae), f"{engine}/{where}: MAE {mae}")
                out[where] = (mae, recs)
                log(f"pipeline engine={engine} on {where}: {wall:.1f} s, "
                    f"10-fold MAE {mae:.6f}, {len(recs)} recommendation "
                    f"lines, phase_ms {summary['phase_ms']}")
            (mg, rg), (mc, rc) = out["gpu"], out["cpu"]
            same, per, diff = _identical(rg, rc)
            log(f"pipeline engine={engine}: |MAE gpu - cpu| = "
                f"{abs(mg - mc):.2e}; identical lines {same:.5f}, per "
                f"phase {per}")
            for i in diff[:3]:
                log(f"  differs: gpu {rg[i][1]!r} / cpu {rc[i][1]!r}")
            check(abs(mg - mc) <= 1e-3,
                  f"{engine}: MAE gpu {mg} vs cpu {mc} differ by > 1e-3")
            check(same >= 0.99, f"{engine}: only {same:.5f} lines identical")
            for i in diff:
                check(rg[i][1].split()[0] == rc[i][1].split()[0],
                      f"{engine}: line {i} answers another user")
    finally:
        slabscore.window_dots_impl = choose


# --------------------------------------------------------------- phase 2
def _recall(ids, true_idx):
    from crypto_rec_tpu.ops.oracle import recall_at_k

    return float(recall_at_k(ids, true_idx))


def build_state(sizes):
    """The 2M planted corpus and every index phase 2 and 3 serve from."""
    import jax
    import jax.numpy as jnp

    from crypto_rec_tpu.io.synth import planted_clustered_corpus
    from crypto_rec_tpu.models.lsh.hypercube import (
        build_hypercube, build_multicube, pack_cube,
    )
    from crypto_rec_tpu.models.lsh.index import build_index, pack_index

    n, d, q = sizes["n"], sizes["d"], sizes["q"]
    L, budget = 8, 1024
    # bench.py's auto k: one bit below "average bucket == budget / L"
    k = max(8, math.ceil(math.log2(max(2, n / (budget // L)))) - 1)
    pt = min(budget, max(128, 2 * n // (1 << k)))
    t0 = time.perf_counter()
    corpus, queries, true_idx = planted_clustered_corpus(
        jax.random.PRNGKey(0), n, d, q, TOPK)
    idx = build_index(jax.random.PRNGKey(1), corpus, "cosine", k, L,
                      lsh_bucket_div=4, euclidean_h_w=1.0)
    pidx = pack_index(idx, corpus, dtype=jnp.int8)
    eidx = build_index(jax.random.PRNGKey(21), corpus, "euclidean", 5, 4,
                       lsh_bucket_div=4, euclidean_h_w=20.0)
    eidx = pack_index(eidx, corpus, dtype=jnp.int8, augment=True)
    cube = build_hypercube(jax.random.PRNGKey(7), corpus, "cosine", k, 8.0)
    cube = pack_cube(cube, corpus, dtype=jnp.int8)
    mc = build_multicube(jax.random.PRNGKey(7), corpus, "cosine", 2, k, 8.0,
                         corpus_dtype=jnp.int8)
    jax.block_until_ready((pidx, eidx, cube, mc))
    log(f"state: {n} x {d} corpus, k={k} L={L} window={pt}; cosine, "
        f"euclidean, cube and multicube indexes built and packed in "
        f"{time.perf_counter() - t0:.1f} s; slabs "
        f"{pidx.packed.nbytes / 1e9:.2f} GB ({pidx.packed.dtype})")
    return dict(corpus=corpus, queries=queries, true_idx=true_idx,
                idx=idx, pidx=pidx, eidx=eidx, cube=cube, mc=mc,
                k=k, L=L, pt=pt)


def layouts(st):
    """name -> (run(queries) -> (scores, ids), recall floor)."""
    import jax
    import jax.numpy as jnp

    from crypto_rec_tpu.models.lsh.hypercube import (
        cube_retrieve_topk, multicube_retrieve_topk,
    )
    from crypto_rec_tpu.models.lsh.index import (
        candidate_ids_scored, retrieve_topk, retrieve_topk_pallas,
    )
    from crypto_rec_tpu.models.rec.engine import (
        RatingSet, recommend_topk_retrieved,
    )

    corpus, pidx, pt = st["corpus"], st["pidx"], st["pt"]
    n, d = corpus.shape
    n_known = jax.random.bernoulli(jax.random.PRNGKey(11), 0.6, (n, d))
    nset = RatingSet(corpus, n_known, jnp.sum(corpus * n_known, 1)
                     / jnp.maximum(jnp.sum(n_known, 1), 1))

    def cf(qs):
        # bench.py's CF form: top-20 neighbours -> predict -> top-5
        kq = jax.random.bernoulli(jax.random.PRNGKey(12), 0.6, qs.shape)
        qset = RatingSet(qs, kq, jnp.sum(qs * kq, 1)
                         / jnp.maximum(jnp.sum(kq, 1), 1))
        sims, nidx = retrieve_topk_pallas(
            pidx, qs, corpus, top_k=20, per_table=pt, int8_rerank=False,
            stage1_per_table=12)
        rec = recommend_topk_retrieved(qset, nset, sims, nidx, 5)
        return rec.predicted, rec.neighbor_idx[:, :TOPK]

    return {
        "retrieve_topk_pallas": (lambda qs: retrieve_topk_pallas(
            pidx, qs, corpus, top_k=TOPK, per_table=pt, int8_rerank=False),
            0.99),
        "cf_top20_top5": (cf, 0.99),
        "candidate_ids_scored": (lambda qs: (None, candidate_ids_scored(
            pidx, qs, budget=256, per_table=pt)), 0.99),
        "euclidean_augmented": (lambda qs: retrieve_topk(
            st["eidx"], qs, corpus, top_k=TOPK, per_table=768,
            q_block=4096, approx_stage1=True), 0.99),
        "cube": (lambda qs: cube_retrieve_topk(
            st["cube"], qs, corpus, top_k=TOPK, probes=16, per_probe=976,
            approx_stage1=True), 0.95),
        "multicube": (lambda qs: multicube_retrieve_topk(
            st["mc"], qs, top_k=TOPK, probes=12, per_probe=pt), 0.99),
    }


def phase_serving(work, st, sizes):
    import jax
    import numpy as np

    from crypto_rec_tpu import serve_cli
    from crypto_rec_tpu.checkpoint import save_index
    from crypto_rec_tpu.ops.oracle import exact_nearest

    corpus, queries, true_idx = st["corpus"], st["queries"], st["true_idx"]
    # checkpoint + serve_cli (the restore-and-serve path)
    t0 = time.perf_counter()
    ipath = os.path.join(work, "index.npz")
    cpath = os.path.join(work, "corpus.npz")
    qpath = os.path.join(work, "queries.csv")
    save_index(ipath, st["pidx"])
    np.savez(cpath, vectors=np.asarray(corpus))
    sq = np.asarray(queries[:sizes["serve_q"]])
    with open(qpath, "w") as f:
        for i, row in enumerate(sq):
            f.write(",".join([f"q{i}"] + [f"{v:.7g}" for v in row]) + "\n")
    opath = os.path.join(work, "served.tsv")
    rc = serve_cli.main([
        "retrieve", "--index", ipath, "--corpus", cpath, "--queries", qpath,
        "--top-k", str(TOPK), "--per-table", str(st["pt"]), "--pack",
        "--fast-int8", "-o", opath,
    ])
    check(rc == 0, f"serve_cli exit code {rc}")
    served = np.full((len(sq), TOPK), -1, np.int32)
    with open(opath) as f:
        lines = f.read().splitlines()
    check(len(lines) == len(sq), f"serve_cli wrote {len(lines)} lines")
    for i, line in enumerate(lines):
        toks = line.split("\t")
        check(toks[0] == f"q{i}", f"serve_cli line {i} id {toks[0]}")
        ids = [int(t.split(":")[0]) for t in toks[1:]]
        served[i, :len(ids)] = ids
    r = _recall(served, true_idx[:len(sq)])
    log(f"serve_cli retrieve --pack --fast-int8: {len(sq)} queries, "
        f"recall@{TOPK} {r:.4f} ({time.perf_counter() - t0:.1f} s with "
        f"checkpoint save/load)")
    check(r >= 0.99, f"serve_cli recall {r}")
    for p in (ipath, cpath):
        os.remove(p)

    for name, (run, floor) in layouts(st).items():
        t0 = time.perf_counter()
        _s, ids = jax.block_until_ready(run(queries))
        r = _recall(ids, true_idx)
        log(f"{name} q={queries.shape[0]}: recall@{TOPK} {r:.4f} "
            f"(floor {floor}, first call {time.perf_counter() - t0:.1f} s)")
        check(r >= floor, f"{name}: recall {r} < {floor}")

    oq = sizes["oracle_q"]
    _d, oidx = exact_nearest(queries[:oq], corpus, "cosine", TOPK,
                             block_rows=64)
    agree = _recall(oidx, true_idx[:oq])
    log(f"exact oracle (HIGHEST) on {oq} queries: agreement with planted "
        f"truth {agree:.4f}")
    check(agree >= 0.999, f"oracle agreement {agree}")


# --------------------------------------------------------------- phase 3
@contextlib.contextmanager
def xla_windowed_dots():
    """Run the windowed dots in the plain XLA form on every platform (the
    comparison phase 3 times); compiled functions are dropped on entry and
    exit so no call keeps the other form."""
    import jax

    from crypto_rec_tpu.ops.pallas import slabscore

    choose = slabscore.window_dots_impl
    slabscore.window_dots_impl = lambda p, f: slabscore._window_dots_xla
    jax.clear_caches()
    try:
        yield
    finally:
        slabscore.window_dots_impl = choose
        jax.clear_caches()


def _dots_inputs(packed, queries, T, per_table, shared, seed):
    """Flat slab, window rows and f32 queries at a layout's real shapes
    (random window starts: the comparison is of arithmetic and addressing)."""
    import jax
    import jax.numpy as jnp

    from crypto_rec_tpu.ops.pallas.slabscore import window_width

    n_pad, d = packed.shape[1], packed.shape[2]
    win = window_width(per_table)
    q = queries.shape[0]
    starts = jax.random.randint(jax.random.PRNGKey(seed), (q, T), 0,
                                n_pad - win + 1)
    aligned = starts // 32 * 32
    off = jnp.zeros((T,), jnp.int32) if shared else jnp.arange(T) * n_pad
    rows0 = (aligned + off).astype(jnp.int32)
    qv = jnp.zeros((q, d), jnp.float32).at[:, :queries.shape[1]].set(queries)
    return packed.reshape(-1, d), rows0, qv, win


def phase_kernel_vs_xla(st):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from crypto_rec_tpu.ops.pallas import slabscore

    queries = st["queries"]
    qn = queries / jnp.linalg.norm(queries, axis=1, keepdims=True)
    cases = {
        # layout: (slabs, queries, windows per query, per_table, shared)
        "plain (cosine int8 L=8)": (st["pidx"].packed, qn, st["L"],
                                    st["pt"], False),
        "augmented (euclidean int8 L=4)": (st["eidx"].packed, queries, 4,
                                           768, False),
        "shared-slab (multicube 2x12)": (st["mc"].packed, qn, 24,
                                         st["pt"], True),
    }
    results = {}
    for i, (name, (packed, qs, T, pt, shared)) in enumerate(cases.items()):
        flat, rows0, qv, win = _dots_inputs(packed, qs, T, pt, shared, i)
        kern = jax.jit(slabscore._window_dots_triton, static_argnames="win")
        xla = jax.jit(slabscore._window_dots_xla, static_argnames="win")
        dk = kern(flat, rows0, qv, win=win)
        dx = xla(flat, rows0, qv, win=win)
        d = flat.shape[1]
        band = 1e-5 * d * float(jnp.max(jnp.abs(qv))) * float(
            jnp.max(jnp.abs(flat.astype(jnp.float32))))
        err = float(jnp.max(jnp.abs(dk - dx)))
        check(err <= band, f"{name}: |dots kernel - xla| {err} > band {band}")
        # top-k over each query's windows: ids equal wherever the scores
        # differ by more than the band
        sk, ik = jax.lax.top_k(dk.reshape(dk.shape[0], -1), TOPK)
        sx, ix = jax.lax.top_k(dx.reshape(dx.shape[0], -1), TOPK)
        bad = jnp.sum((ik != ix) & (jnp.abs(sk - sx) > band))
        check(int(bad) == 0, f"{name}: {int(bad)} top-k ids differ outside "
                             f"the band")
        t_k = timed(lambda: kern(flat, rows0, qv, win=win))
        t_x = timed(lambda: xla(flat, rows0, qv, win=win))
        slab_gb = rows0.size * win * d * flat.dtype.itemsize / 1e9
        log(f"dots {name} q={rows0.shape[0]} T={T} win={win} d={d}: "
            f"max|diff| {err:.3g} <= band {band:.3g}; kernel "
            f"{t_k * 1e3:.3f} ms ({slab_gb / t_k:.0f} GB/s of slab reads), "
            f"xla {t_x * 1e3:.3f} ms ({slab_gb / t_x:.0f} GB/s)")
        results[name] = {"dots_kernel_ms": t_k * 1e3, "dots_xla_ms": t_x * 1e3}
        del dk, dx

    # end to end (windowed dots + selection) through the layouts' own entry
    # points: the kernel as shipped, then the XLA form
    e2e = {"plain (cosine int8 L=8)": "retrieve_topk_pallas",
           "augmented (euclidean int8 L=4)": "euclidean_augmented",
           "shared-slab (multicube 2x12)": "multicube"}
    runs = layouts(st)
    outs = {}
    for form in ("kernel", "xla"):
        ctx = (contextlib.nullcontext() if form == "kernel"
               else xla_windowed_dots())
        with ctx:
            for name, lay in e2e.items():
                run = runs[lay][0]
                t = timed(lambda: run(queries))
                s, ids = jax.block_until_ready(run(queries))
                outs[(form, name)] = (np.asarray(s), np.asarray(ids))
                results[name][f"e2e_{form}_ms"] = t * 1e3
    for name in e2e:
        (sk, ik), (sx, ix) = outs[("kernel", name)], outs[("xla", name)]
        rk, rx = (_recall(jnp.asarray(i), st["true_idx"]) for i in (ik, ix))
        agree = float(np.mean(ik == ix))
        check(abs(rk - rx) <= 1e-3, f"{name}: recall kernel {rk} vs xla {rx}")
        r = results[name]
        log(f"end to end {name} q={queries.shape[0]}: kernel "
            f"{r['e2e_kernel_ms']:.3f} ms, xla {r['e2e_xla_ms']:.3f} ms; "
            f"recall {rk:.4f} / {rx:.4f}, id agreement {agree:.5f}")
    return results


# ---------------------------------------------------------- --multi path
def _in_use(dev):
    return dev.memory_stats()["bytes_in_use"]


def phase_multi(devs, sizes):
    import jax
    import jax.numpy as jnp

    from crypto_rec_tpu.io.synth import planted_clustered_corpus
    from crypto_rec_tpu.models.lsh.index import (
        build_index, pack_index, retrieve_topk,
    )
    from crypto_rec_tpu.parallel.mesh import make_mesh
    from crypto_rec_tpu.parallel.routing import routed_retrieve_topk
    from crypto_rec_tpu.parallel.sharded_index import (
        build_sharded_index, pack_sharded_index, shard_corpus,
        sharded_recommend_scored, sharded_retrieve_topk,
    )

    S = len(devs)
    n, d, q = sizes["multi_n"], sizes["d"], sizes["multi_q"]
    L, pt = 8, 488
    # same average bucket (~244 rows) per shard and on the single card
    k_shard = max(8, round(math.log2(n // S / 244)))
    k_one = max(8, round(math.log2(n / 244)))
    mesh = make_mesh((1, S), devices=devs)
    corpus, queries, true_idx = planted_clustered_corpus(
        jax.random.PRNGKey(0), n, d, q, TOPK)
    corpus_sh = shard_corpus(mesh, corpus)
    t0 = time.perf_counter()
    sidx = build_sharded_index(mesh, jax.random.PRNGKey(1), corpus_sh,
                               "cosine", k_shard, L)
    jax.block_until_ready(sidx)
    before = [_in_use(dv) for dv in devs]
    sidx = pack_sharded_index(mesh, sidx, corpus_sh, dtype=jnp.int8)
    jax.block_until_ready(sidx)
    after = [_in_use(dv) for dv in devs]
    log(f"sharded: {n} x {d} over a (1, {S}) mesh, {n // S} rows/card, "
        f"k={k_shard} L={L} window={pt}, built+packed in "
        f"{time.perf_counter() - t0:.1f} s")

    # placement: each card holds a quarter of the slab bytes
    total = sidx.packed.nbytes
    per_dev = {s.device.id: s.data.nbytes for s in sidx.packed.addressable_shards}
    check(sorted(per_dev) == sorted(dv.id for dv in devs),
          f"slab shards on devices {sorted(per_dev)}")
    for dev_id, b in per_dev.items():
        check(abs(b / total - 1 / S) < 0.01,
              f"device {dev_id} holds {b / total:.3f} of the slabs")
    # the pack's growth of bytes_in_use on each card is its slab share
    # (plus a few small per-shard planes), not everything on device 0
    slab_share = total / S
    grew = [a - b for a, b in zip(after, before)]
    for dv, g in zip(devs, grew):
        check(0.9 * slab_share <= g <= 1.5 * slab_share,
              f"device {dv.id}: pack grew bytes_in_use by {g}, slab share "
              f"{slab_share:.0f}")
    log(f"placement: slab bytes per card {[per_dev[dv.id] for dv in devs]} "
        f"of {total}; bytes_in_use grew by {grew} on packing "
        f"(now {after})")

    qs = queries
    run_sh = lambda: sharded_retrieve_topk(
        mesh, sidx, qs, corpus_sh, budget=1024, top_k=TOPK, per_table=pt,
        int8_rerank=False)
    _s, sids = jax.block_until_ready(run_sh())
    r_sh = _recall(sids, true_idx)
    t_sh = timed(run_sh)
    log(f"sharded_retrieve_topk q={q}: recall@{TOPK} {r_sh:.4f}, "
        f"{t_sh * 1e3:.3f} ms")
    check(r_sh >= 0.99, f"sharded recall {r_sh}")

    # CF over the sharded scored engine
    n_known = jax.random.bernoulli(jax.random.PRNGKey(11), 0.6, (n, d))
    n_mean = jnp.sum(corpus * n_known, 1) / jnp.maximum(
        jnp.sum(n_known, 1), 1)
    q_known = jax.random.bernoulli(jax.random.PRNGKey(12), 0.6, (q, d))
    q_mean = jnp.sum(qs * q_known, 1) / jnp.maximum(jnp.sum(q_known, 1), 1)
    from jax.sharding import NamedSharding, PartitionSpec as P

    nm_sh = jax.device_put(n_mean, NamedSharding(mesh, P("mp")))
    del n_known
    pred, _top, has, _sims, gids, _stats = jax.block_until_ready(
        sharded_recommend_scored(mesh, sidx, qs, q_known, q_mean, corpus_sh,
                                 nm_sh, top_p=20, top_n=5, per_table=pt))
    r_cf = _recall(gids[:, :TOPK], true_idx)
    log(f"sharded_recommend_scored q={q}: neighbour recall@{TOPK} "
        f"{r_cf:.4f}, finite predictions {bool(jnp.isfinite(pred).all())}")
    check(r_cf >= 0.99, f"sharded CF neighbour recall {r_cf}")
    check(bool(jnp.isfinite(pred).all()) and bool(has.all()), "sharded CF")
    del sidx

    # the single-card comparison on the same corpus
    idx = build_index(jax.random.PRNGKey(1), corpus, "cosine", k_one, L,
                      lsh_bucket_div=4, euclidean_h_w=1.0)
    pidx = pack_index(idx, corpus, dtype=jnp.int8)
    del idx
    _s, lids = jax.block_until_ready(retrieve_topk(
        pidx, qs, corpus, top_k=TOPK, per_table=pt, q_block=4096,
        int8_rerank=False, approx_stage1=True))
    r_one = _recall(lids, true_idx)
    log(f"single card retrieve_topk on the same {n} rows (k={k_one}, "
        f"{pidx.packed.nbytes / 1e9:.2f} GB of slabs): recall@{TOPK} "
        f"{r_one:.4f}; sharded - single = {r_sh - r_one:+.4f}")
    check(abs(r_sh - r_one) <= 0.005, f"sharded {r_sh} vs single {r_one}")
    del pidx

    # routed serving: queries travel to the shards owning their buckets
    rn, rq = sizes["route_n"], sizes["route_q"]
    rc, rqs, _rt = planted_clustered_corpus(jax.random.PRNGKey(5), rn, d, rq,
                                            TOPK)
    ridx = build_index(jax.random.PRNGKey(6), rc, "cosine",
                       max(8, round(math.log2(rn / 244))), 4,
                       lsh_bucket_div=4, euclidean_h_w=1.0)
    rs, rids, rstats = routed_retrieve_topk(mesh, ridx, rqs, rc, top_k=TOPK)
    rids = jax.device_get(rids)
    ok = ((rids >= -1) & (rids < rn)).all()
    import numpy as np

    dup = any(len(set(r[r >= 0].tolist())) != int((r >= 0).sum())
              for r in rids)
    check(bool(ok) and not dup and rids.shape == (rq, TOPK),
          "routed ids malformed")
    log(f"routed_retrieve_topk q={rq} over {rn} rows: ids well-formed, "
        f"{float(np.mean(rids[:, 0] >= 0)):.4f} of queries answered")


# ------------------------------------------------------------------ main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card path")
    ap.add_argument("--phases", default="0,1,2,3",
                    help="comma-separated one-card phases to run")
    args = ap.parse_args(argv)

    # the CPU backend is phase 1's plain reference: keep it available
    # when the environment names the platforms
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"

    from crypto_rec_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    count = 4 if args.multi else 1
    devs = phase_device(count)
    work = os.path.join(REPO, ".smoke_work")
    os.makedirs(work, exist_ok=True)
    t_all = time.perf_counter()
    try:
        if args.multi:
            phase_multi(devs, SIZES)
        else:
            phases = {int(p) for p in args.phases.split(",")}
            if 1 in phases:
                phase_pipeline(work, SIZES)
            if phases & {2, 3}:
                st = build_state(SIZES)
                if 2 in phases:
                    phase_serving(work, st, SIZES)
                if 3 in phases:
                    phase_kernel_vs_xla(st)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_all:.1f} s")
    d0 = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
