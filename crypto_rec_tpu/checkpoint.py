"""Index + user-matrix checkpointing.

The reference rebuilds all state every run (SURVEY.md §5: no checkpointing).
At 10^8..10^9-row scale (BASELINE.json configs 4-5) rebuilding the hash
tables per run is not acceptable, so the index (hash-family params + bucket
tables + CSR layout) and the user matrix round-trip through an npz archive.
Sharded arrays are gathered host-side on save and re-placed on load with the
caller's sharding; per-shard streaming saves are a later optimization.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import ml_dtypes

import jax
import jax.numpy as jnp

from crypto_rec_tpu.io.users import UserMatrix
from crypto_rec_tpu.models.lsh.hyperplane import CosineLsh
from crypto_rec_tpu.models.lsh.pstable import PStableLsh
from crypto_rec_tpu.models.lsh.index import LshIndex

# v3: euclidean `detailed` changed from [n, L, k] h-tuples to [L, n] int32
# fingerprints (models/lsh/index.LshIndex.detailed) — euclidean archives
# written by v1/v2 must be rebuilt.
_FORMAT_VERSION = 3

# Packed-slab fields round-trip too (v2): bf16 has no native numpy save
# format, so it is stored as a uint16 bit view with the dtype recorded in
# the meta blob.
_PACKED_FIELDS = (
    "packed", "packed_rows", "packed_sqnorm", "packed_detailed",
    "packed_scale", "packed_gscale", "packed_aug_scale",
)


def _encode(arr) -> tuple:
    a = np.asarray(arr)
    if a.dtype == ml_dtypes.bfloat16:
        return a.view(np.uint16), "bfloat16"
    return a, a.dtype.name


def _decode(a: np.ndarray, dtype_name: str) -> jax.Array:
    if dtype_name == "bfloat16":
        a = a.view(ml_dtypes.bfloat16)
    return jnp.asarray(a)


def _family_meta_arrays(index) -> tuple:
    fam = index.family
    meta = {"k": fam.k, "L": fam.L}
    arrays = {"proj": np.asarray(fam.proj)}
    if index.metric != "cosine":
        meta["w"] = fam.w
        arrays["offsets"] = np.asarray(fam.offsets)
        arrays["weights"] = np.asarray(fam.weights)
    return meta, arrays


def _family_from(meta: dict, z) -> object:
    if meta["metric"] == "cosine":
        return CosineLsh(proj=jnp.asarray(z["proj"]), k=meta["k"], L=meta["L"])
    return PStableLsh(
        proj=jnp.asarray(z["proj"]),
        offsets=jnp.asarray(z["offsets"]),
        weights=jnp.asarray(z["weights"]),
        w=meta["w"], k=meta["k"], L=meta["L"],
    )


def save_index(path: str, index: LshIndex) -> None:
    meta = {
        "version": _FORMAT_VERSION,
        "metric": index.metric,
        "n_buckets": index.n_buckets,
        "n_rows": index.n_rows,
        "packed_dtypes": {},
    }
    arrays = {
        "bucket_ids": np.asarray(index.bucket_ids),
        "sorted_rows": np.asarray(index.sorted_rows),
        "bucket_starts": np.asarray(index.bucket_starts),
    }
    fam_meta, fam_arrays = _family_meta_arrays(index)
    meta.update(fam_meta)
    arrays.update(fam_arrays)
    if index.metric != "cosine":
        arrays["detailed"] = np.asarray(index.detailed)
    for f in _PACKED_FIELDS:
        arr = getattr(index, f)
        if arr is not None:
            arrays[f], meta["packed_dtypes"][f] = _encode(arr)
    # uncompressed: packed int8/bf16 slabs barely compress, and zlib over
    # gigabytes of slab costs minutes on save and load
    np.savez(path, meta=json.dumps(meta), **arrays)


def load_index(path: str) -> LshIndex:
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta["version"] not in (1, 2, _FORMAT_VERSION):
            raise ValueError(f"unsupported index version {meta['version']}")
        if meta["metric"] != "cosine" and meta["version"] < 3:
            raise ValueError(
                "euclidean index archives before v3 store raw h-tuples; "
                "rebuild and re-save the index (detailed hashes are now "
                "[L, n] fingerprints)"
            )
        fam = _family_from(meta, z)
        detailed = (
            jnp.asarray(z["detailed"]) if meta["metric"] != "cosine" else None
        )
        packed_kw = {}
        for f, dtype_name in meta.get("packed_dtypes", {}).items():
            packed_kw[f] = _decode(z[f], dtype_name)
        return LshIndex(
            metric=meta["metric"],
            n_buckets=meta["n_buckets"],
            n_rows=meta["n_rows"],
            family=fam,
            bucket_ids=jnp.asarray(z["bucket_ids"]),
            detailed=detailed,
            sorted_rows=jnp.asarray(z["sorted_rows"]),
            bucket_starts=jnp.asarray(z["bucket_starts"]),
            **packed_kw,
        )


def save_sharded_index(prefix: str, index) -> list:
    """Per-shard streaming save of a ShardedLshIndex: one npz per mp shard
    ({prefix}.shard000.npz ...) plus {prefix}.meta.npz with the replicated
    hash-family params.  Each shard file is written from that shard's slice
    only — at 1B-row scale (BASELINE configs 4-5) no host ever needs the
    whole index in memory (SURVEY.md §5 checkpoint row).

    Returns the list of written paths."""
    meta = {
        "version": _FORMAT_VERSION,
        "kind": "sharded",
        "metric": index.metric,
        "n_buckets": index.n_buckets,
        "n_local": index.n_local,
        "n_shards": index.n_shards,
        "packed_dtypes": {},
        "has_detailed": index.detailed is not None,
    }
    fam_meta, fam_arrays = _family_meta_arrays(index)
    meta.update(fam_meta)
    fields = {"sorted_rows": index.sorted_rows,
              "bucket_starts": index.bucket_starts}
    if index.detailed is not None:
        fields["detailed"] = index.detailed
    for f in _PACKED_FIELDS:
        arr = getattr(index, f)
        if arr is not None:
            fields[f] = arr
            meta["packed_dtypes"][f] = (
                "bfloat16" if arr.dtype == jnp.bfloat16 else
                np.dtype(arr.dtype).name
            )
    paths = [f"{prefix}.meta.npz"]
    np.savez_compressed(paths[0], meta=json.dumps(meta), **fam_arrays)
    for s in range(index.n_shards):
        arrays = {}
        for name, arr in fields.items():
            # index only the one shard: with a sharded on-device array this
            # pulls a single shard's bytes to host, not the global array
            a, _ = _encode(jax.device_get(arr[s]))
            arrays[name] = a
        p = f"{prefix}.shard{s:03d}.npz"
        np.savez_compressed(p, **arrays)
        paths.append(p)
    return paths


def load_sharded_index(prefix: str, mesh):
    """Restore a ShardedLshIndex onto `mesh`'s "mp" axis, placing each
    shard's arrays directly on its device (no host-side global assembly)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from crypto_rec_tpu.parallel.sharded_index import ShardedLshIndex

    with np.load(f"{prefix}.meta.npz", allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta["version"] != _FORMAT_VERSION or meta.get("kind") != "sharded":
            raise ValueError("not a sharded index checkpoint")
        fam = _family_from(meta, z)
    S = meta["n_shards"]
    if mesh.shape["mp"] != S:
        raise ValueError(
            f"checkpoint has {S} shards but mesh mp axis is {mesh.shape['mp']}"
        )
    dtypes = meta["packed_dtypes"]
    shard_files = [
        np.load(f"{prefix}.shard{s:03d}.npz", allow_pickle=False)
        for s in range(S)
    ]
    try:
        field_names = list(shard_files[0].keys())
        fields = {}
        for name in field_names:
            dtype_name = dtypes.get(name)
            blocks = []
            for s, zf in enumerate(shard_files):
                a = zf[name]
                if dtype_name == "bfloat16":
                    a = a.view(ml_dtypes.bfloat16)
                blocks.append(a[None])
            global_shape = (S,) + blocks[0].shape[1:]
            sharding = NamedSharding(
                mesh, P("mp", *([None] * (len(global_shape) - 1)))
            )
            # map each device to ITS shard via the index slice (the dict's
            # iteration order is not shard order; dp>1 replicates shards)
            dev_map = sharding.addressable_devices_indices_map(global_shape)
            dbs = [
                jax.device_put(blocks[idx[0].start or 0], dev)
                for dev, idx in dev_map.items()
            ]
            fields[name] = jax.make_array_from_single_device_arrays(
                global_shape, sharding, dbs
            )
    finally:
        for zf in shard_files:
            zf.close()
    return ShardedLshIndex(
        metric=meta["metric"],
        n_buckets=meta["n_buckets"],
        n_local=meta["n_local"],
        n_shards=S,
        family=fam,
        sorted_rows=fields["sorted_rows"],
        bucket_starts=fields["bucket_starts"],
        detailed=fields.get("detailed"),
        packed=fields.get("packed"),
        packed_rows=fields.get("packed_rows"),
        packed_sqnorm=fields.get("packed_sqnorm"),
        packed_detailed=fields.get("packed_detailed"),
        packed_scale=fields.get("packed_scale"),
        packed_gscale=fields.get("packed_gscale"),
        packed_aug_scale=fields.get("packed_aug_scale"),
    )


def save_user_matrix(path: str, um: UserMatrix) -> None:
    np.savez_compressed(
        path,
        ratings=um.ratings,
        known=um.known,
        mean=um.mean,
        ids=np.asarray(um.ids, dtype=object).astype(str),
    )


def load_user_matrix(path: str) -> UserMatrix:
    with np.load(path, allow_pickle=False) as z:
        return UserMatrix(
            ratings=z["ratings"],
            known=z["known"],
            mean=z["mean"],
            ids=[str(s) for s in z["ids"]],
        )


def index_nbytes(index: LshIndex) -> int:
    """Device-memory accounting for the index — the device analog of the
    reference's hand-rolled getSize() byte counters
    (/root/reference/lib/data_structures/cust_hashtable.hpp:128-138)."""
    total = 0
    for arr in (
        index.bucket_ids, index.sorted_rows, index.bucket_starts, index.detailed,
        index.packed, index.packed_rows, index.packed_sqnorm,
        index.packed_detailed, index.packed_scale,
    ):
        if arr is not None:
            total += arr.size * arr.dtype.itemsize
    fam = index.family
    total += fam.proj.size * fam.proj.dtype.itemsize
    if isinstance(fam, PStableLsh):
        total += fam.offsets.size * 4 + fam.weights.size * 4
    return int(total)
