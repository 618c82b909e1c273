"""Device-mesh construction + multi-host init.

The reference is single-threaded C++ with no distribution (SURVEY.md §2);
this layer is new, mandated by BASELINE.json ("row/column-sharded embedding
tables ... all-to-all lookup exchange ... pod-scale").  The comm backend is
XLA collectives (NCCL over NVLink between the cards of a host) — reached
through `jax.sharding.Mesh` + shard_map; there is no hand-written transport.

Axis conventions:
  "dp" — query/batch data parallelism (rows of the query matrix);
  "mp" — index/model parallelism (rows of the indexed corpus + their
         bucket tables; the analog of row-sharding an embedding table).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(
    shape: Optional[Tuple[int, int]] = None,
    axis_names: Sequence[str] = ("dp", "mp"),
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a 2-D (dp, mp) mesh over the available devices.

    Default: all devices on the "mp" axis (index sharding dominates the
    memory footprint).  Pass shape=(dp, mp) to split both ways.
    """
    devs = list(devices if devices is not None else jax.devices())
    n = len(devs)
    if shape is None:
        shape = (1, n)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != device count {n}")
    return Mesh(np.asarray(devs).reshape(shape), tuple(axis_names))


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    retries: int = 3,
    retry_delay_s: float = 5.0,
) -> None:
    """Multi-host init wrapper (jax.distributed) for N>=2 host configs
    (BASELINE.json config 5).  No-op on a single host.

    Retries transient coordinator failures — the failure-detection scope
    committed to in SURVEY.md §5 ("multi-host init retries only" for v0).
    """
    if num_processes is None or num_processes <= 1:
        return
    import time

    last_err = None
    for attempt in range(retries):
        try:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
            )
            return
        except Exception as e:  # pragma: no cover - needs real multi-host
            last_err = e
            if attempt + 1 < retries:
                time.sleep(retry_delay_s * (attempt + 1))
    raise RuntimeError(
        f"jax.distributed.initialize failed after {retries} attempts"
    ) from last_err
