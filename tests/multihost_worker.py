"""Worker process for the 2-process jax.distributed test (run by
tests/test_multihost.py, not collected by pytest).

Each OS process simulates one HOST of BASELINE.json config 5 (N>=2 hosts):
4 virtual CPU devices per process, one 8-device (dp=2, mp=4) mesh spanning
both processes, XLA collectives crossing the process boundary the way they
would cross DCN on real pods.  The reference is single-process
(/root/reference/main.cpp:36); this path is the build's own scale axis.

argv: <coordinator_address> <num_processes> <process_id> <out_npz>
"""

import os
import sys

# Must happen before jax import / first op: the workers run on the CPU
# with 4 virtual devices each, whatever accelerator the machine has.
_flags = [
    f for f in os.environ.get("XLA_FLAGS", "").split()
    if "xla_force_host_platform_device_count" not in f
]
os.environ["XLA_FLAGS"] = " ".join(
    _flags + ["--xla_force_host_platform_device_count=4"]
)
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", "/root/.cache/jax-test")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def main() -> None:
    coord, n_proc, pid, out_path = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    )
    from crypto_rec_tpu.parallel.mesh import initialize_multihost, make_mesh

    initialize_multihost(
        coordinator_address=coord, num_processes=n_proc, process_id=pid,
        retries=2, retry_delay_s=1.0,
    )
    assert jax.process_count() == n_proc, jax.process_count()
    assert len(jax.devices()) == 4 * n_proc, jax.devices()
    assert len(jax.local_devices()) == 4

    from jax.sharding import NamedSharding, PartitionSpec as P

    from crypto_rec_tpu.parallel.sharded_index import (
        build_sharded_index,
        sharded_recommend_csr,
        sharded_retrieve_topk,
    )

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from _mh_data import make_data

    corpus_np, queries_np, known_np, mean_np = make_data()
    n, d = corpus_np.shape
    q = queries_np.shape[0]

    mesh = make_mesh((2, 2 * n_proc))  # dp=2, mp spans both processes

    # Global arrays from per-process data: every process holds the full
    # numpy value; make_array_from_callback stores only addressable shards.
    def put(np_arr, spec):
        return jax.make_array_from_callback(
            np_arr.shape, NamedSharding(mesh, spec), lambda idx: np_arr[idx]
        )

    corpus = put(corpus_np, P("mp", None))
    queries = jnp.asarray(queries_np)

    key = jax.random.PRNGKey(9)
    index = build_sharded_index(mesh, key, corpus, "cosine", k=5, L=6)
    vals, ids = sharded_retrieve_topk(
        mesh, index, queries, corpus, budget=128, top_k=10
    )

    # CF over the same mesh (sharded_recommend_csr contract).
    nm = put(mean_np, P("mp"))
    pred, top, has, sims, gids, stats = sharded_recommend_csr(
        mesh, index,
        queries, jnp.asarray(known_np[:q]), jnp.asarray(mean_np[:q]),
        corpus, nm, budget=128, top_p=6, top_n=3,
    )

    # Outputs are replicated (out_specs P(None)): read the local copy.
    def local(a):
        return np.asarray(jax.device_get(a.addressable_data(0)))

    if pid == 0:
        np.savez(
            out_path,
            vals=local(vals), ids=local(ids),
            pred=local(pred), top=local(top), has=local(has),
            sims=local(sims), gids=local(gids),
        )
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
