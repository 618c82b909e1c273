"""Test harness: the tests run on the CPU, with 8 virtual devices.

Run them with `JAX_PLATFORMS=cpu python -m pytest tests/` (the tier-1
command in ROADMAP.md).  Multi-device sharding paths are validated on the
8-device CPU mesh (SURVEY.md §4: CPU-simulated multi-device tests precede
real multi-host runs); the GPU path is proven by `python chip_smoke.py` on
the card.  The CPU platform is pinned here, before any backend starts, so
a machine with a GPU still runs the tests on the CPU.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

from crypto_rec_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

jax.config.update("jax_platforms", "cpu")
enable_compile_cache()

assert jax.devices()[0].platform == "cpu", "tests must run on CPU devices"
assert len(jax.devices()) == 8, "expected 8 simulated CPU devices"
