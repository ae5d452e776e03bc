"""Test configuration: the CPU backend with 8 virtual devices.

Must run before any JAX backend initialization. The suite runs on the host
CPU (the sharding tests use an 8-device virtual CPU mesh); what needs a GPU
is exercised by ``chip_smoke.py`` on the card.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from pplp_tpu.utils.chipstate import enable_compile_cache  # noqa: E402

# Persistent compile cache: repeated suite runs skip recompiles.
enable_compile_cache()
