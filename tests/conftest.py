"""Test configuration: run everything on the CPU with 8 virtual devices,
so the sharding paths are exercised without a GPU.  The receiver runs on
the card through chip_smoke.py.

The platform is set through jax.config after importing jax, so it holds
whatever JAX_PLATFORMS says.  The persistent compilation cache is off:
test processes run in parallel and compile many small programs.
"""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_compilation_cache", False)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

