"""Test configuration: force an 8-device virtual CPU mesh.

Tests never require an accelerator; sharding tests use
xla_force_host_platform_device_count to emulate a multi-device mesh.
The platform is pinned to the CPU through jax.config as well as the
environment, before any backend starts.  Tests that need a GPU carry the
`gpu` marker and decide in a fixture whether one is present.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax

jax.config.update("jax_platforms", "cpu")
