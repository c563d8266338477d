"""Test configuration: CPU backend with 8 virtual devices (the "fake
backend" for multi-device sharding tests) and float64 enabled for numeric
parity against the reference's f64 pipeline (SURVEY.md §4).

The jax config is flipped as well as the environment, in case jax was
imported before this file ran (the environment is read at import).  The
checks that need a GPU live in chip_smoke.py (`python chip_smoke.py` on a
machine with one)."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = \
        flags + " --xla_force_host_platform_device_count=8"
os.environ["JAX_ENABLE_X64"] = "True"

import jax  # noqa: E402  (import after env setup)

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
