"""Test configuration: CPU backend, 8 virtual devices, float64.

Validation runs on the CPU backend in float64 so results can be held to the
reference's accuracy contract (residual <= 1e-10); the virtual 8-device mesh
exercises the multi-device sharding path without accelerator hardware.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "--xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
