"""Test harness: an 8-virtual-device CPU platform and float64.

The platform is the CPU unless JAX_PLATFORMS says otherwise, so the
`gpu`-marked tests run on a card with `JAX_PLATFORMS=cuda`.

Multi-device sharding is validated on a host-emulated mesh
(xla_force_host_platform_device_count); correctness tests run in double
precision to match the reference's tolerance (reference:
src/Engine/LanczosDriver.h:29-33, RealType = double).  The persistent
compilation cache stays off, so the command-line entry points the
tests drive write no cache into the checkout.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
jax.config.update("jax_enable_compilation_cache", False)
