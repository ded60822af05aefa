"""Test config: the tier-1 run uses the CPU backend with 8 virtual
devices, so the sharding tests exercise a real multi-device mesh on any
machine.  When JAX_PLATFORMS names another platform (e.g. ``cuda``) the
platform is left alone, so the ``gpu``-marked tests run on the card.
"""

import os

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")
