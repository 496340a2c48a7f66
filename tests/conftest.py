"""Test env: force JAX onto plain CPU and enable the compile cache.

Multi-device sharding tests spawn a subprocess with
--xla_force_host_platform_device_count instead of setting it here (it slows
every other compile)."""

import jax

from mpctsid_tpu.utils import configure_compile_cache

jax.config.update("jax_platforms", "cpu")
configure_compile_cache()
