"""Test configuration: CPU backend with 8 virtual devices + float64.

Tests validate numeric parity with the float64 reference formulas, so they
run on the CPU backend with x64 enabled; sharding tests use the 8 virtual
host devices (SURVEY §4: multi-device testing via host-platform override).
Must run before jax initializes its backends. A machine with an
accelerator still tests on the CPU unless JAX_PLATFORMS names the
accelerator: ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu`` runs the
on-card tests (marker ``gpu``), which skip where no GPU is visible.
"""

import os

PLATFORMS = os.environ.get("JAX_PLATFORMS") or "cpu"
os.environ["JAX_PLATFORMS"] = PLATFORMS
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", PLATFORMS)
jax.config.update("jax_enable_x64", True)

# Compile cache: JAX_COMPILATION_CACHE_DIR when set (JAX reads it
# itself), else the package's fixed in-checkout default.
import bayesian_bm25_tpu  # noqa: E402,F401  (places the cache)
