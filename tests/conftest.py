"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-chip sharding is validated on virtual CPU devices
(xla_force_host_platform_device_count); real-TPU execution is exercised by
bench.py / __graft_entry__.py instead. x64 is enabled so numerical kernels
can be validated at tight tolerances; f32-path tests cast explicitly.

Note: the environment may pre-register an accelerator platform plugin that
overrides JAX_PLATFORMS at import time, so the platform must be forced via
jax.config *after* import — env vars alone are not sufficient. A persistent
compilation cache keeps repeat test runs fast on this host.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_compilation_cache_dir",
                  os.path.join(os.path.dirname(__file__), "..", ".jax_cache"))
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)

assert jax.default_backend() == "cpu", jax.default_backend()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one (run "
        "tests/test_torch_kinv_card.py on the card with --noconftest)")
