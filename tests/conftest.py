"""Test harness config: run on CPU with 8 virtual devices.

Multi-device tests run without a cluster via JAX's simulated-device backend
(SURVEY.md section 4: "the natural fake backend"). The platform is forced
through jax.config as well as the environment, in case jax was imported
before this file ran; the backend is not instantiated until the asserts.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

assert jax.default_backend() == "cpu"
assert len(jax.devices()) == 8, jax.devices()
