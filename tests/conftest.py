"""Test configuration.

Runs the suite on the backend ``JAX_PLATFORMS`` names — the CPU with 8
virtual devices unless set (SURVEY.md §4.2 item 4 — the rebuild's
`mpirun -np N`-without-a-cluster mechanism) — and with x64 enabled so
correctness tests can use float64 oracles. Library code is
dtype-explicit, so enabling x64 here does not change what the framework
computes on the GPU. Tests marked ``chip`` need the GPU: run them with
``JAX_PLATFORMS=cuda python -m pytest -m chip tests/``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# Pin the selected backend in config as well as the environment, so a
# plugin that registers itself cannot move the suite off it.
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)
