"""Process set-up shared by the entry points: the persistent compile
cache, a description of the device, and the peak rate a measured FLOP/s
is divided by."""

from __future__ import annotations

import os
import pathlib
import subprocess

# Dense peak FLOP/s the package's contractions can reach, by JAX
# ``device_kind``. The package sets matmul precision "highest"
# (bravais_tpu/__init__.py), so f32 products run as plain f32 outside
# the tensor cores: NVIDIA H100 data sheet, 67 TFLOP/s f32 (SXM5) and
# 51 TFLOP/s (PCIe), both at the full power limit.
PEAK_F32_TFLOPS = {
    "NVIDIA H100 80GB HBM3": 67.0,
    "NVIDIA H100 PCIe": 51.0,
}

CHECKOUT = pathlib.Path(__file__).resolve().parents[2]


def setup_compile_cache() -> str:
    """Point JAX's persistent compile cache at one fixed directory.

    ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself and this sets
    nothing. Unset: ``<checkout>/.jax_cache``, derived from this file so
    every entry point and working directory shares it. Returns the
    directory in use."""
    import jax
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 5.0)
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(CHECKOUT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def peak_f32_tflops(device_kind: str):
    """(peak TFLOP/s or None, note). An unknown kind gets no peak."""
    peak = PEAK_F32_TFLOPS.get(device_kind)
    if peak is None:
        return None, f"no peak on record for device_kind {device_kind!r}"
    return peak, f"f32 peak of {device_kind} (NVIDIA data sheet)"


def nvidia_smi() -> str | None:
    """Each card's name and power limit as nvidia-smi reports them
    (cards joined by "; "), or None where there is no nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    cards = out.stdout.split("\n") if out.returncode == 0 else []
    return "; ".join(c.strip() for c in cards if c.strip()) or None


def device_info() -> dict:
    """Platform, device kind and count as JAX reports them, plus the
    nvidia-smi name and power limit."""
    import jax
    d = jax.devices()[0]
    return {"platform": d.platform, "device_kind": d.device_kind,
            "device_count": len(jax.devices()),
            "nvidia_smi": nvidia_smi()}
