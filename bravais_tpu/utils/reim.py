"""Real/imaginary boundary helpers.

Every public jitted entry point takes/returns real arrays, packing a
complex array ``z`` as a stacked real array ``[Re z, Im z]`` along a new
LEADING axis of size 2. The rule dates from a platform that could not
move complex arrays across the host<->device boundary; it stays as
behaviour until the GPU path is measured without it (ROADMAP §3.2).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

__all__ = ["to_reim", "from_reim", "to_reim_np", "from_reim_np"]


def to_reim(z):
    """Complex (..., ) -> real (2, ...). Use at the END of a jit."""
    return jnp.stack([jnp.real(z), jnp.imag(z)])


def from_reim(x):
    """Real (2, ...) -> complex (...). Use at the START of a jit."""
    return x[0] + 1j * x[1]


def to_reim_np(z: np.ndarray) -> np.ndarray:
    return np.stack([np.real(z), np.imag(z)]).astype(
        np.finfo(np.asarray(z).dtype).dtype)


def from_reim_np(x: np.ndarray) -> np.ndarray:
    return np.asarray(x)[0] + 1j * np.asarray(x)[1]
