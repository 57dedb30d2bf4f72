"""Jacobi eigensolver tests — incl. the graded-spectrum case that breaks
QDWH-style f32 eigh (the reason this solver exists)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg

from bravais_tpu.eigen.jacobi_eigh import jacobi_eigh


def _rand_herm(n, seed, dtype=np.complex128, spectrum=None):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    Q = np.linalg.qr(A)[0]
    if spectrum is None:
        spectrum = rng.standard_normal(n) * 10
    H = (Q * spectrum) @ Q.conj().T
    return (0.5 * (H + H.conj().T)).astype(dtype)


@pytest.mark.parametrize("n", [4, 5, 16, 33, 48])
def test_matches_scipy_f64(n):
    H = _rand_herm(n, n)
    w, V = jacobi_eigh(jnp.asarray(H))
    wref, Vref = scipy.linalg.eigh(H)
    np.testing.assert_allclose(np.asarray(w), wref, rtol=1e-12, atol=1e-11)
    V = np.asarray(V)
    # Eigen equation + orthonormality.
    np.testing.assert_allclose(H @ V, V * np.asarray(w)[None, :],
                               atol=1e-10)
    np.testing.assert_allclose(V.conj().T @ V, np.eye(n), atol=1e-12)


def test_graded_matrix_f32_low_accuracy():
    """GRADED matrix (small entries where eigenvalues are small — the
    Rayleigh–Ritz shape: X-block entries ~λ_low, W-block ~λ_max): low
    eigenvalues must keep near-relative accuracy in f32. This is the
    Demmel–Veselić property Jacobi has and f32 QDWH lacks."""
    n = 45
    rng = np.random.default_rng(3)
    A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    A = np.eye(n) + 0.3 * (A + A.conj().T) / np.sqrt(n)  # well-conditioned
    d = np.sqrt(np.concatenate([np.linspace(1, 1.01, 10),
                                np.geomspace(10.0, 1e6, n - 10)]))
    H = (d[:, None] * A * d[None, :])
    H = 0.5 * (H + H.conj().T)
    H32 = H.astype(np.complex64)
    wref = scipy.linalg.eigh(H)[0]
    w, V = jacobi_eigh(jnp.asarray(H32), sweeps=12)
    rel = np.abs(np.asarray(w)[:10] - wref[:10]) / np.abs(wref[:10])
    assert rel.max() < 2e-5, rel.max()


def test_batched_vmap():
    Hs = np.stack([_rand_herm(24, 10 + i) for i in range(5)])
    w, V = jax.vmap(jacobi_eigh)(jnp.asarray(Hs))
    for i in range(5):
        wref = scipy.linalg.eigh(Hs[i], eigvals_only=True)
        np.testing.assert_allclose(np.asarray(w[i]), wref, rtol=1e-11,
                                   atol=1e-10)


def test_psd_gram_like():
    """PSD Gram-like matrix with near-null directions (whitening use)."""
    rng = np.random.default_rng(7)
    S = rng.standard_normal((30, 200)) + 1j * rng.standard_normal((30, 200))
    S[5] = S[4] + 1e-7 * S[6]  # nearly dependent row
    G = S.conj() @ S.T
    G = 0.5 * (G + G.conj().T)
    w, V = jacobi_eigh(jnp.asarray(G))
    wref = scipy.linalg.eigh(G, eigvals_only=True)
    np.testing.assert_allclose(np.asarray(w), wref,
                               rtol=1e-9, atol=1e-9 * wref.max())
    assert np.asarray(w).min() > -1e-10 * wref.max()

