"""Eigensolver tests (SURVEY.md §4.2 item 2) and the minimum end-to-end
slice (§7.1 step 4 = BASELINE config 1): empty-lattice bands validated
against λ = |k+G|² to 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg

from bravais_tpu.eigen.lobpcg import lobpcg
from bravais_tpu.eigen.precond import chebyshev, estimate_lmax, jacobi
from bravais_tpu.lattices import make_lattice
from bravais_tpu.meshing.grid import PeriodicGrid
from bravais_tpu.operators.helmholtz import BlochHelmholtz
from bravais_tpu.spaces.h1 import H1Space
from tests.oracles.analytic import scalar_bands


def _rand_hermitian(n, seed, dtype=np.complex128, spd_shift=0.0):
    rng = np.random.default_rng(seed)
    H = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    H = 0.5 * (H + H.conj().T)
    return (H + spd_shift * np.eye(n)).astype(dtype)


def _x0(m, shape, seed=0, dtype=jnp.complex128):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.standard_normal((m,) + tuple(shape))
                       + 1j * rng.standard_normal((m,) + tuple(shape)),
                       dtype)


def test_lobpcg_standard_vs_scipy():
    n, nev, m = 120, 6, 10
    H = _rand_hermitian(n, 0)
    exact = scipy.linalg.eigh(H, eigvals_only=True)[:nev]
    A = lambda x: jnp.asarray(H) @ x
    res = lobpcg(A, None, _x0(m, (n,)), nev, maxiter=300, tol=1e-9)
    assert bool(jnp.all(res.converged))
    np.testing.assert_allclose(np.asarray(res.eigenvalues), exact,
                               rtol=1e-8, atol=1e-8)


def test_lobpcg_generalized_vs_scipy():
    n, nev, m = 90, 5, 9
    H = _rand_hermitian(n, 1)
    Mm = _rand_hermitian(n, 2, spd_shift=2.0 * n)
    exact = scipy.linalg.eigh(H, Mm, eigvals_only=True)[:nev]
    A = lambda x: jnp.asarray(H) @ x
    M = lambda x: jnp.asarray(Mm) @ x
    res = lobpcg(A, M, _x0(m, (n,), 3), nev, maxiter=300, tol=1e-9)
    assert bool(jnp.all(res.converged))
    np.testing.assert_allclose(np.asarray(res.eigenvalues), exact,
                               rtol=1e-8, atol=1e-8)
    # Eigenvectors satisfy the pencil equation.
    X = np.asarray(res.eigenvectors)[:nev]
    for j in range(nev):
        lhs = H @ X[j]
        rhs = res.eigenvalues[j] * (Mm @ X[j])
        np.testing.assert_allclose(lhs, rhs, atol=1e-6 * np.abs(lhs).max())


def test_lobpcg_with_jacobi_precond():
    n, nev, m = 200, 4, 8
    # Strongly diagonally dominant -> Jacobi is a good preconditioner.
    H = _rand_hermitian(n, 4) + np.diag(np.linspace(1.0, 1e4, n))
    exact = scipy.linalg.eigh(H, eigvals_only=True)[:nev]
    A = lambda x: jnp.asarray(H) @ x
    res_nopc = lobpcg(A, None, _x0(m, (n,), 5), nev, maxiter=100, tol=1e-9)
    res_pc = lobpcg(A, None, _x0(m, (n,), 5), nev, maxiter=100, tol=1e-9,
                    precond=jacobi(np.real(np.diag(H))))
    np.testing.assert_allclose(np.asarray(res_pc.eigenvalues), exact,
                               rtol=1e-7, atol=1e-7)
    assert bool(jnp.all(res_pc.converged))
    assert int(res_pc.iterations) < int(res_nopc.iterations)


def test_lobpcg_f32_accuracy():
    """complex64 path — the device dtype (precision plan SURVEY.md §7.0)."""
    n, nev, m = 150, 5, 9
    H = _rand_hermitian(n, 6) + np.diag(np.linspace(0, 60, n))
    exact = scipy.linalg.eigh(H, eigvals_only=True)[:nev]
    A = lambda x: jnp.asarray(H, jnp.complex64) @ x
    res = lobpcg(A, None, _x0(m, (n,), 7, jnp.complex64), nev,
                 maxiter=250, tol=5e-6)
    scale = np.abs(exact).max()
    np.testing.assert_allclose(np.asarray(res.eigenvalues), exact,
                               atol=2e-4 * scale)


def test_lobpcg_vmapped():
    """One compiled solve serving a batch of pencils (k-batching model)."""
    n, nev, m, nb = 60, 3, 6, 4
    Hs = np.stack([_rand_hermitian(n, 10 + i) for i in range(nb)])

    def solve(H):
        A = lambda x: H @ x
        r = lobpcg(A, None, _x0(m, (n,), 11), nev, maxiter=200, tol=1e-8)
        return r.eigenvalues, r.iterations

    vals, its = jax.vmap(solve)(jnp.asarray(Hs))
    for i in range(nb):
        exact = scipy.linalg.eigh(Hs[i], eigvals_only=True)[:nev]
        np.testing.assert_allclose(np.asarray(vals[i]), exact, rtol=1e-6,
                                   atol=1e-6)


# -- the minimum end-to-end slice (SURVEY.md §7.1 step 4) -------------------

@pytest.mark.parametrize("kfrac", [(0.0, 0.0), (0.31, 0.17)])
def test_e2e_empty_lattice_square(kfrac):
    """BASELINE config 1: 2D square lattice, H1, empty-lattice bands,
    eigenvalues vs λ = |k+G|² to 1e-6 relative (f64 CPU here; the f32
    twin is exercised by bench/__graft_entry__)."""
    lat = make_lattice("SQR")
    sp = H1Space.make(PeriodicGrid.make(lat, 12), p=3)
    op = BlochHelmholtz(sp, dtype=jnp.complex128)
    nev, m = 4, 8
    k = jnp.asarray(lat.k_cart(kfrac))

    A = lambda x: op.apply_A(x, k)
    res = lobpcg(A, op.apply_M, _x0(m, sp.dof_shape, 12), nev,
                 maxiter=300, tol=1e-10, precond=jacobi(op.diag_A(k)))
    exact = scalar_bands(lat, np.asarray(k), nev)
    got = np.asarray(res.eigenvalues)
    # Relative to the first nonzero eigenvalue scale.
    scale = max(exact.max(), 1.0)
    assert np.all(np.abs(got - exact) / scale < 2e-6), (got, exact)


def test_e2e_chebyshev_beats_jacobi_iterations():
    lat = make_lattice("SQR")
    sp = H1Space.make(PeriodicGrid.make(lat, 8), p=2)
    op = BlochHelmholtz(sp, dtype=jnp.complex128)
    k = jnp.asarray(lat.k_cart((0.31, 0.17)))
    A = lambda x: op.apply_A(x, k)
    d = op.diag_A(k)
    lmax = estimate_lmax(A, d, sp.dof_shape, dtype=jnp.complex128)
    X0 = _x0(8, sp.dof_shape, 13)
    r_jac = lobpcg(A, op.apply_M, X0, 4, maxiter=200, tol=1e-8,
                   precond=jacobi(d))
    r_cheb = lobpcg(A, op.apply_M, X0, 4, maxiter=200, tol=1e-8,
                    precond=chebyshev(lambda x: op.apply_A(x, k), d, lmax,
                                      degree=4))
    assert bool(jnp.all(r_cheb.converged))
    assert int(r_cheb.iterations) < int(r_jac.iterations)


def test_lobpcg_dropped_rows_stay_finite():
    """When the block is wider than the space (rank-deficient by
    construction, so whitening-dropped rows land inside the nev
    window), the returned eigenvalues/residuals must be FINITE with
    converged=False marking the degenerate rows —
    inf must not leak into band tables / JSON output."""
    import jax.numpy as jnp
    from bravais_tpu.eigen.lobpcg import lobpcg

    d = np.asarray([1.0, 2.0, 3.0])
    A = lambda x: jnp.asarray(d) * x
    rng = np.random.default_rng(3)
    X0 = jnp.asarray(rng.standard_normal((5, 3))
                     + 1j * rng.standard_normal((5, 3)))
    r = lobpcg(A, None, X0, nev=5, maxiter=60, tol=1e-8)
    lam = np.asarray(r.eigenvalues)
    res = np.asarray(r.residual_norms)
    conv = np.asarray(r.converged)
    assert np.all(np.isfinite(lam)) and np.all(np.isfinite(res))
    np.testing.assert_allclose(lam[:3], d, rtol=1e-6, atol=1e-8)
    assert conv[:3].all() and not conv[3:].any()


def test_lobpcg_reseeds_zero_warm_rows():
    """Zero rows in a warm-start block are ABSORBING without reseeding
    (R = 0 ⇒ W = 0 ⇒ the row never revives), silently shrinking the
    effective block across a warm-started k-chain (round-4 collapse
    bug). The init reseed must recover full rank and converge all nev
    bands from a block whose guard rows are exactly zero."""
    n, nev, m = 60, 5, 9
    H = _rand_hermitian(n, 7)
    exact = scipy.linalg.eigh(H, eigvals_only=True)[:nev]
    A = lambda x: jnp.asarray(H) @ x
    X0 = np.array(_x0(m, (n,), 11))
    X0[nev:] = 0.0  # degenerate warm start: all guard rows zero
    r = lobpcg(A, None, jnp.asarray(X0), nev, maxiter=300, tol=1e-9)
    assert bool(jnp.all(r.converged))
    np.testing.assert_allclose(np.asarray(r.eigenvalues), exact,
                               rtol=1e-8, atol=1e-8)
    # The reseeded rows must carry actual (nonzero) eigenvectors.
    X = np.asarray(r.eigenvectors)
    assert np.all(np.linalg.norm(X[:nev], axis=1) > 0.1)


def test_lobpcg_knife_edge_tol_terminates_fast():
    """A stopping tolerance AT the f32 residual noise floor must not
    run to maxiter (round-4 bug: the stagnation stop was disarmed by
    an inf sentinel in the tracked rows and the solve ground to the
    absorbing all-zero state). The rank-aware tracked residual +
    degeneration stop must terminate within a few 16-iteration
    segments, with finite outputs."""
    n, nev, m = 80, 4, 8
    H = _rand_hermitian(n, 13, dtype=np.complex64, spd_shift=4.0 * n)
    A = lambda x: jnp.asarray(H, jnp.complex64) @ x
    # tol far below the f32 floor: residuals plateau, done can't fire.
    r = lobpcg(A, None, _x0(m, (n,), 17, jnp.complex64), nev,
               maxiter=400, tol=1e-12)
    assert int(r.iterations) < 120  # stagnation stop, not maxiter
    lam = np.asarray(r.eigenvalues)
    X = np.asarray(r.eigenvectors)
    assert np.all(np.isfinite(lam))
    assert np.linalg.norm(X) > 0.1  # no collapse
    exact = scipy.linalg.eigh(H.astype(np.complex128),
                              eigvals_only=True)[:nev]
    np.testing.assert_allclose(lam, exact, rtol=1e-4)


def test_lobpcg_reseeds_all_zero_block():
    """A fully-zero X0 must still reseed: the reseed threshold is
    rn < 1e-6·max(rn), which is all-False when max(rn) == 0 (round-4e
    review) — without the absolute floor the zero block survives init,
    whitening drops every direction, and the solve exits through the
    degeneration stop with garbage while a warm chain carries the
    absorbing zero block to every later k."""
    n, nev, m = 60, 5, 9
    H = _rand_hermitian(n, 7)
    exact = scipy.linalg.eigh(H, eigvals_only=True)[:nev]
    A = lambda x: jnp.asarray(H) @ x
    X0 = jnp.zeros((m, n), jnp.complex128)
    r = lobpcg(A, None, X0, nev, maxiter=300, tol=1e-9)
    assert bool(jnp.all(r.converged))
    np.testing.assert_allclose(np.asarray(r.eigenvalues), exact,
                               rtol=1e-8, atol=1e-8)
