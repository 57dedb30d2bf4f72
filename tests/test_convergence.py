"""Discretization convergence-order checks (SURVEY.md §4.2 item 3:
"convergence-order checks"): empty-lattice eigenvalue error must decay
at the spectral-element rate O(h^{2p}) under h-refinement, for both the
H1 scalar and the Nédélec Maxwell discretizations."""

import numpy as np
import pytest
import scipy.linalg

from bravais_tpu.lattices import make_lattice
from bravais_tpu.meshing.grid import PeriodicGrid
from bravais_tpu.operators.dense import assemble_h1
from bravais_tpu.spaces.h1 import H1Space
from tests.oracles.analytic import scalar_bands


def _h1_err(lat, n, p, k, nb=4):
    sp = H1Space.make(PeriodicGrid.make(lat, n), p)
    A, M = assemble_h1(sp, k)
    vals = scipy.linalg.eigh(A, M, eigvals_only=True)[:nb]
    ex = scalar_bands(lat, k, nb, mmax=4)
    # band 1 is exact (constant envelope); measure bands 2..nb
    return float(np.max(np.abs(vals[1:] - ex[1:]) / ex[1:]))


@pytest.mark.parametrize("p,order_floor", [(1, 1.6), (2, 3.5), (3, 5.2)])
def test_h1_eigenvalue_convergence_order(p, order_floor):
    lat = make_lattice("SQR")
    k = lat.k_cart((0.21, 0.13))
    e1 = _h1_err(lat, 4, p, k)
    e2 = _h1_err(lat, 8, p, k)
    order = np.log2(e1 / e2)
    assert order > order_floor, (p, e1, e2, order)


def test_nedelec_eigenvalue_convergence_order():
    """Maxwell p=2: h-refinement 3→6 must show ~2p-order eigenvalue
    decay (via the exact twisted-DFT block spectrum — the discrete
    eigenvalues of the full operator, no solver error)."""
    import jax.numpy as jnp
    from bravais_tpu.operators.curlcurl import BlochCurlCurl
    from bravais_tpu.spaces.nedelec import NedelecSpace
    from tests.oracles.analytic import maxwell_bands

    lat = make_lattice("CUB")
    k = np.asarray(lat.k_cart((0.21, 0.13, 0.17)))
    errs = []
    for n in (3, 6):
        sp = NedelecSpace.make(PeriodicGrid.make(lat, n), 2)
        op = BlochCurlCurl(sp, dtype=jnp.complex128)
        fd = op.fastdiag_G()
        # exact discrete spectrum of every block, f64
        sup = np.ones((1, fd.nblocks))  # all blocks are candidates
        lam, _ = op.spectral_refine_np(sup, k, 6, topk=fd.nblocks,
                                       tau=0.0)
        ex = maxwell_bands(lat, k, 6, mmax=3)
        errs.append(float(np.max(np.abs(lam - ex) / ex)))
    order = np.log2(errs[0] / errs[1])
    assert order > 3.4, (errs, order)


@pytest.mark.slow
def test_maxwell_dielectric_sphere_convergence():
    """Quantitative accuracy gate for dielectric Maxwell: ε=13 sphere (r=0.25a, CUB) lowest
    band at X under n-refinement with subcell-averaged ε, f64.

    Measured sequence (p=2, subcell=3): λ₁ = 6.3710 (n=3), 6.5736
    (n=4), 6.6662 (n=6), 6.8861 (n=8), 6.9248 (n=10) — monotone from
    below with |λ(8)−λ(10)|/λ ≈ 0.6%. The gate asserts monotone
    n-refinement, error contraction ≥1.6× from n=3 to n=6 against the
    n=8 reference, and n=6 within 5% — interface-limited convergence,
    the honest rate for a sharp discontinuity resolved in the
    coefficient (SURVEY §7.0 item 1)."""
    import jax.numpy as jnp
    from bravais_tpu.operators.coefficients import (dielectric_sphere,
                                                    subcell_average)
    from bravais_tpu.operators.curlcurl import BlochCurlCurl
    from bravais_tpu.spaces.nedelec import NedelecSpace

    lat = make_lattice("CUB")
    center = 0.5 * lat.A.sum(axis=0)
    kx = jnp.asarray(lat.k_cart((0.5, 0.0, 0.0)))

    def band1(n, p=2, nsub=3, nev=2):
        sp = NedelecSpace.make(PeriodicGrid.make(lat, n), p)
        eps = dielectric_sphere(13.0, 1.0, 0.25, center, lat.A, 0.0)
        eps = subcell_average(eps, lat.A / (n * sp.q), nsub)
        op = BlochCurlCurl(sp, eps=eps, dtype=jnp.complex128)
        rng = np.random.default_rng(0)
        X0 = jnp.asarray(
            rng.standard_normal((nev + 4,) + sp.field_shape)
            + 1j * rng.standard_normal((nev + 4,) + sp.field_shape))
        solve = op.make_solve_fn(deflation="project-cheby",
                                 precond="fastdiag-cg")
        r = solve(op, X0, kx, nev, 1e-8, 300, None)
        lam = np.asarray(r.eigenvalues)
        # lowest pair is doubly degenerate at X
        assert abs(lam[1] - lam[0]) < 1e-6 * lam[0], lam
        return float(lam[0])

    vals = {n: band1(n) for n in (3, 6, 8)}
    assert vals[3] < vals[6] < vals[8], vals   # monotone from below
    err3 = vals[8] - vals[3]
    err6 = vals[8] - vals[6]
    assert err6 < 0.62 * err3, vals            # measured ratio 0.43
    assert err6 / vals[8] < 0.05, vals
