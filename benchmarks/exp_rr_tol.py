"""Measure LOBPCG iteration/accuracy impact of a LOOSER Rayleigh-Ritz
Jacobi-eigh stop (jacobi_eigh rel_tol / lobpcg rr_tol).

The per-iteration RR eigh runs to machine precision, but mid-iteration RR errors
self-correct through the next iteration's re-whitening — the final
quadratic-convergence sweeps may be skippable. This measures iters +
refined accuracy on CPU for both engines at rel_tol in
{machine, 1e-5, 1e-4, 1e-3}.

    python benchmarks/exp_rr_tol.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from bravais_tpu.bands import BandSweep
    from bravais_tpu.lattices import make_lattice
    from bravais_tpu.meshing.grid import PeriodicGrid
    from bravais_tpu.operators.coefficients import dielectric_sphere
    from bravais_tpu.operators.curlcurl import BlochCurlCurl
    from bravais_tpu.spaces.nedelec import NedelecSpace

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "tests"))
    from test_maxwell_bands import _dense_deflated_dielectric
    from oracles.analytic import maxwell_bands

    # rel=None means the MACHINE-precision RR (rr_tol=None passed
    # through BandSweep/make_solve_fn), the control the production
    # PROD_RR_TOL=1e-4 default is judged against.

    # --- spectral engine: FCC empty-lattice Maxwell vs analytic -------
    lat = make_lattice("FCC")
    sp = NedelecSpace.make(PeriodicGrid.make(lat, 4), 2)
    k = np.asarray(lat.k_cart((0.25, 0.0, 0.25)), np.float32)
    nev = 6
    ex = maxwell_bands(lat, np.asarray(k, np.float64), nev)
    print(f"spectral FCC n=4 p=2: dofs={sp.ndofs}", flush=True)
    for rel in (None, 1e-5, 1e-4, 1e-3):
        op = BlochCurlCurl(sp, dtype=jnp.complex64)
        sweep = BandSweep(op, nev=nev, block=nev + 4, tol=1e-6,
                          maxiter=250, rr_tol=rel,
                          solve_fn=op.make_solve_fn(engine="spectral",
                                                    rr_tol=rel),
                          device_tol=1e-3)
        t0 = time.time()
        res = sweep.run(np.asarray([k]))
        err = np.max(np.abs(res.eigenvalues[0] - ex)) / ex.max()
        print(f"  rr_tol={str(rel):8s} iters={int(res.iterations[0]):3d}"
              f"  eig_err={err:.3e}  f64_res={np.max(res.residuals):.3e}"
              f"  wall={time.time() - t0:6.1f}s", flush=True)

    # --- field engine: CUB dielectric vs complex128 direct ------------
    lat = make_lattice("CUB")
    grid = PeriodicGrid.make(lat, 4)
    center = 0.5 * lat.A.sum(axis=0)
    k = np.asarray(lat.k_cart((0.5, 0.0, 0.0)), np.float32)
    for eps_in in (13.0, 30.0):
        eps = dielectric_sphere(eps_in, 1.0, 0.25, center, lat.A, 0.0)
        sp = NedelecSpace.make(grid, 2)
        op64 = BlochCurlCurl(sp, eps=eps, dtype=jnp.complex128)
        dense_vals = _dense_deflated_dielectric(
            sp, op64, np.asarray(k, np.float64), 5)
        print(f"field eps={eps_in:g}:", flush=True)
        for rel in (None, 1e-5, 1e-4, 1e-3):
            op = BlochCurlCurl(sp, eps=eps, dtype=jnp.complex64)
            solve = op.make_solve_fn(deflation="project-cheby",
                                     precond="fastdiag-cg", rr_tol=rel)
            sweep = BandSweep(op, nev=5, block=9, tol=1e-6,
                              maxiter=250, solve_fn=solve,
                              device_tol=1e-4)
            t0 = time.time()
            res = sweep.run(np.asarray([k]))
            rel_err = (np.abs(res.eigenvalues[0] - dense_vals)
                       / np.abs(dense_vals)).max()
            print(f"  rr_tol={str(rel):8s}"
                  f" iters={int(res.iterations[0]):3d}"
                  f"  rel_err={rel_err:.3e}"
                  f"  f64_res={np.max(res.residuals):.3e}"
                  f"  wall={time.time() - t0:6.1f}s", flush=True)


if __name__ == "__main__":
    main()
