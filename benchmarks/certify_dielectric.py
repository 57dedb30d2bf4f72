"""Certify config-3 dielectric eigenvalue accuracy at PRODUCTION size
.

The round-4 gap: the f32+refine certification test
(tests/test_maxwell_bands.py::test_dielectric_f32_refine_certified)
runs n=4 p=2 against a complex128 DENSE oracle; nothing certified the
production n=6 p=3 configuration, whose warm sweep leaves the
smallest-|k| point at a ~1.7e-3 device residual. The dense oracle cannot scale to 17,496 dofs (the deflation
construction alone is O(ndofs * nh1) operator applies) — but the f64
MATRIX-FREE field engine can: same discretization, same production
solver family, complex128 arithmetic, tight residual stop.

Methodology (round-5 final, after a first attempt failed for
METHOD reasons, not accuracy reasons — results/ab_r5 history):

- The f32 production run is the FULL nk-point warm sweep, exactly
  bench.py's ``--problem dielectric`` configuration (warm starts
  follow the real Γ–X–M–R path); the sampled k are certified out of
  it. Sampling the path and warm-starting ACROSS the sample's jumps
  mismeasures production (a k=10→k=15 jump is a colder start than any
  production step).
- The f64 oracle solves each sampled k independently COLD, with a
  DEEP-contraction Chebyshev kernel projector
  (``cheby_target=1e-6`` vs the production 0.15): at the production
  contraction the projector's per-application kernel leakage (~0.15)
  caps the reachable residual far above the 1e-9 oracle stop — the
  first attempt's oracle degenerated outright at the R point
  (λ=−3966 kernel collapse) for exactly that reason, while the f32
  production point there was clean.
- Two error metrics per band: STRICT relative |Δλ|/|λ64|, and
  SCALE-AWARE relative |Δλ|/max(|λ64|, 1e-3·λ_max(k)). The nudged-Γ
  point carries acoustic bands of size O(|k_nudge|²) ≈ 5e-4·λ_max;
  a 5e-8 ABSOLUTE eigenvalue agreement there is a 4e-6 strict
  relative error — amplification by an arbitrarily small denominator,
  not solver error (the nudge magnitude is a bench convention). The
  certification bar applies to the scale-aware metric; both are
  printed per band so the amplification is visible, and the strict
  metric still gates every band above the 1e-3·λ_max floor.

Run from the repo root (long on the CPU; f64 runs on the GPU too):

    PYTHONPATH=. python benchmarks/certify_dielectric.py [--n 6] [--p 3]

Prints one JSON line per certified k-point plus a summary line; exit
status 1 if any k-point misses the 1e-6 scale-aware bar.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=6)
    ap.add_argument("--p", type=int, default=3)
    ap.add_argument("--nev", type=int, default=10)
    ap.add_argument("--nk", type=int, default=16)
    ap.add_argument("--eps-in", type=float, default=13.0)
    ap.add_argument("--radius", type=float, default=0.25)
    ap.add_argument("--k-indices", type=str, default="0,1,5,10,15",
                    help="indices into the nk-point G-X-M-R bench path "
                    "to certify. k=1 (smallest nonzero |k|) is the "
                    "near-Gamma point whose f32 device residual "
                    "stalls at ~1.7e-3 while every other k reaches the "
                    "1e-4 stop — this script adjudicates whether the "
                    "f64 refine still certifies it")
    ap.add_argument("--bar", type=float, default=1e-6,
                    help="scale-aware relative eigenvalue agreement bar")
    ap.add_argument("--band-floor", type=float, default=1e-3,
                    help="scale-aware denominator floor, as a fraction "
                    "of the k-point's largest certified eigenvalue")
    ap.add_argument("--f64-tol", type=float, default=1e-9,
                    help="f64 oracle residual stop")
    ap.add_argument("--oracle-cheby-target", type=float, default=1e-6,
                    help="kernel-projector contraction per application "
                    "for the f64 oracle (production uses 0.15)")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from bravais_tpu.bands import BandSweep
    from bravais_tpu.lattices import kpath, make_lattice
    from bravais_tpu.meshing.grid import PeriodicGrid
    from bravais_tpu.operators.coefficients import dielectric_sphere
    from bravais_tpu.operators.curlcurl import BlochCurlCurl
    from bravais_tpu.spaces.nedelec import NedelecSpace

    lat = make_lattice("CUB")
    kp = kpath(lat, npts=args.nk, path=[["G", "X", "M", "R"]])
    kc = kp.k_cart.copy()
    for i in range(kc.shape[0]):           # nudge exact Γ (bench.py rule)
        if np.linalg.norm(kc[i]) < 1e-12:
            kc[i] = 2e-2 * lat.B[0]
    idx = [int(s) for s in args.k_indices.split(",")]

    grid = PeriodicGrid.make(lat, args.n)
    sp = NedelecSpace.make(grid, args.p)
    center = 0.5 * lat.A.sum(axis=0)
    eps = dielectric_sphere(args.eps_in, 1.0, args.radius, center, lat.A)

    def sweep_for(dtype, device_tol, tol, cheby_target=None):
        op = BlochCurlCurl(sp, eps=eps, dtype=dtype)
        solve = op.make_solve_fn(deflation="project-cheby",
                                 precond="fastdiag",
                                 cheby_target=cheby_target)
        return BandSweep(op, nev=args.nev, block=args.nev + 6,
                         tol=tol, maxiter=400, solve_fn=solve,
                         device_tol=device_tol)

    # Production path: the FULL warm sweep at the bench configuration
    # (f32 device solve to the 1e-4 stop + host f64 RR refine).
    t0 = time.time()
    r32 = sweep_for(jnp.complex64, 1e-4, 1e-6).run_warm(kc)
    t32 = time.time() - t0
    # Oracle: each sampled k COLD in complex128 with the deep
    # projector, converged to f64-tight residuals (no refine: the
    # refine stage is exactly what f32 needs and f64 doesn't).
    t0 = time.time()
    osweep = sweep_for(jnp.complex128, None, args.f64_tol,
                       cheby_target=args.oracle_cheby_target)
    r64 = {i: osweep.run_warm(kc[i:i + 1]) for i in idx}
    t64 = time.time() - t0

    worst_scaled = worst_strict = 0.0
    oracle_bad = []
    ok = True
    for i in idx:
        lam32 = np.asarray(r32.eigenvalues[i])[:args.nev]
        lam64 = np.asarray(r64[i].eigenvalues[0])[:args.nev]
        res64 = float(np.max(r64[i].residuals[0]))
        if res64 > 100.0 * args.f64_tol:
            oracle_bad.append(i)
        strict = np.abs(lam32 - lam64) / np.maximum(np.abs(lam64), 1e-30)
        floor = args.band_floor * float(np.abs(lam64).max())
        scaled = np.abs(lam32 - lam64) / np.maximum(np.abs(lam64), floor)
        worst_strict = max(worst_strict, float(strict.max()))
        worst_scaled = max(worst_scaled, float(scaled.max()))
        ok &= scaled.max() < args.bar
        print(json.dumps({
            "k_index": i, "k": [float(x) for x in kc[i]],
            "max_rel_err_scaled": float(scaled.max()),
            "max_rel_err_strict": float(strict.max()),
            "rel_err_strict_per_band": [float(f"{v:.3g}") for v in strict],
            "f32_iters": int(r32.iterations[i]),
            "f64_iters": int(r64[i].iterations[0]),
            "f32_max_resid": float(np.max(r32.residuals[i])),
            "f64_max_resid": res64,
            "lam_lo": float(lam64[0]), "lam_hi": float(lam64[-1]),
        }))
    print(json.dumps({
        "summary": "dielectric f32+refine (full warm sweep) vs f64 "
                   "matrix-free cold oracle",
        "n": args.n, "p": args.p, "ndofs": sp.ndofs, "nev": args.nev,
        "eps_in": args.eps_in, "radius": args.radius,
        "k_indices": idx, "bar": args.bar,
        "band_floor": args.band_floor,
        "oracle_cheby_target": args.oracle_cheby_target,
        "worst_rel_err_scaled": worst_scaled,
        "worst_rel_err_strict": worst_strict,
        "oracle_unconverged_k": oracle_bad,
        "certified": bool(ok and not oracle_bad),
        "f32_wall_s": round(t32, 1), "f64_wall_s": round(t64, 1),
    }))
    return 0 if (ok and not oracle_bad) else 1


if __name__ == "__main__":
    sys.exit(main())
