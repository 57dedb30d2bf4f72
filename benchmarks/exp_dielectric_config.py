"""Experiment: varying-ε Maxwell solver configurations (round-3 item 1).

Compares LOBPCG iteration counts at dielectric-sphere contrast for:
  a) round-2 production: σ-shift (sigma_shift bug branch) + cg defl
  b) σ-shift with the matched fd_sigma + cg defl
  c) project-cg: per-iteration true-L PCG projection, no shift

Run on the CPU (small n) or the GPU. Usage:
    python benchmarks/exp_dielectric_config.py [--n 4] [--p 2] [--eps 13]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--p", type=int, default=2)
    ap.add_argument("--eps", type=float, default=13.0)
    ap.add_argument("--nev", type=int, default=8)
    ap.add_argument("--block", type=int, default=14)
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--cg-iters", type=int, default=8)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--configs", type=str,
                    default="a,b,c")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from bravais_tpu.lattices import make_lattice
    from bravais_tpu.meshing.grid import PeriodicGrid
    from bravais_tpu.operators.coefficients import dielectric_sphere
    from bravais_tpu.operators.curlcurl import BlochCurlCurl
    from bravais_tpu.spaces.nedelec import NedelecSpace

    lat = make_lattice("CUB")
    grid = PeriodicGrid.make(lat, args.n)
    center = 0.5 * lat.A.sum(axis=0)
    eps = dielectric_sphere(args.eps, 1.0, 0.25, center, lat.A, 0.0)
    sp = NedelecSpace.make(grid, args.p)
    op = BlochCurlCurl(sp, eps=eps, dtype=jnp.complex64)
    assert not op._coef_elem_invariant()
    k = jnp.asarray(np.asarray(lat.k_cart((0.5, 0.0, 0.0)), np.float32))
    rng = np.random.default_rng(0)
    X0 = jnp.asarray((rng.standard_normal((args.block,) + sp.field_shape)
                      + 1j * rng.standard_normal(
                          (args.block,) + sp.field_shape)
                      ).astype(np.complex64))

    cfgs = {
        "a": dict(deflation="cg", precond="fastdiag-cg",
                  sigma=op.sigma_shift, cg_iters=args.cg_iters),
        "b": dict(deflation="cg", precond="fastdiag-cg",
                  cg_iters=args.cg_iters),
        "c": dict(deflation="project-cg", precond="fastdiag-cg",
                  cg_iters=args.cg_iters),
        "d": dict(deflation="project-cg", precond="fastdiag",
                  cg_iters=args.cg_iters),
    }
    for name in args.configs.split(","):
        kw = cfgs[name]
        solve = op.make_solve_fn(**kw)
        t0 = time.time()
        r = solve(op, X0, k, args.nev, args.tol, 250, None)
        lam = np.asarray(r.eigenvalues)
        t1 = time.time()
        r2 = solve(op, X0, k, args.nev, args.tol, 250, None)
        _ = np.asarray(r2.eigenvalues)
        t2 = time.time()
        print(f"cfg {name}: iters={int(r.iterations)} "
              f"max_res={float(np.max(np.asarray(r.residual_norms))):.2e} "
              f"lam[:4]={np.round(lam[:4], 4)} "
              f"t_first={t1 - t0:.1f}s t_steady={t2 - t1:.2f}s  {kw}")


if __name__ == "__main__":
    main()
