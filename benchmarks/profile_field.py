"""Profile the FIELD-engine (varying-ε Maxwell) per-k pieces on the
machine it runs on — the config-3 dielectric production path
(BASELINE.json:9). One LOBPCG iteration issues many small sequential
ops through the Chebyshev kernel projector, the preconditioner and the
Rayleigh–Ritz step; this times each piece jitted separately (k traced,
real boundaries — utils/reim.py), like benchmarks/profile_spectral.py
does for the spectral engine. Host-clock times around
``block_until_ready``.

    python benchmarks/profile_field.py [--n 6] [--p 3] [--eps 13]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=6)
    ap.add_argument("--p", type=int, default=3)
    ap.add_argument("--m", type=int, default=16)
    ap.add_argument("--eps", type=float, default=13.0)
    ap.add_argument("--radius", type=float, default=0.25)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from bravais_tpu.utils.runtime import device_info, setup_compile_cache
    setup_compile_cache()
    print(device_info())
    import jax.numpy as jnp
    import numpy as np
    from bravais_tpu.lattices import make_lattice
    from bravais_tpu.meshing.grid import PeriodicGrid
    from bravais_tpu.operators.coefficients import dielectric_sphere
    from bravais_tpu.operators.curlcurl import BlochCurlCurl
    from bravais_tpu.spaces.nedelec import NedelecSpace
    from bravais_tpu.utils.reim import from_reim, to_reim

    lat = make_lattice("CUB")
    sp = NedelecSpace.make(PeriodicGrid.make(lat, args.n), args.p)
    eps = dielectric_sphere(args.eps, 1.0, args.radius,
                            0.5 * lat.A.sum(axis=0), lat.A)
    op = BlochCurlCurl(sp, eps=eps, dtype=jnp.complex64)
    m = args.m
    k = jnp.asarray(np.asarray(lat.k_cart((0.3, 0.1, 0.2)), np.float32))
    print(f"n={args.n} p={args.p} eps={args.eps}: dofs={sp.ndofs}, "
          f"m={m}, cheby_steps={op.cheby_steps()}")

    # Build the lazily-constructed twin solvers EAGERLY before any jit
    # trace (operator state construction eagerly touches the device and
    # must not first happen inside a trace).
    op.fastdiag()
    op.fastdiag_L()

    rng = np.random.default_rng(0)
    Xr = jnp.asarray(rng.standard_normal((2, m) + sp.field_shape)
                     .astype(np.float32))
    xr = jnp.asarray(rng.standard_normal((2,) + sp.field_shape)
                     .astype(np.float32))

    def timed(name, fn, *xs):
        f = jax.jit(fn)
        y = f(*xs)
        jax.block_until_ready(y)
        t0 = time.time()
        for _ in range(args.reps):
            y = f(*xs)
        jax.block_until_ready(y)
        dt = (time.time() - t0) / args.reps
        print(f"  {name:46s} {1e3 * dt:8.2f} ms")
        return dt

    # -- single-field applies ---------------------------------------------
    def a_apply(xr, k):
        return to_reim(op.apply_A(from_reim(xr), k))
    timed("apply_A (1 field)", a_apply, xr, k)

    def am_batched(Xr, k):
        X = from_reim(Xr)
        ax = jax.vmap(lambda x: op.apply_A(x, k))(X)
        mx = jax.vmap(lambda x: op.apply_M(x, k))(X)
        return to_reim(ax), to_reim(mx)
    timed(f"(A,M) applies batched (m={m})", am_batched, Xr, k)

    Hr = jnp.asarray(rng.standard_normal((2, m) + op.h1.dof_shape)
                     .astype(np.float32))

    def lk_batched(Hr, k):
        return to_reim(jax.vmap(lambda x: op.apply_Lk(x, k))(from_reim(Hr)))
    timed(f"apply_Lk (H1 twin) batched (m={m})", lk_batched, Hr, k)

    # -- preconditioner: inner-PCG (A+sM)^-1 -------------------------------
    def pc_call(Xr, k):
        pc = op.fd_precond_cg(k, inner_iters=3)  # production default
        return to_reim(jax.vmap(pc)(from_reim(Xr)))
    timed(f"fd_precond_cg (m={m}, 3 inner PCG)", pc_call, Xr, k)

    def minv_call(Xr, k):
        minv = op.fastdiag().solver(
            [("A", 1.0), ("M", op.default_fd_shift())], k)
        return to_reim(jax.vmap(minv)(from_reim(Xr)))
    timed(f"mean-twin fastdiag solve (m={m})", minv_call, Xr, k)

    # -- kernel projector: preconditioned Chebyshev -------------------------
    def cheby_call(Xr, k):
        lpc = op.fastdiag_L().solver([("L", 1.0)], k, method="eigh")
        prj = jax.vmap(lambda x: op.gradient_component_cheby(
            x, k=k, lsolve=lpc))
        return to_reim(prj(from_reim(Xr)))
    timed(f"cheby kernel projector (m={m})", cheby_call, Xr, k)

    def lsolve_call(Xr, k):
        lpc = op.fastdiag_L().solver([("L", 1.0)], k, method="eigh")
        X = from_reim(Xr)
        rhs = jax.vmap(lambda x: op.apply_GkH(op.apply_M(x, k), k))(X)
        return to_reim(jax.vmap(lpc)(rhs))
    timed(f"GkH.M + L-twin solve (m={m})", lsolve_call, Xr, k)

    # -- Rayleigh-Ritz eigh --------------------------------------------------
    from bravais_tpu.eigen.jacobi_eigh import jacobi_eigh
    H_r = jnp.asarray(rng.standard_normal((2, 3 * m, 3 * m))
                      .astype(np.float32))

    def eigh3m(Hr):
        H = Hr[0] + 1j * Hr[1]
        H = 0.5 * (H + jnp.conj(H.T))
        w, V = jacobi_eigh(H)
        return jnp.abs(w).sum() + jnp.abs(V).sum()
    timed(f"jacobi_eigh({3 * m}x{3 * m})", eigh3m, H_r)

    # -- full solves ---------------------------------------------------------
    solve = op.make_solve_fn(deflation="project-cheby",
                             precond="fastdiag")

    def full(maxiter):
        def f(Xr, k):
            r = solve(op, from_reim(Xr), k, min(10, m - 2), 1e-4,
                      maxiter, None)
            return r.eigenvalues, r.iterations
        jf = jax.jit(f)
        y = jf(Xr, k)
        jax.block_until_ready(y)
        t0 = time.time()
        for _ in range(args.reps):
            y = jf(Xr, k)
        jax.block_until_ready(y)
        return (time.time() - t0) / args.reps, int(np.asarray(y[1]))

    t1, it1 = full(1)
    t10, it10 = full(10)
    print(f"  full solve maxiter=1: {1e3 * t1:.1f} ms ({it1} its); "
          f"maxiter=10: {1e3 * t10:.1f} ms ({it10} its); "
          f"per-iter ~{1e3 * (t10 - t1) / max(it10 - it1, 1):.1f} ms")


if __name__ == "__main__":
    main()
