"""Profile the spectral-engine per-k pieces on the machine it runs on:
how the headline solve splits into per-k setup and iterations.

Each phase is jitted separately with k traced, returns a real scalar
(real jit boundaries, utils/reim.py), and is timed on the host clock
around ``block_until_ready`` over repeats after a warmup.

    python benchmarks/profile_spectral.py [--n 8] [--p 4]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--p", type=int, default=4)
    ap.add_argument("--m", type=int, default=16)
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
    import jax.scipy.linalg as jsl
    import numpy as np
    from bravais_tpu.lattices import make_lattice
    from bravais_tpu.meshing.grid import PeriodicGrid
    from bravais_tpu.operators.curlcurl import BlochCurlCurl
    from bravais_tpu.spaces.nedelec import NedelecSpace

    lat = make_lattice("FCC")
    sp = NedelecSpace.make(PeriodicGrid.make(lat, args.n), args.p)
    op = BlochCurlCurl(sp, dtype=jnp.complex64)
    fd = op.fastdiag_G()
    s_ = op.default_fd_shift()
    k = jnp.asarray(np.asarray(lat.k_cart((0.3, 0.1, 0.2)), np.float32))
    m = args.m
    B, D = fd.nblocks, fd.D
    Dh1 = fd.stencils["G"].shape[2]
    print(f"n={args.n} p={args.p}: B={B} blocks, D={D}, Dh1={Dh1}, m={m}")

    rng = np.random.default_rng(0)
    Xb_r = jnp.asarray(rng.standard_normal((2, m, B, D)).astype(np.float32))

    def timed(name, fn, *xs):
        f = jax.jit(fn)
        y = f(*xs)
        jax.block_until_ready(y)
        t0 = time.time()
        for _ in range(args.reps):
            y = f(*xs)
        jax.block_until_ready(y)
        dt = (time.time() - t0) / args.reps
        print(f"  {name:42s} {1e3 * dt:8.2f} ms")
        return dt

    # -- setup pieces ----------------------------------------------------
    def blocks_all(k):
        TA = fd.blocks([("A", 1.0)], k)
        TM = fd.blocks([("M", 1.0)], k)
        TG = fd.blocks([("G", 1.0)], k)
        return (jnp.abs(TA).sum() + jnp.abs(TM).sum()
                + jnp.abs(TG).sum())

    timed("blocks assembly (TA,TM,TG)", blocks_all, k)

    def pc_build(k):
        Tsh = fd.blocks([("A", 1.0), ("M", s_)], k)
        Lc = jnp.linalg.cholesky(Tsh)
        eyeD = jnp.broadcast_to(jnp.eye(D, dtype=Tsh.dtype), Tsh.shape)
        Yc = jsl.solve_triangular(Lc, eyeD, lower=True)
        Tpc = jnp.conj(jnp.swapaxes(Yc, -1, -2)) @ Yc
        return jnp.abs(Tpc).sum()

    timed("precond build (blocks+chol+inv)", pc_build, k)

    def pc_chol_only(k):
        Tsh = fd.blocks([("A", 1.0), ("M", s_)], k)
        return jnp.abs(jnp.linalg.cholesky(Tsh)).sum()

    timed("precond: blocks+chol only", pc_chol_only, k)

    def proj_qr(k):
        TM = fd.blocks([("M", 1.0)], k)
        TG = fd.blocks([("G", 1.0)], k)
        C = jnp.linalg.cholesky(TM)
        W = jnp.conj(jnp.swapaxes(C, -1, -2)) @ TG
        _, Rq = jnp.linalg.qr(W)
        return jnp.abs(Rq).sum()

    timed("projector build (cholM+W+QR)", proj_qr, k)

    def proj_cholL(k):
        TM = fd.blocks([("M", 1.0)], k)
        TG = fd.blocks([("G", 1.0)], k)
        TGH = jnp.conj(jnp.swapaxes(TG, -1, -2))
        L = TGH @ (TM @ TG)
        Rl = jnp.linalg.cholesky(L)
        return jnp.abs(Rl).sum()

    timed("projector build ALT (L=GhMG+cholL)", proj_cholL, k)

    # -- per-iteration pieces ---------------------------------------------
    TA_np = None  # build real test blocks once on device via jit const

    def iter_matvecs(k, Xr):
        TA = fd.blocks([("A", 1.0)], k)
        X = (Xr[0] + 1j * Xr[1]).astype(jnp.complex64)
        Y = jnp.einsum("bij,mbj->mbi", TA, X)
        return jnp.abs(Y).sum()

    timed(f"blocks + batched matvec (m={m})", iter_matvecs, k, Xb_r)

    def matvec_only(Xr):
        X = (Xr[0] + 1j * Xr[1]).astype(jnp.complex64)
        T = (X[0] * 2.0).reshape(B, D)[:, :, None] * jnp.ones(
            (1, 1, D), jnp.complex64)  # fake (B,D,D) to isolate GEMM
        Y = jnp.einsum("bij,mbj->mbi", T, X)
        return jnp.abs(Y).sum()

    timed(f"batched GEMM only (B,{D},{D})x(m={m})", matvec_only, Xb_r)

    from bravais_tpu.eigen.jacobi_eigh import jacobi_eigh
    H_r = jnp.asarray(rng.standard_normal((2, 3 * m, 3 * m))
                      .astype(np.float32))

    def eigh3m(Hr):
        H = Hr[0] + 1j * Hr[1]
        H = 0.5 * (H + jnp.conj(H.T))
        w, V = jacobi_eigh(H)
        return jnp.abs(w).sum() + jnp.abs(V).sum()

    timed(f"jacobi_eigh({3 * m}x{3 * m})", eigh3m, H_r)

    Gr_r = jnp.asarray(rng.standard_normal((2, 3 * m, B * D))
                       .astype(np.float32))

    def grams(Sr):
        S = Sr[0] + 1j * Sr[1]
        G = jnp.conj(S) @ S.T
        return jnp.abs(G).sum()

    timed(f"gram ({3 * m},N)x2", grams, Gr_r)

    # -- full solves ------------------------------------------------------
    from bravais_tpu.utils.reim import from_reim
    solve = op.make_solve_fn(engine="spectral")
    X0r = jnp.asarray(rng.standard_normal((2, m) + sp.field_shape)
                      .astype(np.float32))

    def full(maxiter):
        def f(Xr, k):
            r, sup = solve(op, from_reim(Xr), k, 10, 1e-5, maxiter, None)
            return r.eigenvalues, r.iterations, sup
        jf = jax.jit(f)
        y = jf(X0r, k)
        jax.block_until_ready(y)
        t0 = time.time()
        for _ in range(args.reps):
            y = jf(X0r, k)
        jax.block_until_ready(y)
        return (time.time() - t0) / args.reps, int(np.asarray(y[1]))

    t1, it1 = full(1)
    t10, it10 = full(10)
    print(f"  full solve maxiter=1: {1e3 * t1:.1f} ms ({it1} its); "
          f"maxiter=10: {1e3 * t10:.1f} ms ({it10} its); "
          f"per-iter ~{1e3 * (t10 - t1) / max(it10 - it1, 1):.1f} ms")


if __name__ == "__main__":
    main()
