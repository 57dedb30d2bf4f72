"""Band-structure driver app — the rebuild of the reference's CLI
binaries (SURVEY.md §2.1 #7, call stack §3.1).

    python -m bravais_tpu.cli.bands_app --lattice SQR --problem tm \
        --eps-in 8.9 --radius 0.2 --n 16 --p 3 --nk 48 --nev 8 \
        --out results/sq_tm --plot

Wires config -> lattice -> mesh -> operator -> k-sweep -> band table
(+ checkpoint/resume, structured per-k logging, optional plot).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def build_problem(cfg):
    """Config -> (lattice, kpath, operator, solve extras)."""
    import jax.numpy as jnp  # noqa: F401  (dtype selection)
    from bravais_tpu.lattices import kpath, make_lattice
    from bravais_tpu.meshing.grid import PeriodicGrid
    from bravais_tpu.operators.coefficients import dielectric_rod
    from bravais_tpu.operators.helmholtz import BlochHelmholtz
    from bravais_tpu.spaces.h1 import H1Space

    lat = make_lattice(cfg.lattice, **cfg.lattice_kwargs())
    kp = kpath(lat, npts=cfg.nk, path=cfg.path)
    grid = PeriodicGrid.make(lat, cfg.n)

    if cfg.problem in ("tm", "te", "scalar"):
        sp = H1Space.make(grid, cfg.p, cfg.quad)
        if cfg.radius > 0:
            center = 0.5 * lat.A.sum(axis=0)
            eps = dielectric_rod(cfg.eps_in, cfg.eps_out, cfg.radius * cfg.a,
                                 center, lat.A, cfg.smooth_width)
        else:
            eps = cfg.eps_out
        from bravais_tpu.operators.coefficients import subcell_average
        qcell = lat.A / (cfg.n * sp.q)   # quadrature subcell vectors
        if cfg.problem == "te":
            # TE (H_z): alpha = 1/eps, beta = 1  (SURVEY.md App. B.1).
            # Subcell smoothing averages 1/ε — the coefficient the weak
            # form integrates (the harmonic member of the classic
            # subpixel-smoothing pair).
            inv = (lambda x: 1.0 / eps(x)) if callable(eps) else 1.0 / eps
            if cfg.subcell > 1 and callable(inv):
                inv = subcell_average(inv, qcell, cfg.subcell)
            op = BlochHelmholtz(sp, alpha=inv, beta=1.0, dtype=cfg.dtype)
        else:
            # TM (E_z) / generic scalar: alpha = 1, beta = eps
            if cfg.subcell > 1 and callable(eps):
                eps = subcell_average(eps, qcell, cfg.subcell)
            op = BlochHelmholtz(sp, alpha=1.0, beta=eps, dtype=cfg.dtype)
        return lat, kp, op
    if cfg.problem == "maxwell":
        from bravais_tpu.operators.curlcurl import BlochCurlCurl
        from bravais_tpu.spaces.nedelec import NedelecSpace
        from bravais_tpu.operators.coefficients import dielectric_sphere
        sp = NedelecSpace.make(grid, cfg.p, cfg.quad)
        if cfg.radius > 0:
            center = 0.5 * lat.A.sum(axis=0)
            eps = dielectric_sphere(cfg.eps_in, cfg.eps_out,
                                    cfg.radius * cfg.a, center, lat.A,
                                    cfg.smooth_width)
        else:
            eps = cfg.eps_out
        if cfg.subcell > 1 and callable(eps):
            from bravais_tpu.operators.coefficients import subcell_average
            eps = subcell_average(eps, lat.A / (cfg.n * sp.q),
                                  cfg.subcell)
        op = BlochCurlCurl(sp, eps=eps, dtype=cfg.dtype)
        return lat, kp, op
    raise ValueError(f"unknown problem {cfg.problem!r}")


def make_solve_fn(cfg, op):
    """Pick the solver configuration per problem family and engine."""
    mk = getattr(op, "make_solve_fn", None)
    if mk is None:
        return None
    import numpy as np
    fd_ok = min(op.space.grid.shape) >= 3
    if cfg.problem != "maxwell":
        # scalar: spectral engine when exact (element-invariant
        # coefficients), else the default Jacobi/GMG matrix-free path
        if (cfg.engine in ("auto", "spectral") and fd_ok
                and op._coef_elem_invariant()):
            return mk(engine="spectral")
        return None
    engine = cfg.engine
    if engine == "auto":
        if fd_ok and op._coef_elem_invariant():
            engine = "spectral"
        elif fd_ok:
            engine = "field"
        else:
            engine = "gmg"
    if engine == "spectral":
        return mk(engine="spectral")
    if engine == "field":
        if op._coef_elem_invariant():
            return mk(deflation="project", precond="fastdiag")
        # Varying ε: per-iteration TRUE-L preconditioned-Chebyshev
        # projection (kernel-contracting at any contrast — unlike the
        # mean-twin direct solve; reduction-free and f32-stable —
        # unlike CG, see gradient_component_cheby) + the DIRECT
        # mean-twin (Ā+sM̄)⁻¹ fast-diagonal preconditioner. Round 4d
        # measurement: under project-cheby deflation the inner-PCG
        # preconditioner ("fastdiag-cg", the round-3 default) is
        # strictly dominated — identical-or-fewer LOBPCG iterations at
        # every contrast (ε=2: 15/15, 13: 12/13, 30: 14/16, 100:
        # 16/21 direct/inner-PCG), same refined eigenvalues, at ~1/20
        # the preconditioner cost (the PCG's 3 extra true-operator
        # applies + its f32 recursion noise buy nothing once the
        # projector handles the contrast structure). Round-3 history:
        # 13-20 iters at ε ∈ [2, 30] vs 81-120 for the round-2
        # σ-shift configuration.
        return mk(deflation="project-cheby", precond="fastdiag")
    return mk(deflation_gmg=True)


def run(cfg, log=print):
    import jax
    import numpy as np

    from bravais_tpu.utils.runtime import setup_compile_cache

    setup_compile_cache()
    # f64/complex128 runs on whatever backend is present (the GPU has
    # native f64); x64 must be on before any array is built.
    if cfg.precision == "f64":
        jax.config.update("jax_enable_x64", True)
    from bravais_tpu.bands import (BandSweep, BandWriter, plot_bands,
                                   save_modes)
    from bravais_tpu.parallel.mesh import kpoint_mesh

    t0 = time.time()
    lat, kp, op = build_problem(cfg)
    log(f"# {lat.variant}: {op.space.ndofs} dofs, {kp.nk} k-points, "
        f"nev={cfg.nev}, tol={cfg.tol:g}, {cfg.precision}")

    sweep = BandSweep(op, nev=cfg.nev, block=cfg.block, tol=cfg.tol,
                      maxiter=cfg.maxiter, precond=cfg.precond,
                      seed=cfg.seed, solve_fn=make_solve_fn(cfg, op),
                      keep_vectors=cfg.save_modes,
                      device_tol=cfg.device_tol)

    writer = None
    if cfg.out:
        writer = BandWriter(cfg.out, cfg.identity_dict(), kp.nk, cfg.nev)
        finished = writer.try_resume() if cfg.resume else []
    else:
        finished = []
    todo = [i for i in range(kp.nk) if i not in set(finished)]
    if not todo:
        log("# all k-points already finished (resume)")
        return writer

    mesh = kpoint_mesh() if cfg.shard else None
    kcart = kp.k_cart[todo].copy()
    if cfg.problem == "maxwell":
        # Exact Γ is the measure-zero harmonic point of the quasi-
        # periodic Maxwell formulation (operators/curlcurl.py): the
        # gradient deflation is rank-deficient there and the solve
        # returns spurious near-zero bands (which then poison the
        # warm-start chain). Nudge it off-center like bench.py does —
        # the ω²→0 bands at Γ are recovered to the same accuracy at
        # the nudged point.
        for j in range(kcart.shape[0]):
            if np.linalg.norm(kcart[j]) < 1e-12:
                kcart[j] = 2e-2 * lat.B[0]
    todo_np = np.asarray(todo)
    # Every finished chunk/k-point is checkpointed IMMEDIATELY (writer
    # threaded into the sweep loops — crash-safe resume, SURVEY.md §5).
    if cfg.mode == "warm" and mesh is not None:
        res = sweep.run_warm_sharded(kcart, mesh, writer=writer,
                                     k_index=todo_np)
    elif cfg.mode == "warm":
        res = sweep.run_warm(kcart, writer=writer, k_index=todo_np)
    elif cfg.mode == "warm-chain":
        res = sweep.run_warm_chain(kcart, chain=cfg.chain,
                                   precond=cfg.pc_mode,
                                   writer=writer, k_index=todo_np)
    else:
        res = sweep.run(kcart, mesh=mesh, writer=writer, k_index=todo_np)

    for j, i in enumerate(todo):
        lamj = res.eigenvalues[j]
        log(json.dumps({"k_index": i,
                        "k_frac": [round(float(x), 6) for x in kp.k_frac[i]],
                        "iters": int(res.iterations[j]),
                        "max_rel_res": float(np.max(res.residuals[j])),
                        "eigenvalues": [float(v) for v in lamj]}))
    if cfg.save_modes and cfg.out:
        if res.eigenvectors is None:
            # Every sweep regime honors keep_vectors (incl. warm+shard)
            # — reaching here means a regression, so be
            # loud instead of silently doing less than asked.
            raise RuntimeError(
                "--save-modes requested but the sweep returned no "
                "eigenvectors (keep_vectors not honored)")
        for j, i in enumerate(todo):
            save_modes(cfg.out, i, kp.k_cart[i], res.eigenvalues[j],
                       res.eigenvectors[j])
        log(f"# modes saved for {len(todo)} k-points under {cfg.out}")
    if writer is not None:
        if cfg.plot:
            import pathlib
            dat = writer.eigenvalues
            plot_bands(kp, dat,
                       path=pathlib.Path(cfg.out) / "bands.png",
                       title=f"{lat.variant} {cfg.problem.upper()}")
    log(f"# done: compile {res.compile_s:.1f}s, steady {res.wall_s:.2f}s, "
        f"total {time.time() - t0:.1f}s, "
        f"mean iters {float(np.mean(res.iterations)):.1f}")
    return writer


def main(argv=None):
    from bravais_tpu.cli.config import RunConfig
    ap = argparse.ArgumentParser(description=__doc__)
    RunConfig.add_cli_args(ap)
    cfg = RunConfig.from_cli_args(ap.parse_args(argv))
    run(cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
