"""Headline benchmark harness (BASELINE.json:2).

Metric: k-point eigensolves/sec — FCC Maxwell band diagram, 10 bands,
Γ–X–W–L path, eigenvalue tolerance 1e-6 (f32 device solve converged to
residual 1e-5 + host f64 Rayleigh–Ritz refinement; the achieved
eigenvalue error vs the analytic empty-lattice oracle is measured and
reported — SURVEY.md §7.0 precision plan).

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline", ...}.
``vs_baseline`` is null: the reference publishes no number (BASELINE.md)
and the MFEM binary cannot run in this environment.

Usage:
    python bench.py                     # headline FCC Maxwell
    python bench.py --problem scalar    # 2D scalar Helmholtz variant
"""

import argparse
import itertools
import json
import sys
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--problem",
                    choices=["maxwell", "scalar", "dielectric",
                             "rods2d"],
                    default="maxwell")
    ap.add_argument("--eps-in", type=float, default=None,
                    help="dielectric/rods2d: inclusion permittivity "
                    "(default 13 sphere / 8.9 rod)")
    ap.add_argument("--radius", type=float, default=None,
                    help="dielectric/rods2d: inclusion radius in units "
                    "of a (default 0.25 sphere / 0.2 rod)")
    ap.add_argument("--nk", type=int, default=16)
    ap.add_argument("--n", type=int, default=0,
                    help="elements per dim (0 = per-problem default)")
    ap.add_argument("--p", type=int, default=0, help="order (0 = default)")
    ap.add_argument("--nev", type=int, default=10)
    ap.add_argument("--block", type=int, default=0,
                    help="LOBPCG block size m (0 = nev + 6)")
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--device-tol", type=float, default=None,
                    help="explicit DEVICE-loop stopping residual when "
                    "the f64 refine is active. Default is per-engine: "
                    "1e-3 for the SPECTRAL engine (its refine is an "
                    "exact subspace eigensolve — identical eig err at "
                    "1e-3 vs 1e-5 stops, 10x margin to the 1e-2 "
                    "breakdown) and 1e-4 for FIELD engines (refine is "
                    "an RR over device vectors: error quadratic in the "
                    "stop — measured UNCHANGED 5e-8 vs complex128 "
                    "direct at 1e-4, eps 13/30; "
                    "benchmarks/exp_field_device_tol.py). The achieved "
                    "accuracy is still measured and reported in detail. "
                    "0 = keep --tol on device")
    ap.add_argument("--mode",
                    choices=["warm", "batched", "warm-seg", "warm-chain"],
                    default="warm")
    ap.add_argument("--chain", type=int, default=4,
                    help="warm-chain mode: consecutive k-points solved "
                    "sequentially INSIDE one launch (amortizes the "
                    "per-launch dispatch and fetch)")
    ap.add_argument("--pc-mode", choices=["per-k", "chain-mid",
                                          "batched", "batched-setup"],
                    default="per-k",
                    help="warm-chain preconditioner: 'per-k' exact "
                    "build inside each step, 'chain-mid' one stale pc "
                    "per launch, 'batched' exact per-k pcs built in ONE "
                    "chain-wide batched-Cholesky call before the scan "
                    "(amortizes the latency-bound per-k setup at chain "
                    "x its working set), 'batched-setup' hoists the "
                    "FULL per-k setup (stencil blocks + projector + pc)")
    ap.add_argument("--chunk", type=int, default=0,
                    help="batched mode: k-points per launch (bounds "
                    "program size; 0 = all nk in one launch)")
    ap.add_argument("--segments", type=int, default=4,
                    help="warm-seg mode: vmapped warm-start chains per "
                    "launch (batches the latency-bound per-k setup)")
    ap.add_argument("--engine", choices=["spectral", "field"],
                    default="spectral",
                    help="Maxwell solve engine: 'spectral' = all-block-"
                    "space LOBPCG (exact for the empty-lattice headline;"
                    " dense batched GEMMs), 'field' = matrix-free applies with "
                    "fastdiag projection/preconditioning (general eps)")
    ap.add_argument("--pc-rep", choices=["factor", "inv"],
                    default="factor",
                    help="spectral engine: (A+sM)^-1 preconditioner "
                    "representation — 'factor' keeps the triangular "
                    "factor (cheaper per-k setup), 'inv' the explicit "
                    "inverse (cheaper per iteration); both take the "
                    "identical iteration path")
    ap.add_argument("--cheby-target", type=float, default=None,
                    help="field engine: kernel-projector contraction "
                    "per application (None = the production 0.15; "
                    "smaller = deeper projector — oracle territory). "
                    "Step count depends on the twin's spectral bounds "
                    "at SIZE: at config-3 production n=6 p=3 the "
                    "one-fewer-step boundary is 0.3 (5->4 steps); "
                    "0.2 is a measured NO-OP there (still 5)")
    ap.add_argument("--near-gamma-tol", type=float, default=None,
                    help="field engines, warm mode: looser device stop "
                    "for k-points with |k| < 0.15*min|b_i| (the f32 "
                    "exact-deflation roundoff floor near Gamma sits at "
                    "~1e-3, above the 1e-4 field stop, so the smallest-"
                    "|k| points burn 21-24%% of ALL sweep iterations "
                    "grinding it until the stagnation guard fires; the "
                    "f64 refine was CERTIFIED to recover <=1.9e-7 "
                    "relative from exactly those exits — "
                    "benchmarks/certify_dielectric.py, STATUS "
                    "S0d-cert). None = per-problem default (2e-3 for "
                    "dielectric, off otherwise); 0 = off")
    ap.add_argument("--cg-iters", type=int, default=20)
    ap.add_argument("--maxiter", type=int, default=0,
                    help="LOBPCG maxiter (0 = per-problem default)")
    ap.add_argument("--restart-tol", type=float, default=0.0,
                    help="batched mode: two-phase solve — phase 1 runs "
                    "every k to this loose residual, phase 2 restarts "
                    "(re-sorted rows, fresh P) to the device stop, all "
                    "in one launch; bounds the cold-start straggler "
                    "that bills its worst case to the whole vmapped "
                    "batch. 0 = single phase")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU backend (smoke tests of the "
                    "bench plumbing; the line's detail names the "
                    "platform)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="steady-state measurement passes (>=1). The "
                    "reported value is the MEDIAN pass rate; detail "
                    "records every pass, so every line carries its "
                    "own variance band")
    return ap.parse_args(argv)


def dtol_for(args, engine):
    """Per-engine device-stop default (see --device-tol help); an
    explicit 0 disables it (keep --tol on device)."""
    if args.device_tol is not None:
        return args.device_tol or None
    return 1e-3 if engine == "spectral" else 1e-4


def make_cell(args):
    """Build one benchmark cell from parsed ``args``: the operator, its
    BandSweep and the (Γ-nudged) k-path. Returns a namespace with
    ``lat, kp, kc, sp, op, sweep, metric, mmax, mult``."""
    import types

    import numpy as np
    import jax.numpy as jnp
    from bravais_tpu.bands import BandSweep
    from bravais_tpu.lattices import kpath, make_lattice
    from bravais_tpu.meshing.grid import PeriodicGrid

    if args.problem == "dielectric":
        # Config 3 (BASELINE.json:9): simple cubic + dielectric sphere,
        # Γ–X–M–R — the reference's bread-and-butter heterogeneous-ε
        # Maxwell workload (the hypre-AMS axis). Field engine:
        # per-iteration preconditioned-Chebyshev TRUE-L kernel
        # projection + the DIRECT mean-twin fastdiag preconditioner
        # (round 4d: strictly dominates the round-3 inner-PCG variant —
        # docs/DIELECTRIC.md has the measurement table).
        from bravais_tpu.operators.coefficients import dielectric_sphere
        from bravais_tpu.operators.curlcurl import BlochCurlCurl
        from bravais_tpu.spaces.nedelec import NedelecSpace
        n = args.n or 6
        p = args.p or 3
        lat = make_lattice("CUB")
        kp = kpath(lat, npts=args.nk, path=[["G", "X", "M", "R"]])
        sp = NedelecSpace.make(PeriodicGrid.make(lat, n), p)
        eps_in = args.eps_in if args.eps_in is not None else 13.0
        radius = args.radius if args.radius is not None else 0.25
        eps = dielectric_sphere(eps_in, 1.0, radius,
                                0.5 * lat.A.sum(axis=0), lat.A)
        op = BlochCurlCurl(sp, eps=eps, dtype=jnp.complex64)
        # Direct mean-twin pc: strictly dominates the round-3
        # inner-PCG variant under project-cheby deflation (round-4d
        # measurement, cli/bands_app.py make_solve_fn).
        solve_fn = op.make_solve_fn(deflation="project-cheby",
                                    precond="fastdiag",
                                    cheby_target=args.cheby_target)
        ngt = (2e-3 if args.near_gamma_tol is None
               else (args.near_gamma_tol or None))
        sweep = BandSweep(op, nev=args.nev,
                          block=args.block or args.nev + 6,
                          tol=args.tol, maxiter=args.maxiter or 250,
                          solve_fn=solve_fn,
                          device_tol=dtol_for(args, "field"),
                          restart_tol=args.restart_tol or None,
                          near_gamma_tol=ngt,
                          near_gamma_norm=0.15 * float(
                              np.linalg.norm(lat.B, axis=1).min()))
        metric = (f"k-point eigensolves/sec (CUB Maxwell G-X-M-R, "
                  f"eps={eps_in:g} sphere r={radius:g}a, "
                  f"{args.nev} bands, n={n} p={p}, solver tol "
                  f"{args.tol:g})")
        mmax, mult = None, None   # no analytic oracle for varying ε
        args.engine = "field"     # detail truth: varying ε can't use
        #                           the spectral engine (echoing the
        #                           flag default mislabeled BENCH runs)
    elif args.problem == "maxwell":
        from bravais_tpu.operators.curlcurl import BlochCurlCurl
        from bravais_tpu.spaces.nedelec import NedelecSpace
        n = args.n or 8
        p = args.p or 4   # n=8 p=4: 2.8e-8 eig err — true 1e-6-target
        # compliance (n=6 p=3 floors at 2.9e-5; n=12 p=3 at 4.4e-7)
        lat = make_lattice("FCC")
        kp = kpath(lat, npts=args.nk, path=[["G", "X", "W", "L"]])
        sp = NedelecSpace.make(PeriodicGrid.make(lat, n), p)
        op = BlochCurlCurl(sp, dtype=jnp.complex64)
        # Production Maxwell path (round 2): exact fast-diagonal
        # gradient projection + (A+sM)^-1 block preconditioner —
        # 11-20 LOBPCG iterations/k at every tested size (vs 126-256
        # on Jacobi in round 1, which also failed outright at n=8 p=3).
        if args.engine == "spectral":
            solve_fn = op.make_solve_fn(engine="spectral",
                                        pc_rep=args.pc_rep)
        else:
            solve_fn = op.make_solve_fn(deflation="project",
                                        precond="fastdiag")
        sweep = BandSweep(op, nev=args.nev,
                          block=args.block or args.nev + 6,
                          tol=args.tol, maxiter=args.maxiter or 250,
                          solve_fn=solve_fn,
                          device_tol=dtol_for(args, args.engine),
                          restart_tol=args.restart_tol or None)
        metric = (f"k-point eigensolves/sec (FCC Maxwell G-X-W-L, "
                  f"{args.nev} bands, n={n} p={p}; solver tol {args.tol:g},"
                  f" achieved eig err reported in detail)")
        mmax, mult = 3, 2
    elif args.problem == "rods2d":
        # Config 2 (BASELINE.json:8): 2D square lattice of dielectric
        # rods (ε=8.9, r=0.2a), TM polarization (α=1, β=ε on H1) —
        # the published-gap photonic-crystal workload
        # (tests/test_photonic2d.py gates the gap edges vs MPB).
        from bravais_tpu.operators.coefficients import dielectric_rod
        from bravais_tpu.operators.helmholtz import BlochHelmholtz
        from bravais_tpu.spaces.h1 import H1Space
        n = args.n or 16
        p = args.p or 3
        lat = make_lattice("SQR")
        kp = kpath(lat, npts=args.nk)
        sp = H1Space.make(PeriodicGrid.make(lat, n), p)
        eps_in = args.eps_in if args.eps_in is not None else 8.9
        radius = args.radius if args.radius is not None else 0.2
        eps = dielectric_rod(eps_in, 1.0, radius,
                             0.5 * lat.A.sum(axis=0), lat.A)
        op = BlochHelmholtz(sp, alpha=1.0, beta=eps,
                            dtype=jnp.complex64)
        sweep = BandSweep(op, nev=args.nev,
                          block=args.block or args.nev + 6,
                          tol=args.tol, maxiter=args.maxiter or 400,
                          device_tol=dtol_for(args, "field"),
                          restart_tol=args.restart_tol or None)
        metric = (f"k-point eigensolves/sec (2D SQR TM dielectric "
                  f"rods eps={eps_in:g} r={radius:g}a, {args.nev} "
                  f"bands, n={n} p={p}, tol {args.tol:g})")
        mmax, mult = None, None   # no analytic oracle for varying ε
        args.engine = "field"
    else:
        from bravais_tpu.operators.helmholtz import BlochHelmholtz
        from bravais_tpu.spaces.h1 import H1Space
        n = args.n or 16
        p = args.p or 4
        lat = make_lattice("SQR")
        kp = kpath(lat, npts=args.nk)
        sp = H1Space.make(PeriodicGrid.make(lat, n), p)
        op = BlochHelmholtz(sp, dtype=jnp.complex64)
        solve_fn = (op.make_solve_fn(engine="spectral")
                    if args.engine == "spectral" else None)
        sweep = BandSweep(op, nev=args.nev, tol=args.tol,
                          maxiter=args.maxiter or 400,
                          solve_fn=solve_fn,
                          device_tol=dtol_for(args, args.engine),
                          restart_tol=args.restart_tol or None)
        metric = (f"k-point eigensolves/sec (2D square scalar Helmholtz, "
                  f"{args.nev} bands, eig tol {args.tol:g}, n={n} p={p})")
        mmax, mult = 5, 1

    # Nudge exact-Γ points (Maxwell only — the measure-zero harmonic
    # point of the quasi-periodic formulation, curlcurl docstring; the
    # scalar problem has no Γ issue and the nudge creates a needlessly
    # hard near-degenerate cold start).
    kc = kp.k_cart.copy()
    if args.problem in ("maxwell", "dielectric"):
        for i in range(kc.shape[0]):
            if np.linalg.norm(kc[i]) < 1e-12:
                kc[i] = 2e-2 * lat.B[0]
    return types.SimpleNamespace(lat=lat, kp=kp, kc=kc, sp=sp, op=op,
                                 sweep=sweep, metric=metric, mmax=mmax,
                                 mult=mult)


def exact_bands(lat, k, nb, mmax, mult):
    """Lowest ``nb`` empty-lattice eigenvalues |k+G|² (App. B.3)."""
    import numpy as np
    vals = sorted(
        float(np.sum((np.asarray(k) + np.asarray(m) @ lat.B) ** 2))
        for m in itertools.product(range(-mmax, mmax + 1),
                                   repeat=lat.dim))
    return np.asarray(sorted(vals * mult)[:nb])


def eig_errors(cell, eigenvalues):
    """Per-k max relative eigenvalue error vs the analytic oracle, or
    None for cells without one."""
    import numpy as np
    if cell.mmax is None:
        return None
    errs = []
    for i in range(cell.kc.shape[0]):
        ex = exact_bands(cell.lat, cell.kc[i], eigenvalues.shape[1],
                         cell.mmax, cell.mult)
        errs.append(np.max(np.abs(eigenvalues[i] - ex))
                    / max(ex.max(), 1.0))
    return errs


def main(argv=None):
    args = parse_args(argv)

    import numpy as np
    import jax
    import jax.numpy as jnp

    from bravais_tpu.utils import runtime

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    runtime.setup_compile_cache()
    cell = make_cell(args)
    lat, kp, kc, sp, op, sweep = (cell.lat, cell.kp, cell.kc, cell.sp,
                                  cell.op, cell.sweep)

    def run_pass():
        if args.mode == "warm":
            return sweep.run_warm(kc)
        if args.mode == "warm-seg":
            return sweep.run_warm_sharded(kc, segments=args.segments)
        if args.mode == "warm-chain":
            return sweep.run_warm_chain(kc, chain=args.chain,
                                        precond=args.pc_mode)
        return sweep.run(kc, chunk=args.chunk or None)

    t_all = time.time()
    res = run_pass()
    # Steady-state k-points: wall_s excludes the first launch (compile);
    # warm mode launches per k, batched mode per chunk. Single-launch
    # batched runs (chunk >= nk) have NO steady launch — re-run the
    # (now compiled+cached) program and time that instead of emitting
    # the 1/1e-9 garbage rate. Same degenerate case for
    # warm-seg/warm-chain.
    first = (1 if args.mode == "warm" else
             args.segments if args.mode == "warm-seg" else
             args.chain if args.mode == "warm-chain" else
             (args.chunk or kp.nk))
    n_steady = max(kp.nk - first, 1)
    wall = res.wall_s
    degenerate = (args.mode in ("batched", "warm-seg", "warm-chain")
                  and first >= kp.nk)
    if degenerate:
        res2 = run_pass()
        wall = res2.compile_s + res2.wall_s  # pure execution (cached)
        n_steady = kp.nk
        res.wall_s = wall  # mutable dataclass; keeps detail consistent
    # Repeat passes, so a line carries its own variance band. Every
    # pass excludes
    # the same first launch(es), so pass rates are comparable; the
    # reported value is the MEDIAN.
    pass_walls = [max(wall, 1e-9)]
    for _ in range(max(args.repeats, 1) - 1):
        r2 = run_pass()
        w2 = (r2.compile_s + r2.wall_s) if degenerate else r2.wall_s
        pass_walls.append(max(w2, 1e-9))
    pass_rates = [n_steady / w for w in pass_walls]
    solves_per_sec = float(np.median(pass_rates))
    wall = float(np.median(pass_walls))
    total = time.time() - t_all

    # Accuracy vs the analytic empty-lattice oracle (App. B.3).
    errs = eig_errors(cell, res.eigenvalues)

    # Secondary metrics (SURVEY.md §6): HBM footprint + achieved FLOP/s
    # of the compiled per-k solve program.
    mem = jax.local_devices()[0].memory_stats() or {}
    flops_per_solve = None
    achieved_tflops = None
    hbm_program_bytes = None
    try:
        rdtype = np.dtype(op.rdtype)
        X0 = jnp.asarray(sweep._x0_np(
            getattr(sp, "field_shape", sp.dof_shape), rdtype))
        compiled = None
        per_launch = 1
        if args.mode == "warm" and sweep._jit_single is not None:
            compiled = (sweep._jit_single
                        .lower(X0, jnp.asarray(kc[0])).compile())
        elif args.mode == "warm-chain" and sweep._jit_chain is not None:
            per_launch = min(args.chain, kp.nk)
            compiled = (sweep._jit_chain
                        .lower(X0, jnp.asarray(kc[:per_launch]))
                        .compile())
        elif args.mode == "warm-seg" and sweep._jit_seg is not None:
            per_launch = args.segments
            X0s = jnp.asarray(np.broadcast_to(
                np.asarray(X0)[None], (per_launch,) + X0.shape).copy())
            compiled = (sweep._jit_seg
                        .lower(X0s, jnp.asarray(kc[:per_launch]))
                        .compile())
        elif sweep._jit_batched is not None:
            per_launch = min(args.chunk or kp.nk, kp.nk)
            compiled = (sweep._jit_batched
                        .lower(X0, jnp.asarray(kc[:per_launch]))
                        .compile())
        if compiled is not None:
            ca = compiled.cost_analysis()
            if isinstance(ca, (list, tuple)):
                ca = ca[0] if ca else {}
            fl = float(ca.get("flops", 0.0))
            flops_per_solve = (fl / per_launch) if fl else None
            try:
                ma = compiled.memory_analysis()
                hbm_program_bytes = int(
                    ma.temp_size_in_bytes + ma.argument_size_in_bytes
                    + ma.output_size_in_bytes)
            except Exception:
                pass
        if flops_per_solve and wall > 0:
            achieved_tflops = (flops_per_solve * n_steady / wall / 1e12)
    except Exception:
        pass
    # HBM peak: device memory_stats() (the GPU reports it); a platform
    # without stats (the CPU) reports the compiled program's own
    # footprint (temp+args+output), labelled as such.
    hbm_peak = mem.get("peak_bytes_in_use")
    hbm_peak_source = "memory_stats"
    if hbm_peak is None:
        hbm_peak = hbm_program_bytes
        hbm_peak_source = "memory_analysis(program)"
    # Accuracy self-check: a residual far above the stop
    # means at least one k exited on the stagnation/degeneration guard,
    # so the metric-line tolerance is NOT certified by this run.
    max_resid = float(np.max(res.residuals))
    stop = dtol_for(args, args.engine) or args.tol
    # The near-Γ loose stop is an INTENDED exit above the regular stop
    # (certified benign — see --near-gamma-tol); warn only above it.
    ngt_eff = getattr(sweep, "near_gamma_tol", None)
    if ngt_eff:
        stop = max(stop, ngt_eff)
    residual_warning = None
    if max_resid > 10 * stop:
        residual_warning = (
            f"max_residual {max_resid:.3g} exceeds 10x the device stop "
            f"{stop:g}: at least one k-point exited unconverged — "
            f"accuracy at the metric tol is NOT certified by this run")
        print("WARNING: " + residual_warning, file=sys.stderr)
    dev = runtime.device_info()
    peak, peak_note = runtime.peak_f32_tflops(dev["device_kind"])
    out = {
        "metric": cell.metric,
        "value": round(solves_per_sec, 4),
        "unit": "eigensolves/s",
        "vs_baseline": None,
        "detail": {
            "device": str(jax.devices()[0]),
            "platform": dev["platform"],
            "device_kind": dev["device_kind"],
            "device_count": dev["device_count"],
            "nvidia_smi": dev["nvidia_smi"],
            "nk": kp.nk,
            "dofs": sp.ndofs,
            "mode": args.mode,
            # Mode-specific knobs, so recorded A/B lines are
            # self-describing (round-4 A/B harness).
            "chain": (args.chain if args.mode == "warm-chain" else None),
            # EFFECTIVE pc mode (post engine-capability downgrade, read
            # back from the sweep) — recording the requested flag would
            # mislabel e.g. a scalar-engine --pc-mode batched run that
            # silently fell back to per-k (no build_pc hook).
            "pc_mode": (getattr(sweep, "_jit_chain_mode", args.pc_mode)
                        if args.mode == "warm-chain" else None),
            "segments": (args.segments if args.mode == "warm-seg"
                         else None),
            "restart_tol": (args.restart_tol or None
                            if args.mode == "batched" else None),
            "pc_rep": (args.pc_rep if args.engine == "spectral"
                       else None),
            "cheby_target": (args.cheby_target
                             if args.problem == "dielectric" else None),
            "device_tol": dtol_for(args, args.engine),
            "compile_s": round(res.compile_s, 2),
            "steady_wall_s": round(res.wall_s, 3),
            "total_wall_s": round(total, 2),
            "repeats": max(args.repeats, 1),
            "pass_rates": [round(r, 4) for r in pass_rates],
            "mean_lobpcg_iters": float(np.mean(res.iterations)),
            "iters_per_k": [int(i) for i in res.iterations],
            "max_rel_eig_err_vs_analytic": (
                float(np.max(errs)) if errs is not None else None),
            "max_residual": max_resid,
            "residual_per_k": [float(f"{float(np.max(r)):.3g}")
                               for r in np.atleast_2d(res.residuals)],
            "residual_warning": residual_warning,
            "near_gamma_tol": ngt_eff,
            "engine": args.engine,
            "hbm_peak_bytes": hbm_peak,
            "hbm_peak_source": hbm_peak_source,
            "hbm_program_bytes": hbm_program_bytes,
            "flops_per_eigensolve": flops_per_solve,
            "achieved_tflops": (round(achieved_tflops, 4)
                                if achieved_tflops else None),
            # XLA cost-model flops over steady wall, as a share of the
            # device kind's f32 peak (null, with the kind named, when
            # the kind has no peak on record).
            "pct_of_f32_peak": (
                round(100.0 * achieved_tflops / peak, 3)
                if achieved_tflops and peak else None),
            "peak_note": peak_note,
        },
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
