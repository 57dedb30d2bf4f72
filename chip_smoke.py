"""Smoke test of the band-structure path on the GPU.

    python chip_smoke.py             # one card: every phase below
    python chip_smoke.py --cards 4   # four cards: the sharded paths only

One process holds the card(s) and runs every phase in it, so each
phase's failure stops the script with a non-zero exit and no result
line. The first line names the card (nvidia-smi name and power limit);
each phase prints what it found; every timing line repeats the card.
The last line is one JSON object: ``{"ok": true, "device": {...}}``.

One card:
  1. platform and device check (fails at once off the GPU backend)
  2. headline: FCC Maxwell n=8 p=4, spectral engine, warm mode, nk=16 —
     max relative eigenvalue error vs the analytic empty lattice ≤ 1e-6
  3. config 3: CUB ε=13 sphere, field engine — refined eigenvalues at
     k-indices 5, 10, 15 within rtol 1e-6 of the same solve on the host
     CPU backend, in this process
  4. config 2: SQR TM rods ε=8.9 r=0.2a — TM gap edges inside the
     published gate 0.323 ± 0.015, 0.443 ± 0.020
  5. the CLI (bands_app) writes finite, ascending bands
  6. timings (recorded, never gated): each sweep's steady rate above,
     and the Rayleigh–Ritz jacobi_eigh vs jnp.linalg.eigh at 48×48
     complex64
  7. --precision f64 through the CLI on the card vs the dense complex128
     oracle to 1e-8 relative (last: it turns x64 on for the process)

Four cards (``--cards 4``): the headline sweep k-sharded over a 4-card
mesh vs one card (rtol 1e-6), and the Nédélec n=8 p=4 apply sharded
over the dof axis vs unsharded (relative L2 ≤ 1e-6), each checked to
have run on all four cards.

Each sweep runs one pass (no repeats), so a cold run stays within
minutes; the persistent compile cache makes reruns fast.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import tempfile
import time

import numpy as np

from bravais_tpu.utils import runtime

CARD = runtime.nvidia_smi() or "nvidia-smi unavailable"


def say(*parts):
    print(" | ".join(str(p) for p in parts), flush=True)


def timing(what, value, unit):
    say("timing", what, f"{value} {unit}", f"card: {CARD}")


def rel_close(a, b, rtol):
    """Max relative difference of eigenvalue rows ``a`` vs reference
    ``b``, asserted ≤ rtol. Each row's scale is floored at 1e-3 of its
    largest |value| (a zero eigenvalue has no relative error)."""
    a, b = np.atleast_2d(a).astype(np.float64), np.atleast_2d(b)
    scale = np.maximum(np.abs(b), 1e-3 * np.abs(b).max(axis=1,
                                                       keepdims=True))
    worst = float(np.max(np.abs(a - b) / scale))
    assert worst <= rtol, f"max relative difference {worst:.3g} > {rtol:g}"
    return worst


def uncut_bands(lam, rel=1e-4):
    """Bands below a degenerate cluster that the nev cut splits: a
    cluster at the top of the band table may be only partly found by
    another (equally valid) solve, so it is not compared."""
    n = len(lam)
    while n > 1 and abs(lam[n - 2] - lam[n - 1]) <= rel * abs(lam[n - 1]):
        n -= 1
    return n - 1 if n < len(lam) else n


def median_ms(fn, x, reps):
    """Median wall time of ``fn(x)`` over ``reps`` calls after a
    warm-up, each ended by block_until_ready."""
    import jax
    jax.block_until_ready(fn(x))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(x))
        ts.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(ts))


def devices_used(devs):
    """Per device: has any array ever been allocated on it (peak bytes
    in use > 0)?"""
    return [bool((d.memory_stats() or {}).get("peak_bytes_in_use"))
            for d in devs]


def steady_rate(res, nk):
    """Warm mode: every launch after the first (compile) is steady."""
    return round((nk - 1) / res.wall_s, 4)


# -- phases -------------------------------------------------------------------

def phase_platform(cards):
    import jax
    plat = jax.default_backend()
    if plat != "gpu":
        raise SystemExit(f"platform: JAX backend is {plat!r}, not 'gpu' "
                         f"— nothing to smoke-test")
    devs = jax.devices()
    if len(devs) < cards:
        raise SystemExit(f"platform: {len(devs)} GPU(s), need {cards}")
    say("platform", plat, devs[0].device_kind, f"{len(devs)} device(s)",
        f"compile cache {runtime.setup_compile_cache()}")


def phase_headline(bench):
    cell = bench.make_cell(bench.parse_args([]))
    res = cell.sweep.run_warm(cell.kc)
    err = float(np.max(bench.eig_errors(cell, res.eigenvalues)))
    say("headline", f"FCC Maxwell, {cell.sp.ndofs} dofs, "
        f"nk={cell.kp.nk}", f"max rel eig err vs analytic {err:.3g}",
        f"mean iters {float(np.mean(res.iterations)):.2f}",
        f"compile {res.compile_s:.1f} s")
    assert err <= 1e-6, f"headline eigenvalue error {err:.3g} > 1e-6"
    timing("headline steady sweep", steady_rate(res, cell.kp.nk),
           "eigensolves/s")


def phase_dielectric(bench):
    import jax
    args = bench.parse_args(["--problem", "dielectric"])
    idx = [5, 10, 15]
    cell = bench.make_cell(args)
    res = cell.sweep.run_warm(cell.kc)
    say("dielectric", f"CUB eps=13 sphere, {cell.sp.ndofs} dofs",
        f"mean iters {float(np.mean(res.iterations)):.2f}",
        f"max residual {float(np.max(res.residuals)):.3g}",
        f"compile {res.compile_s:.1f} s")
    timing("dielectric steady sweep", steady_rate(res, cell.kp.nk),
           "eigensolves/s")
    t0 = time.perf_counter()
    with jax.default_device(jax.devices("cpu")[0]):
        host = bench.make_cell(args)
        res_c = host.sweep.run_warm(host.kc[idx])
    nb = min(uncut_bands(res.eigenvalues[i]) for i in idx)
    worst = rel_close(res.eigenvalues[idx, :nb], res_c.eigenvalues[:, :nb],
                      1e-6)
    say("dielectric", f"card vs host CPU backend at k 5, 10, 15, "
        f"lowest {nb} bands", f"max rel diff {worst:.3g}",
        f"host solve {time.perf_counter() - t0:.1f} s")


def phase_rods2d(bench):
    cell = bench.make_cell(bench.parse_args(["--problem", "rods2d"]))
    res = cell.sweep.run_warm(cell.kc)
    f = np.sqrt(np.maximum(res.eigenvalues, 0.0)) / (2 * np.pi)
    bottom, top = float(f[:, 0].max()), float(f[:, 1].min())
    say("rods2d", f"SQR TM eps=8.9 r=0.2a, {cell.sp.ndofs} dofs",
        f"TM gap {bottom:.4f} .. {top:.4f} (gate 0.323±0.015, "
        f"0.443±0.020)", f"compile {res.compile_s:.1f} s")
    assert abs(bottom - 0.323) < 0.015, bottom
    assert abs(top - 0.443) < 0.020, top
    timing("rods2d steady sweep", steady_rate(res, cell.kp.nk),
           "eigensolves/s")


def _cli(argv, out):
    from bravais_tpu.cli.bands_app import main as cli_main
    cli_main(argv + ["--out", str(out)])
    man = json.loads((out / "manifest.json").read_text())
    ev = np.load(out / "bands.npz")["eigenvalues"]
    assert len(man["finished"]) == ev.shape[0], man["finished"]
    assert np.all(np.isfinite(ev)), "non-finite bands"
    assert np.all(np.diff(ev, axis=1) >= -1e-6 * np.abs(ev).max()), \
        "bands not ascending"
    return ev


def phase_cli(tmp):
    ev = _cli(["--lattice", "FCC", "--problem", "maxwell", "--n", "6",
               "--p", "3", "--nk", "8", "--nev", "10", "--path",
               "G,X,W,L"], tmp / "cli")
    say("cli", f"bands_app FCC maxwell n=6 p=3: bands {ev.shape}, "
        f"finite and ascending, lowest {float(ev.min()):.5g}")


def phase_rr_timing():
    import jax
    import jax.numpy as jnp
    from bravais_tpu.eigen.jacobi_eigh import jacobi_eigh
    from bravais_tpu.eigen.lobpcg import PROD_RR_TOL
    rng = np.random.default_rng(0)
    A = rng.standard_normal((48, 48)) + 1j * rng.standard_normal((48, 48))
    H = jnp.asarray((0.5 * (A + A.conj().T)).astype(np.complex64))
    for name, fn in (
            ("jacobi_eigh (rel_tol=PROD_RR_TOL)",
             lambda h: jacobi_eigh(h, rel_tol=PROD_RR_TOL)),
            ("jacobi_eigh (exact)", jacobi_eigh),
            ("jnp.linalg.eigh", jnp.linalg.eigh)):
        timing(f"Rayleigh-Ritz eigh 48x48 complex64: {name}",
               round(median_ms(jax.jit(fn), H, 50), 4), "ms")


def phase_f64(tmp):
    import jax
    from bravais_tpu.cli.bands_app import build_problem
    from bravais_tpu.cli.config import RunConfig
    from bravais_tpu.operators.dense import assemble_h1
    import scipy.linalg
    argv = ["--lattice", "SQR", "--problem", "tm", "--eps-in", "8.9",
            "--radius", "0.2", "--n", "8", "--p", "2", "--nk", "4",
            "--nev", "6", "--precision", "f64", "--tol", "1e-9"]
    ev = _cli(argv, tmp / "f64")
    assert jax.default_backend() == "gpu" and jax.config.jax_enable_x64
    ap = argparse.ArgumentParser()
    RunConfig.add_cli_args(ap)
    lat, kp, op = build_problem(RunConfig.from_cli_args(ap.parse_args(argv)))
    worst = 0.0
    for i, k in enumerate(kp.k_cart):
        A, M = assemble_h1(op.space, k, alpha=op._alpha_fn,
                           beta=op._beta_fn)
        exact = scipy.linalg.eigh(A, M, eigvals_only=True)[:ev.shape[1]]
        worst = max(worst, rel_close(ev[i], exact, 1e-8))
    say("f64", f"SQR TM n=8 p=2 complex128 on {jax.devices()[0].platform}",
        f"max rel err vs dense complex128 oracle {worst:.3g}")


def phase_cards4(bench):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from bravais_tpu.lattices import make_lattice
    from bravais_tpu.meshing.grid import PeriodicGrid
    from bravais_tpu.operators.curlcurl import BlochCurlCurl
    from bravais_tpu.parallel.mesh import kpoint_mesh
    from bravais_tpu.spaces.nedelec import NedelecSpace

    devs = jax.devices()[:4]

    args = bench.parse_args([])
    one = bench.make_cell(args)
    res1 = one.sweep.run_warm(one.kc)
    before = devices_used(devs)
    four = bench.make_cell(args)
    res4 = four.sweep.run_warm_sharded(four.kc, kpoint_mesh(devs))
    after = devices_used(devs)
    nb = min(uncut_bands(lam) for lam in res1.eigenvalues)
    worst = rel_close(res4.eigenvalues[:, :nb], res1.eigenvalues[:, :nb],
                      1e-6)
    assert all(after), f"devices without work after the sharded sweep: " \
        f"{after} (before: {before})"
    say("cards4", "headline sweep k-sharded over 4 cards vs one card",
        f"max rel diff {worst:.3g}", f"devices used {after}")
    timing("headline sweep, one card (warm)", steady_rate(res1, one.kp.nk),
           "eigensolves/s")
    per = -(-four.kp.nk // len(devs))    # launches; the first compiles
    timing("headline sweep, 4 cards (4 warm segments)",
           round(len(devs) * (per - 1) / res4.wall_s, 4), "eigensolves/s")

    lat = make_lattice("FCC")
    op = BlochCurlCurl(NedelecSpace.make(PeriodicGrid.make(lat, 8), 4),
                       dtype=jnp.complex64)
    rng = np.random.default_rng(0)
    shp = op.space.field_shape
    u = (rng.standard_normal(shp) + 1j * rng.standard_normal(shp)
         ).astype(np.complex64)
    k = jnp.asarray(lat.k_cart((0.25, 0.0, 0.25)), jnp.float32)
    apply = jax.jit(op.apply_A)
    y1 = np.asarray(apply(jnp.asarray(u), k))
    shard = NamedSharding(Mesh(np.asarray(devs), ("x",)),
                          P(None, "x", None, None))
    yd = jax.jit(op.apply_A, in_shardings=(shard, None),
                 out_shardings=shard)(jax.device_put(u, shard), k)
    spread = sorted({s.device.id for s in yd.addressable_shards})
    err = float(np.linalg.norm(np.asarray(yd) - y1) / np.linalg.norm(y1))
    say("cards4", "Nedelec n=8 p=4 apply_A dof-sharded over 4 cards vs "
        "unsharded", f"rel L2 {err:.3g}", f"shards on devices {spread}")
    assert err <= 1e-6, err
    assert len(spread) == 4, spread


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, choices=[1, 4], default=1)
    args = ap.parse_args(argv)
    say("card", CARD)

    import jax
    plat = os.environ.get("JAX_PLATFORMS")
    if plat and "cpu" not in plat.split(","):
        # phase 4 compares with the host CPU backend in this process
        jax.config.update("jax_platforms", plat + ",cpu")
    phase_platform(args.cards)
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    import bench

    if args.cards == 4:
        phase_cards4(bench)
    else:
        phase_headline(bench)
        phase_dielectric(bench)
        phase_rods2d(bench)
        with tempfile.TemporaryDirectory() as d:
            phase_cli(pathlib.Path(d))
            phase_rr_timing()
            phase_f64(pathlib.Path(d))
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
