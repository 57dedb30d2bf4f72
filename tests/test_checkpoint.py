"""Crash-safe checkpointing + combined warm/sharded sweep regime
(SURVEY.md §5 checkpoint/resume; App. C.5 combined regime)."""

import json
import os
import pathlib
import signal
import subprocess
import sys
import time

import numpy as np
import jax.numpy as jnp
import pytest

from bravais_tpu.bands import BandSweep, BandWriter, save_modes
from bravais_tpu.lattices import kpath, make_lattice
from bravais_tpu.meshing.grid import PeriodicGrid
from bravais_tpu.operators.helmholtz import BlochHelmholtz
from bravais_tpu.spaces.h1 import H1Space

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _problem(n=8, p=2):
    lat = make_lattice("SQR")
    sp = H1Space.make(PeriodicGrid.make(lat, n), p)
    return lat, BlochHelmholtz(sp, dtype=jnp.complex128)


def test_run_writes_every_chunk(tmp_path):
    lat, op = _problem()
    kp = kpath(lat, npts=6)
    sweep = BandSweep(op, nev=2, block=4, tol=1e-6, maxiter=60)
    writer = BandWriter(tmp_path, {"c": 1}, kp.nk, 2)
    sweep.run(kp.k_cart, chunk=2, writer=writer)
    assert writer.finished == list(range(kp.nk))
    # reload from disk: all rows present
    dat = np.load(tmp_path / "bands.npz")
    assert np.all(np.isfinite(dat["eigenvalues"]))


def test_warm_writes_every_k_and_resume_skips(tmp_path):
    lat, op = _problem()
    kp = kpath(lat, npts=5)
    sweep = BandSweep(op, nev=2, block=4, tol=1e-6, maxiter=60)
    writer = BandWriter(tmp_path, {"c": 2}, kp.nk, 2)
    # interrupt after 3 k-points by raising from a wrapped writer
    calls = []
    orig = writer.write_chunk

    def boom(idx, *a):
        orig(idx, *a)
        calls.append(list(idx))
        if len(calls) == 3:
            raise KeyboardInterrupt

    writer.write_chunk = boom
    with pytest.raises(KeyboardInterrupt):
        sweep.run_warm(kp.k_cart, writer=writer)
    # three k-points are ON DISK despite the crash
    w2 = BandWriter(tmp_path, {"c": 2}, kp.nk, 2)
    done = w2.try_resume()
    assert done == [0, 1, 2]
    # resume completes only the remainder
    todo = [i for i in range(kp.nk) if i not in done]
    sweep2 = BandSweep(op, nev=2, block=4, tol=1e-6, maxiter=60)
    sweep2.run_warm(kp.k_cart[todo], writer=w2,
                    k_index=np.asarray(todo))
    assert w2.finished == list(range(kp.nk))


@pytest.mark.slow
def test_warm_sharded_matches_warm():
    import jax
    lat, op = _problem()
    kp = kpath(lat, npts=10)
    from bravais_tpu.parallel.mesh import kpoint_mesh
    mesh = kpoint_mesh(jax.devices()[:4])
    s1 = BandSweep(op, nev=3, block=5, tol=1e-9, maxiter=80)
    s2 = BandSweep(op, nev=3, block=5, tol=1e-9, maxiter=80)
    r_warm = s1.run_warm(kp.k_cart)
    r_shard = s2.run_warm_sharded(kp.k_cart, mesh)
    assert r_shard.eigenvalues.shape == r_warm.eigenvalues.shape
    assert np.allclose(r_shard.eigenvalues, r_warm.eigenvalues,
                       rtol=1e-7, atol=1e-9)


def test_cli_kill9_then_resume(tmp_path):
    """The crash-safety acceptance test: SIGKILL a sweep mid-run,
    rerun with --resume, and only unfinished k-points recompute."""
    out = tmp_path / "run"
    args = [sys.executable, "-m", "bravais_tpu.cli.bands_app",
            "--lattice", "SQR", "--problem", "scalar", "--n", "8",
            "--p", "2", "--nk", "6", "--nev", "2", "--tol", "1e-6",
            "--precision", "f64", "--maxiter", "60",
            "--out", str(out), "--resume"]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get(
                   "PYTHONPATH", ""))
    proc = subprocess.Popen(args, cwd=REPO, env=env,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    manifest = out / "manifest.json"
    # wait until at least 2 k-points are checkpointed, then SIGKILL
    deadline = time.time() + 300
    while time.time() < deadline:
        if proc.poll() is not None:
            break  # finished before we killed it — resume is then a no-op
        if manifest.exists():
            try:
                fin = json.loads(manifest.read_text())["finished"]
            except (json.JSONDecodeError, KeyError):
                fin = []
            if len(fin) >= 2:
                proc.send_signal(signal.SIGKILL)
                proc.wait()
                break
        time.sleep(0.2)
    else:
        proc.kill()
        pytest.fail("sweep never checkpointed within 300s")
    fin_before = json.loads(manifest.read_text())["finished"]
    assert len(fin_before) >= 2
    # resume: must complete, recomputing ONLY the remainder
    r = subprocess.run(args, cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    solved = [json.loads(line) for line in r.stdout.splitlines()
              if line.startswith("{")]
    solved_idx = sorted(s["k_index"] for s in solved)
    assert solved_idx == [i for i in range(6) if i not in fin_before]
    fin_after = json.loads(manifest.read_text())["finished"]
    assert fin_after == list(range(6))
    assert np.all(np.isfinite(np.load(out / "bands.npz")["eigenvalues"]))


def test_save_modes_roundtrip(tmp_path):
    lat, op = _problem(n=6, p=1)
    kp = kpath(lat, npts=4)
    sweep = BandSweep(op, nev=2, block=4, tol=1e-8, maxiter=80,
                      keep_vectors=True)
    res = sweep.run_warm(kp.k_cart)
    assert res.eigenvectors is not None
    assert res.eigenvectors.shape[:3] == (kp.nk, 2, 2)
    p = save_modes(tmp_path, 1, kp.k_cart[1], res.eigenvalues[1],
                   res.eigenvectors[1])
    dat = np.load(p)
    X = dat["X_reim"][0] + 1j * dat["X_reim"][1]
    # the saved mode satisfies the eigen-equation
    x = jnp.asarray(X[0])
    k = jnp.asarray(kp.k_cart[1])
    lam = float(dat["eigenvalues"][0])
    r = op.apply_A(x, k) - lam * op.apply_M(x)
    nrm = float(jnp.linalg.norm(op.apply_M(x)))
    assert float(jnp.linalg.norm(r)) <= 1e-6 * max(abs(lam), 1.0) * nrm


def test_write_vtk(tmp_path):
    from bravais_tpu.bands import write_vtk
    lat, op = _problem(n=4, p=1)
    f = np.random.default_rng(0).standard_normal(op.space.dof_shape)
    p = write_vtk(tmp_path / "m.vtk", op.space.grid, {"mode0": f})
    txt = pathlib.Path(p).read_text()
    assert "STRUCTURED_GRID" in txt and "SCALARS mode0" in txt
    assert f"POINT_DATA {f.size}" in txt


@pytest.mark.slow
def test_warm_sharded_maxwell_spectral():
    """App C.5 combined regime with the Maxwell SPECTRAL engine (the
    5-output support-carrying solve): segment-sharded warm sweep must
    match the sequential warm sweep, exercising the sharded support
    array + spectral refine path."""
    import jax
    from bravais_tpu.operators.curlcurl import BlochCurlCurl
    from bravais_tpu.spaces.nedelec import NedelecSpace
    from bravais_tpu.parallel.mesh import kpoint_mesh

    lat = make_lattice("FCC")
    sp = NedelecSpace.make(PeriodicGrid.make(lat, 3), 2)
    op = BlochCurlCurl(sp, dtype=jnp.complex64)
    kf = [(0.25, 0.0, 0.25), (0.3, 0.05, 0.3), (0.5, 0.25, 0.75),
          (0.45, 0.2, 0.6), (0.4, 0.3, 0.5), (0.5, 0.5, 0.5),
          (0.2, 0.1, 0.15), (0.35, 0.15, 0.4)]
    ks = np.asarray([lat.k_cart(f) for f in kf], np.float32)
    mk = lambda: BandSweep(op, nev=4, block=8, tol=1e-6, maxiter=150,
                           solve_fn=op.make_solve_fn(engine="spectral"))
    r_warm = mk().run_warm(ks)
    mesh = kpoint_mesh(jax.devices()[:4])
    r_shard = mk().run_warm_sharded(ks, mesh)
    assert np.max(r_warm.residuals) < 1e-9      # spectral refine used
    assert np.max(r_shard.residuals) < 1e-9
    # Near-degenerate multiplets are split at the ~1e-7 discretization
    # level and different LOBPCG trajectories may surface different
    # members; values agree to that level, not to f64 machine.
    np.testing.assert_allclose(r_shard.eigenvalues, r_warm.eigenvalues,
                               rtol=1e-6, atol=1e-9)
