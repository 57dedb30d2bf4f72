"""k-sweep tests: batched/sharded (8 virtual CPU devices — the rebuild's
distributed-testing mechanism, SURVEY.md §4.2 item 4), warm starts, and
checkpoint/resume."""

import pytest
import jax
import jax.numpy as jnp
import numpy as np
import scipy.linalg

from bravais_tpu.bands import BandSweep, BandWriter
from bravais_tpu.lattices import kpath, make_lattice
from bravais_tpu.meshing.grid import PeriodicGrid
from bravais_tpu.operators.dense import assemble_h1
from bravais_tpu.operators.helmholtz import BlochHelmholtz
from bravais_tpu.parallel.mesh import kpoint_mesh
from bravais_tpu.spaces.h1 import H1Space


def _setup(n=6, p=2, dtype=jnp.complex128):
    lat = make_lattice("SQR")
    sp = H1Space.make(PeriodicGrid.make(lat, n), p)
    return lat, BlochHelmholtz(sp, dtype=dtype)


def _dense_bands(op, k, nev):
    A, M = assemble_h1(op.space, k)
    return scipy.linalg.eigh(A, M, eigvals_only=True)[:nev]


def test_sweep_batched_matches_dense():
    lat, op = _setup()
    kp = kpath(lat, npts=6)
    sweep = BandSweep(op, nev=3, block=6, tol=1e-9, maxiter=200)
    res = sweep.run(kp.k_cart)
    assert res.eigenvalues.shape == (kp.nk, 3)
    for i in range(kp.nk):
        exact = _dense_bands(op, kp.k_cart[i], 3)
        np.testing.assert_allclose(res.eigenvalues[i], exact, rtol=1e-7,
                                   atol=1e-7)


def test_sweep_sharded_8dev():
    """Same sweep under an 8-device mesh — must give identical physics."""
    assert jax.device_count() >= 8
    lat, op = _setup()
    kp = kpath(lat, npts=10)  # not a multiple of 8 -> exercises padding
    mesh = kpoint_mesh(jax.devices()[:8])
    sweep = BandSweep(op, nev=3, block=6, tol=1e-9, maxiter=200)
    res = sweep.run(kp.k_cart, mesh=mesh)
    ref = BandSweep(op, nev=3, block=6, tol=1e-9, maxiter=200).run(kp.k_cart)
    np.testing.assert_allclose(res.eigenvalues, ref.eigenvalues, rtol=1e-9,
                               atol=1e-9)


def test_sweep_warm_start_fewer_iterations():
    lat, op = _setup(n=8, p=2)
    # Densely sampled short leg -> adjacent k very close.
    kp = kpath(lat, npts=8, path=[["G", "X"]])
    cold = BandSweep(op, nev=3, block=6, tol=1e-8, maxiter=300)
    warm = BandSweep(op, nev=3, block=6, tol=1e-8, maxiter=300)
    rc = cold.run(kp.k_cart)
    rw = warm.run_warm(kp.k_cart)
    np.testing.assert_allclose(rw.eigenvalues, rc.eigenvalues, rtol=1e-6,
                               atol=1e-7)
    # Ignore the first k (identical start); warm starts should cut the
    # average iteration count substantially.
    assert rw.iterations[1:].mean() < 0.7 * rc.iterations[1:].mean()


def test_band_writer_resume(tmp_path):
    cfg = {"lattice": "SQR", "p": 2}
    w = BandWriter(tmp_path / "run", cfg, nk=6, nev=3)
    assert w.try_resume() == []
    w.write_chunk([0, 1, 2], np.ones((3, 3)), [5, 6, 7], np.zeros((3, 3)))
    # New writer with same config resumes.
    w2 = BandWriter(tmp_path / "run", cfg, nk=6, nev=3)
    assert w2.try_resume() == [0, 1, 2]
    np.testing.assert_allclose(w2.eigenvalues[:3], 1.0)
    assert np.isnan(w2.eigenvalues[3]).all()
    # Different config does NOT resume.
    w3 = BandWriter(tmp_path / "run", {"lattice": "HEX"}, nk=6, nev=3)
    assert w3.try_resume() == []


def test_plot_bands(tmp_path):
    from bravais_tpu.bands import plot_bands
    lat, _ = _setup()
    kp = kpath(lat, npts=12)
    vals = np.linspace(0, 2, 12)[:, None] + np.arange(3)[None, :]
    out = plot_bands(kp, vals, path=tmp_path / "bands.png")
    assert (tmp_path / "bands.png").exists()


def test_write_csv(tmp_path):
    from bravais_tpu.bands.io import write_csv
    lat, _ = _setup()
    kp = kpath(lat, npts=8)
    vals = np.linspace(0, 2, kp.nk)[:, None] + np.arange(3)[None, :]
    p = tmp_path / "bands.csv"
    write_csv(p, kp, vals)
    lines = p.read_text().strip().splitlines()
    assert len(lines) == kp.nk + 1
    assert lines[0].startswith("dist,kfrac0,kfrac1,band0")


def test_warm_sharded_keep_vectors():
    """run_warm_sharded must honor keep_vectors (round-2 verdict: it
    silently dropped eigenvectors, so --save-modes + warm + shard did
    less than asked). The returned modes must satisfy the eigen
    equation of their k-point."""
    lat, op = _setup(n=6, p=2)
    kp = kpath(lat, npts=10)
    mesh = kpoint_mesh(jax.devices()[:8])
    sweep = BandSweep(op, nev=2, block=6, tol=1e-9, maxiter=200,
                      keep_vectors=True)
    res = sweep.run_warm_sharded(kp.k_cart, mesh)
    assert res.eigenvectors is not None
    assert res.eigenvectors.shape[:3] == (kp.nk, 2, 2)
    for i in range(0, kp.nk, 3):
        k = jnp.asarray(kp.k_cart[i])
        v = res.eigenvectors[i][0] + 1j * res.eigenvectors[i][1]
        for j in range(2):
            x = jnp.asarray(v[j])
            Av = np.asarray(op.apply_A(x, k))
            Mv = np.asarray(op.apply_M(x))
            lam = res.eigenvalues[i, j]
            r = np.linalg.norm(Av - lam * Mv)
            assert r < 1e-6 * max(abs(lam), 1.0) * np.linalg.norm(Mv), (
                i, j, r)


def test_warm_seg_single_device():
    """run_warm_sharded without a mesh = vmapped warm chains on one
    device (the latency-amortizing single-chip regime); physics must
    match the batched reference."""
    lat, op = _setup(n=6, p=2)
    kp = kpath(lat, npts=10)
    sweep = BandSweep(op, nev=3, block=6, tol=1e-9, maxiter=200)
    res = sweep.run_warm_sharded(kp.k_cart, segments=4)
    ref = BandSweep(op, nev=3, block=6, tol=1e-9, maxiter=200).run(
        kp.k_cart)
    np.testing.assert_allclose(res.eigenvalues, ref.eigenvalues,
                               rtol=1e-9, atol=1e-9)


def test_warm_chain_matches_batched():
    """run_warm_chain (sequential in-launch chaining — the launch-
    overhead-amortizing single-chip regime, round 4) must match the
    batched reference, including the ragged final chain."""
    lat, op = _setup(n=6, p=2)
    kp = kpath(lat, npts=10)  # 10 % 4 != 0 -> exercises padding
    sweep = BandSweep(op, nev=3, block=6, tol=1e-9, maxiter=200)
    res = sweep.run_warm_chain(kp.k_cart, chain=4)
    ref = BandSweep(op, nev=3, block=6, tol=1e-9, maxiter=200).run(
        kp.k_cart)
    np.testing.assert_allclose(res.eigenvalues, ref.eigenvalues,
                               rtol=1e-9, atol=1e-9)
    assert res.iterations.shape == (kp.nk,)


def test_warm_chain_keep_vectors_and_writer(tmp_path):
    """Chain mode honors keep_vectors (modes satisfy their eigen
    equation) and the per-k checkpoint writer."""
    lat, op = _setup(n=6, p=2)
    kp = kpath(lat, npts=6)
    w = BandWriter(tmp_path / "run", nev=2, nk=kp.nk, config={"t": 1})
    sweep = BandSweep(op, nev=2, block=6, tol=1e-9, maxiter=200,
                      keep_vectors=True)
    res = sweep.run_warm_chain(kp.k_cart, chain=3, writer=w)
    assert res.eigenvectors is not None
    assert res.eigenvectors.shape[:3] == (kp.nk, 2, 2)
    for i in range(0, kp.nk, 2):
        k = jnp.asarray(kp.k_cart[i])
        v = res.eigenvectors[i][0] + 1j * res.eigenvectors[i][1]
        for j in range(2):
            x = jnp.asarray(v[j])
            Av = np.asarray(op.apply_A(x, k))
            Mv = np.asarray(op.apply_M(x))
            lam = res.eigenvalues[i, j]
            r = np.linalg.norm(Av - lam * Mv)
            assert r < 1e-6 * max(abs(lam), 1.0) * np.linalg.norm(Mv), (
                i, j, r)
    assert sorted(w.finished) == list(range(kp.nk))
    np.testing.assert_allclose(w.eigenvalues, res.eigenvalues,
                               rtol=1e-12, atol=1e-12)


def test_warm_chain_spectral_pc_reuse():
    """Chain mode with the spectral engine reuses one per-launch
    preconditioner (built at the chain's middle k). Physics must match
    the per-k warm reference — the preconditioner only affects the
    iteration path, never the converged eigenvalues."""
    import jax.numpy as jnp

    from bravais_tpu.operators.curlcurl import BlochCurlCurl
    from bravais_tpu.spaces.nedelec import NedelecSpace

    lat = make_lattice("FCC")
    sp = NedelecSpace.make(PeriodicGrid.make(lat, 3), 2)
    op = BlochCurlCurl(sp, dtype=jnp.complex128)
    kp = kpath(lat, npts=6, path=[["G", "X", "W"]])
    kc = kp.k_cart.copy()
    for i in range(kc.shape[0]):
        if np.linalg.norm(kc[i]) < 1e-12:
            kc[i] = 2e-2 * lat.B[0]

    def mk():
        return BandSweep(op, nev=4, block=8, tol=1e-8, maxiter=200,
                         solve_fn=op.make_solve_fn(engine="spectral"))

    res = mk().run_warm_chain(kc, chain=3, reuse_precond=True)
    ref = mk().run_warm(kc)
    np.testing.assert_allclose(res.eigenvalues, ref.eigenvalues,
                               rtol=1e-8, atol=1e-10)


def test_warm_chain_batched_pc_matches_per_k():
    """precond='batched' builds every chain k's EXACT preconditioner in
    one vmapped batched-Cholesky call before the scan (the per-k pc
    build is a latency-bound setup term).
    Unlike 'chain-mid' staleness this changes nothing numerically: the
    iteration path and eigenvalues must match the per-k build exactly."""
    import jax.numpy as jnp

    from bravais_tpu.operators.curlcurl import BlochCurlCurl
    from bravais_tpu.spaces.nedelec import NedelecSpace

    lat = make_lattice("FCC")
    sp = NedelecSpace.make(PeriodicGrid.make(lat, 3), 2)
    op = BlochCurlCurl(sp, dtype=jnp.complex128)
    kp = kpath(lat, npts=7, path=[["G", "X", "W"]])  # 7 % 3 -> padding
    kc = kp.k_cart.copy()
    for i in range(kc.shape[0]):
        if np.linalg.norm(kc[i]) < 1e-12:
            kc[i] = 2e-2 * lat.B[0]

    def mk():
        return BandSweep(op, nev=4, block=8, tol=1e-8, maxiter=200,
                         solve_fn=op.make_solve_fn(engine="spectral"))

    res = mk().run_warm_chain(kc, chain=3, precond="batched")
    ref = mk().run_warm_chain(kc, chain=3)            # per-k build
    np.testing.assert_allclose(res.eigenvalues, ref.eigenvalues,
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(res.iterations, ref.iterations)


def test_warm_chain_batched_setup_matches_per_k():
    """precond='batched-setup' hoists the FULL per-k setup (TA/TM/TG
    stencil blocks + gradient-projector factor + preconditioner) into
    one vmapped pre-scan build (round-4: STATUS §6 gap 1 — the whole
    ~85 ms/k latency-bound setup, not just the pc's 45 ms). Purely a
    scheduling change: the iteration path and eigenvalues must match
    the per-k build exactly."""
    import jax.numpy as jnp

    from bravais_tpu.operators.curlcurl import BlochCurlCurl
    from bravais_tpu.spaces.nedelec import NedelecSpace

    lat = make_lattice("FCC")
    sp = NedelecSpace.make(PeriodicGrid.make(lat, 3), 2)
    op = BlochCurlCurl(sp, dtype=jnp.complex128)
    kp = kpath(lat, npts=7, path=[["G", "X", "W"]])  # 7 % 3 -> padding
    kc = kp.k_cart.copy()
    for i in range(kc.shape[0]):
        if np.linalg.norm(kc[i]) < 1e-12:
            kc[i] = 2e-2 * lat.B[0]

    def mk():
        return BandSweep(op, nev=4, block=8, tol=1e-8, maxiter=200,
                         solve_fn=op.make_solve_fn(engine="spectral"))

    res = mk().run_warm_chain(kc, chain=3, precond="batched-setup")
    ref = mk().run_warm_chain(kc, chain=3)            # per-k build
    np.testing.assert_allclose(res.eigenvalues, ref.eigenvalues,
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(res.iterations, ref.iterations)


@pytest.mark.slow
def test_warm_chain_field_dielectric_matches_warm():
    """The VARYING-ε field engine through run_warm_chain (the config-3
    A/B configuration, bench.py --problem dielectric --mode warm-chain)
    must match run_warm: same production path (project-cheby +
    direct mean-twin fastdiag pc + f64 host RR refine), chained
    inside one launch vs
    per-k launches. Gates the chain flow's no-support (host-RR) refine
    branch, which no other test exercised with varying ε."""
    import jax.numpy as jnp

    from bravais_tpu.operators.coefficients import dielectric_sphere
    from bravais_tpu.operators.curlcurl import BlochCurlCurl
    from bravais_tpu.spaces.nedelec import NedelecSpace

    lat = make_lattice("CUB")
    grid = PeriodicGrid.make(lat, 4)
    center = 0.5 * lat.A.sum(axis=0)
    eps = dielectric_sphere(13.0, 1.0, 0.25, center, lat.A, 0.0)
    sp = NedelecSpace.make(grid, 2)
    kp = kpath(lat, npts=5, path=[["G", "X"]])
    kc = kp.k_cart.copy()
    for i in range(kc.shape[0]):
        if np.linalg.norm(kc[i]) < 1e-12:
            kc[i] = 2e-2 * lat.B[0]

    def mk():
        op = BlochCurlCurl(sp, eps=eps, dtype=jnp.complex64)
        solve = op.make_solve_fn(deflation="project-cheby",
                                 precond="fastdiag")
        return BandSweep(op, nev=4, block=8, tol=1e-6, maxiter=250,
                         solve_fn=solve, device_tol=1e-4)

    res = mk().run_warm_chain(kc, chain=2)
    ref = mk().run_warm(kc)
    # Both ends are f64-refined Rayleigh quotients of (slightly
    # different) converged f32 device subspaces — agreement is set by
    # the refine's certified accuracy, not bit-identical paths.
    np.testing.assert_allclose(res.eigenvalues, ref.eigenvalues,
                               rtol=2e-6)
    assert np.max(res.residuals) < 1e-3
    assert res.iterations.shape == (kp.nk,)


def test_spectral_pc_rep_factor_matches_inv():
    """pc_rep='factor' (keep the triangular factor of A+sM; two
    triangular solves per preconditioner application) vs the default
    explicit block inverse: a representation change only — eigenvalues
    must match."""
    from bravais_tpu.operators.curlcurl import BlochCurlCurl
    from bravais_tpu.spaces.nedelec import NedelecSpace

    lat = make_lattice("FCC")
    sp = NedelecSpace.make(PeriodicGrid.make(lat, 3), 2)
    op = BlochCurlCurl(sp, dtype=jnp.complex128)
    kp = kpath(lat, npts=4, path=[["G", "X"]])
    kc = kp.k_cart.copy()
    for i in range(kc.shape[0]):
        if np.linalg.norm(kc[i]) < 1e-12:
            kc[i] = 2e-2 * lat.B[0]

    def mk(rep):
        return BandSweep(op, nev=4, block=8, tol=1e-9, maxiter=200,
                         solve_fn=op.make_solve_fn(engine="spectral",
                                                   pc_rep=rep))

    res = mk("factor").run_warm(kc)
    ref = mk("inv").run_warm(kc)
    np.testing.assert_allclose(res.eigenvalues, ref.eigenvalues,
                               rtol=1e-9, atol=1e-10)
    assert np.max(res.residuals) < 1e-8


def test_batched_restart_matches_single_phase():
    """restart_tol (two-phase batched solve: loose phase 1, restarted
    phase 2 in the same launch) is a scheduling change — eigenvalues
    must match the single-phase batched solve; reported iterations are
    the phase sum."""
    lat, op = _setup(n=6, p=2)
    kp = kpath(lat, npts=6)
    res = BandSweep(op, nev=3, block=6, tol=1e-9, maxiter=200,
                    restart_tol=1e-3).run(kp.k_cart)
    ref = BandSweep(op, nev=3, block=6, tol=1e-9, maxiter=200).run(
        kp.k_cart)
    np.testing.assert_allclose(res.eigenvalues, ref.eigenvalues,
                               rtol=1e-9, atol=1e-9)
    assert np.max(res.residuals) < 1e-9
    assert res.iterations.shape == (kp.nk,)


def test_warm_chain_rebuilds_on_chain_or_mode_change():
    """ONE BandSweep instance reconfigured across run_warm_chain calls
    must rebuild its cached chain program (round-4e review): the jitted
    closure captures the chain int and pc mode, so a chain-mid program
    reused at a shorter chain indexes ks[old_chain//2] — silently
    CLAMPED by XLA to the last k, i.e. a wrong-k preconditioner — and a
    stale mode would re-run the previous configuration, corrupting
    in-process A/B measurements. Every reconfigured call must match a
    fresh instance exactly (eigenvalues AND iteration path)."""
    import jax.numpy as jnp

    from bravais_tpu.operators.curlcurl import BlochCurlCurl
    from bravais_tpu.spaces.nedelec import NedelecSpace

    lat = make_lattice("FCC")
    sp = NedelecSpace.make(PeriodicGrid.make(lat, 3), 2)
    op = BlochCurlCurl(sp, dtype=jnp.complex128)
    kp = kpath(lat, npts=8, path=[["G", "X", "W"]])
    kc = kp.k_cart.copy()
    for i in range(kc.shape[0]):
        if np.linalg.norm(kc[i]) < 1e-12:
            kc[i] = 2e-2 * lat.B[0]

    def mk():
        return BandSweep(op, nev=4, block=8, tol=1e-8, maxiter=200,
                         solve_fn=op.make_solve_fn(engine="spectral"))

    sweep = mk()  # ONE instance driven through three configurations
    seq = [dict(chain=4, precond="chain-mid"),
           dict(chain=2, precond="chain-mid"),  # shorter chain, same mode
           dict(chain=4, precond="batched")]    # mode change
    for cfg in seq:
        res = sweep.run_warm_chain(kc, **cfg)
        ref = mk().run_warm_chain(kc, **cfg)
        np.testing.assert_allclose(res.eigenvalues, ref.eigenvalues,
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_array_equal(res.iterations, ref.iterations)


def test_warm_near_gamma_loose_stop():
    """near_gamma_tol (round 5): k-points inside |k| < near_gamma_norm
    use a looser DEVICE stop (the f32 exact-deflation roundoff floor
    near Γ sits above the production field stop and the f64 refine is
    certified to recover from those exits — STATUS §0d-cert). Gates:
    (a) refined eigenvalues match the tight-stop control to the
    refine's accuracy, (b) the near-Γ point does not iterate MORE than
    the control, (c) one compiled program serves both tolerance values
    (tol is traced, not baked — no per-k retrace)."""
    import jax.numpy as jnp

    from bravais_tpu.operators.coefficients import dielectric_sphere
    from bravais_tpu.operators.curlcurl import BlochCurlCurl
    from bravais_tpu.spaces.nedelec import NedelecSpace

    lat = make_lattice("CUB")
    grid = PeriodicGrid.make(lat, 4)
    center = 0.5 * lat.A.sum(axis=0)
    eps = dielectric_sphere(13.0, 1.0, 0.25, center, lat.A, 0.0)
    sp = NedelecSpace.make(grid, 2)
    kp = kpath(lat, npts=5, path=[["G", "X"]])
    kc = kp.k_cart.copy()
    for i in range(kc.shape[0]):
        if np.linalg.norm(kc[i]) < 1e-12:
            kc[i] = 2e-2 * lat.B[0]
    norm_ng = 0.15 * float(np.linalg.norm(lat.B, axis=1).min())
    n_near = int(np.sum(np.linalg.norm(kc, axis=1) < norm_ng))
    assert n_near >= 1  # the nudged Γ must be inside the ball

    def mk(**kw):
        op = BlochCurlCurl(sp, eps=eps, dtype=jnp.complex64)
        solve = op.make_solve_fn(deflation="project-cheby",
                                 precond="fastdiag")
        return BandSweep(op, nev=4, block=8, tol=1e-6, maxiter=250,
                         solve_fn=solve, device_tol=1e-4, **kw)

    ref = mk().run_warm(kc)
    ng = mk(near_gamma_tol=2e-3, near_gamma_norm=norm_ng)
    res = ng.run_warm(kc)
    # (a) refined-eigenvalue parity (both are f64 RR over converged-ish
    # f32 subspaces; agreement set by the refine, not identical paths)
    np.testing.assert_allclose(res.eigenvalues, ref.eigenvalues,
                               rtol=2e-6)
    # (b) the loose stop can only shorten the near-Γ solve
    assert res.iterations[0] <= ref.iterations[0]
    # (c) single trace for all k despite two tolerance values
    cache_size = getattr(ng._jit_single, "_cache_size", None)
    if cache_size is not None:
        assert cache_size() == 1
