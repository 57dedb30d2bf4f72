"""Config-5 harness coverage (SURVEY.md §7.1 step 10): high-order (p=4)
MATRIX-FREE sweep through the production batched path, k axis sharded
over the 8-device virtual mesh, validated against the analytic oracle —
the CPU twin of `benchmarks/config5_all14.py` (which runs all 14
families on the GPU)."""

import numpy as np
import pytest

from benchmarks.config5_all14 import PARAMS, run_one


@pytest.mark.parametrize("name", ["FCC", "TRI"])  # cubic + most oblique
@pytest.mark.parametrize("engine", ["field", "spectral"])
def test_config5_p4_both_engines(name, engine):
    # n=4 p=4 discretization floor is ~7e-6 (measured); the production
    # n=6 sits well below 1e-6.
    r = run_one(name, n=4, p=4, nev=4, tol=1e-8, maxiter=300,
                engine=engine)
    assert r["max_rel_err"] < 2e-5, r


@pytest.mark.slow
def test_config5_p4_sharded_matches_oracle():
    import jax
    from bravais_tpu.parallel.mesh import kpoint_mesh
    mesh = kpoint_mesh(jax.devices()[:8])
    r = run_one("RHL", n=4, p=4, nev=4, tol=1e-8, maxiter=300,
                mesh=mesh, engine="field")
    assert r["max_rel_err"] < 2e-5, r


def test_config5_dd_sharded_apply_p4():
    """Domain decomposition at p=4: dof axis sharded over 4 devices,
    sharded apply == unsharded apply (the DD-when-HBM-bound path for
    the largest config-5 cases)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from bravais_tpu.lattices import make_lattice
    from bravais_tpu.meshing.grid import PeriodicGrid
    from bravais_tpu.operators.helmholtz import BlochHelmholtz
    from bravais_tpu.spaces.h1 import H1Space
    from bravais_tpu.utils.reim import from_reim, to_reim

    lat = make_lattice("TRI", **PARAMS["TRI"])
    sp = H1Space.make(PeriodicGrid.make(lat, 4), 4)
    op = BlochHelmholtz(sp, dtype=jnp.complex128)
    k = jnp.asarray(lat.k_cart([0.21, 0.13, 0.17]))
    rng = np.random.default_rng(0)
    ur = jnp.asarray(rng.standard_normal((2,) + sp.dof_shape))

    y_ref = to_reim(op.apply_A(from_reim(ur), k))

    dd = Mesh(np.asarray(jax.devices()[:4]), ("x",))
    sh = NamedSharding(dd, P(None, "x", None, None))
    f = jax.jit(lambda u, kk: to_reim(op.apply_A(from_reim(u), kk)),
                in_shardings=(sh, None), out_shardings=sh)
    y = f(jax.device_put(ur, sh), k)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref),
                               rtol=1e-12, atol=1e-12)
