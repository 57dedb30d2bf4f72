"""Device-memory scale demonstration (SURVEY.md §2.3 row 1 — domain
decomposition is needed exactly when ONE k-point's problem exceeds a
single card's memory).

Two demonstrations:

1. ``--part single``: the footprint model of the headline-config (p=4)
   spectral engine by grid size, so the largest single-card sizes can
   be chosen and then driven through bench.py (``python bench.py --n
   12``).

2. ``--part dd``: a field-engine FCC Maxwell eigensolve at n=40 p=4
   (12.3 M complex dofs), compiled unsharded (the one-device program
   footprint) and dof-axis sharded over a 4-card mesh (the per-device
   share), plus one executed sharded apply at full shape. Needs four
   devices: four GPUs, or 4 virtual CPU devices under
   ``JAX_PLATFORMS=cpu``.
   Numerical parity of the DD eigensolve is gated separately by
   tests/test_domain_decomposition.py::test_sharded_eigensolve_matches.

Prints one JSON line per measurement.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--part", choices=["dd", "single"], default="dd")
    ap.add_argument("--n", type=int, default=40)
    ap.add_argument("--p", type=int, default=4)
    ap.add_argument("--m", type=int, default=16)
    args = ap.parse_args()

    if args.part == "single":
        # Footprint model for the spectral engine: the dominant arrays
        # are the (B, D, D) block operators/preconditioner with
        # B = n^3, D = 3 p^3 (complex64 = 8 B); ~6 such arrays live in
        # the program (TA, TM, Tsh/chol, Tpc, TG-sized pieces, temps).
        for n in (8, 10, 12, 14, 16):
            B, D = n ** 3, 3 * args.p ** 3
            per = B * D * D * 8 / 2 ** 30
            print(json.dumps({
                "metric": f"spectral-engine block-array GiB (n={n} p=4)",
                "value": round(per, 2), "unit": "GiB per (B,D,D) array",
                "est_program_GiB": round(6 * per, 1)}))
        print("run: python bench.py --n 12  (and larger) on the card")
        return 0

    nd = 4
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={nd}")
    import jax
    if len(jax.devices()) < nd:
        raise SystemExit(f"--part dd needs {nd} devices, found "
                         f"{len(jax.devices())}: run on four GPUs, or on "
                         f"the CPU with JAX_PLATFORMS=cpu")
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from bravais_tpu.eigen.lobpcg import lobpcg
    from bravais_tpu.lattices import make_lattice
    from bravais_tpu.meshing.grid import PeriodicGrid
    from bravais_tpu.operators.curlcurl import BlochCurlCurl
    from bravais_tpu.spaces.nedelec import NedelecSpace
    from bravais_tpu.utils.reim import from_reim, to_reim

    n, p, m = args.n, args.p, args.m
    lat = make_lattice("FCC")
    sp = NedelecSpace.make(PeriodicGrid.make(lat, n), p)
    op = BlochCurlCurl(sp, dtype=jnp.complex64)
    k = jnp.asarray(np.asarray(lat.k_cart((0.3, 0.1, 0.2)), np.float32))
    ndofs = sp.ndofs
    vec_mb = ndofs * 8 / 2 ** 20

    def solve_fn(X0_reim, kk):
        r = lobpcg(lambda x: op.apply_A(x, kk),
                   lambda x: op.apply_M(x, kk),
                   from_reim(X0_reim), 10, maxiter=2, tol=1e-5)
        return r.eigenvalues, r.iterations, r.residual_norms

    shp = (2, m) + sp.field_shape
    Xa = jax.ShapeDtypeStruct(shp, jnp.float32)
    ka = jax.ShapeDtypeStruct((3,), jnp.float32)

    limit = (jax.devices()[0].memory_stats() or {}).get("bytes_limit")

    def fits(nbytes):
        return bool(nbytes < limit) if limit else None

    def prog_bytes(jfn, *a):
        c = jfn.lower(*a).compile()
        ma = c.memory_analysis()
        return int(ma.temp_size_in_bytes + ma.argument_size_in_bytes
                   + ma.output_size_in_bytes)

    # Unsharded (single-device) footprint — the "does NOT fit" evidence.
    single = prog_bytes(jax.jit(solve_fn), Xa, ka)
    print(json.dumps({
        "metric": f"field-engine Maxwell LOBPCG program bytes, "
                  f"1 device (FCC n={n} p={p}, {ndofs} dofs, m={m})",
        "value": round(single / 2 ** 30, 2), "unit": "GiB",
        "vec_MiB": round(vec_mb, 1),
        "device": jax.devices()[0].device_kind,
        "device_bytes_limit": limit, "fits_one_device": fits(single)}))

    # Dof-axis domain decomposition over nd devices: per-device share.
    devs = jax.devices()[:nd]
    mesh = Mesh(np.asarray(devs), ("x",))
    shard = NamedSharding(mesh, P(None, None, None, "x", None, None))
    jfn = jax.jit(solve_fn, in_shardings=(shard, None))
    total = prog_bytes(jfn, Xa, ka)
    per_dev = total / nd
    print(json.dumps({
        "metric": f"same program, dof-axis sharded over {nd} devices "
                  f"(per-device share)",
        "value": round(per_dev / 2 ** 30, 2), "unit": "GiB/device",
        "total_GiB": round(total / 2 ** 30, 2),
        "fits_per_device": fits(per_dev)}))

    # Execute ONE dof-sharded apply at the full shape (proves the DD
    # path runs, not just compiles, at the over-one-device size).
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.standard_normal((2, 1) + sp.field_shape)
                    .astype(np.float32))
    ap_shard = NamedSharding(mesh, P(None, None, None, "x", None, None))
    fa = jax.jit(
        lambda ur, kk: to_reim(jax.vmap(
            lambda x: op.apply_A(x, kk))(from_reim(ur))),
        in_shardings=(ap_shard, None), out_shardings=ap_shard)
    y = np.asarray(fa(u, k))
    assert np.all(np.isfinite(y))
    print(json.dumps({
        "metric": f"dof-sharded apply_A executed at n={n} p={p}",
        "value": float(np.linalg.norm(y)), "unit": "norm(finite)",
        "ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
