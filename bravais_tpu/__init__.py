"""bravais_tpu — a Bloch / band-structure framework in JAX for the GPU.

Built from scratch with the capabilities of ``mlstowell/mfem-bravais``
(MFEM + hypre C++/MPI band-structure miniapps; see SURVEY.md for the
structural analysis of the reference — the reference source mount was empty
at build time, so citations point at SURVEY.md sections instead of
reference file:line).

Subpackages
-----------
lattices   : the 14 3D + 5 2D Bravais lattices, Setyawan–Curtarolo symmetry
             points and k-path sampling              (SURVEY.md §2.1 #1, App. A)
meshing    : periodic structured grids on the primitive cell  (§2.1 #2)
spaces     : tensor-product H1 and Nédélec FE spaces          (App. C.1)
operators  : matrix-free Bloch Helmholtz / Maxwell curl-curl applies
             (sum-factorized einsum applies)   (§2.1 #3, #4, App. B)
eigen      : complex LOBPCG + preconditioners (Jacobi/Chebyshev/GMG/
             auxiliary-space)                                 (§2.1 #5, App. C.2–C.4)
bands      : k-path sweeps (vmap + shard_map), band tables, checkpoint/resume
             (§2.1 #6, App. C.5)
parallel   : device-mesh / sharding helpers                   (§2.3, §2.4)
cli        : typed config + command-line entry points          (§2.1 #7)
"""

__version__ = "0.1.0"

import jax as _jax

# At the 'default' matmul precision the GPU may run f32 products in
# TF32 (~3 decimal digits) — an error that destroys Gram matrices,
# orthogonalization and quadrature contractions. An eigensolver
# framework wants true-f32 contractions, so 'highest' keeps them out of
# TF32; hot kernels that can tolerate less pick their own precision
# explicitly.
_jax.config.update("jax_default_matmul_precision", "highest")

from bravais_tpu.lattices import Lattice, make_lattice, kpath  # noqa: F401,E402


def __getattr__(name):
    # Lazy convenience exports (avoid importing the full stack on
    # `import bravais_tpu`).
    lazy = {
        "PeriodicGrid": ("bravais_tpu.meshing.grid", "PeriodicGrid"),
        "H1Space": ("bravais_tpu.spaces.h1", "H1Space"),
        "NedelecSpace": ("bravais_tpu.spaces.nedelec", "NedelecSpace"),
        "BlochHelmholtz": ("bravais_tpu.operators.helmholtz",
                           "BlochHelmholtz"),
        "BlochCurlCurl": ("bravais_tpu.operators.curlcurl",
                          "BlochCurlCurl"),
        "BandSweep": ("bravais_tpu.bands.sweep", "BandSweep"),
        "lobpcg": ("bravais_tpu.eigen.lobpcg", "lobpcg"),
        "GMG": ("bravais_tpu.eigen.gmg", "GMG"),
    }
    if name in lazy:
        import importlib
        mod, attr = lazy[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'bravais_tpu' has no attribute {name!r}")
