"""Matrix-free Bloch-shifted scalar Helmholtz operator on H1.

Implements SURVEY.md App. B.1 (the JAX equivalent of mfem-bravais' scalar
Bloch assembly, SURVEY.md §2.1 #3):

    a_k(u, v) = ∫ α (∇u + i k u) · conj(∇v + i k v) dx   (stiffness A(k))
    m(u, v)   = ∫ β u conj(v) dx                          (mass M)

as complex partial-assembly (PA) applies — no global matrix is ever
formed (replacing the reference's CSR assembly + SpMV, SURVEY.md §2.2
#9). The wavevector ``k`` enters only as a traced scalar-vector, so ONE
compiled program serves every k-point (SURVEY.md §7.2 item 5).

Layout per App. B.4: gather element dofs (reshape+roll, no indexing) →
sum-factorized 1D contractions to quadrature values/gradients → pointwise
complex ops with the constant metric → transposed contractions →
periodic scatter-add.

Design note: all precomputed state (coefficient qpt values, 1D tables,
metric) is HOST numpy; it enters jitted applies as embedded constants.
Device arrays never live on ``self`` — one-time setup costs nothing on
device, and programs stay portable across backends.
"""

from __future__ import annotations

from typing import Callable, Union

import jax
import jax.numpy as jnp
import numpy as np

from bravais_tpu.spaces import tensor
from bravais_tpu.spaces.h1 import H1Space

__all__ = ["BlochHelmholtz", "eval_coefficient"]

CoefLike = Union[float, np.ndarray, Callable[[np.ndarray], np.ndarray]]


def eval_coefficient(coef: CoefLike, x: np.ndarray) -> np.ndarray:
    """Evaluate a scalar coefficient at points ``x`` of shape (..., d)."""
    if callable(coef):
        v = np.asarray(coef(x), dtype=np.float64)
        if v.shape != x.shape[:-1]:
            raise ValueError(f"coefficient returned shape {v.shape}, "
                             f"expected {x.shape[:-1]}")
        return v
    return np.broadcast_to(np.asarray(coef, dtype=np.float64),
                           x.shape[:-1]).copy()


class BlochHelmholtz:
    """A(k) and M applies for −(∇+ik)·α(∇+ik)u = λ β u on ``space``.

    ``alpha`` / ``beta`` are scalars or callables x -> value (TM: α=1,
    β=ε(x); TE: α=1/ε(x), β=1 — App. B.1). ``dtype`` is the complex
    compute dtype (complex64 on the GPU, complex128 for f64 runs).
    """

    def __init__(self, space: H1Space, alpha: CoefLike = 1.0,
                 beta: CoefLike = 1.0, dtype=jnp.complex64):
        self.space = space
        self.dtype = jnp.dtype(dtype)
        self.rdtype = jnp.finfo(self.dtype).dtype  # matching real dtype
        rd = np.dtype(self.rdtype)
        d = space.dim

        xq = space.qpoints_phys()                      # (n1,q,...,nd,q,d)
        self._alpha_fn = alpha
        self._beta_fn = beta
        self._alpha_q64 = eval_coefficient(alpha, xq)
        self._beta_q64 = eval_coefficient(beta, xq)
        self.alpha_q = self._alpha_q64.astype(rd)
        self.beta_q = self._beta_q64.astype(rd)
        self.wq = space.quad_weight().astype(rd)
        self.B = space.basis.B.astype(rd)              # (q, p+1)
        self.D = space.basis.D.astype(rd)
        self.Jinv = space.grid.Jinv.astype(rd)
        self.JinvT = np.ascontiguousarray(self.Jinv.T)
        self._tabs = [[self.D if r == i else self.B for i in range(d)]
                      for r in range(d)]
        self._btabs = [self.B] * d
        # k-independent diagonal pieces: diag A(k) = diag_S + |k|² diag_Mα;
        # all real, host-precomputed, used by Jacobi/Chebyshev (App. C.4).
        self._diag_S, self._diag_Ma = self._build_diagonals()
        self._diag_M = self._mass_diagonal(self.beta_q)

    # -- applies (pure jax, jit/vmap-safe) ----------------------------------

    def apply_A(self, u: jax.Array, k: jax.Array) -> jax.Array:
        """y = A(k) u. ``u``: (N_1, ..., N_d) complex; ``k``: (d,) real
        Cartesian wavevector (traced — no recompilation across k)."""
        sp = self.space
        d = sp.dim
        u = u.astype(self.dtype)
        k = k.astype(self.rdtype)
        kb = k.reshape((d,) + (1,) * 2 * d)

        ue = sp.gather(u)
        uq = tensor.contract(ue, self._btabs)
        ghat = jnp.stack([tensor.contract(ue, self._tabs[r])
                          for r in range(d)])
        g = jnp.einsum("rs,s...->r...", self.JinvT, ghat)  # physical ∇u
        w = g + 1j * kb * uq                               # (∇ + ik) u
        f = self.alpha_q * w
        s = -1j * jnp.sum(kb * f, axis=0)                  # −i k·f
        fhat = jnp.einsum("rs,s...->r...", self.Jinv, f)   # pull back
        z = self.wq * fhat
        y = tensor.contract_t(self.wq * s, self._btabs)
        for r in range(d):
            y = y + tensor.contract_t(z[r], self._tabs[r])
        return sp.scatter_add(y)

    def apply_M(self, u: jax.Array) -> jax.Array:
        """y = M u (k-independent β-weighted mass)."""
        sp = self.space
        u = u.astype(self.dtype)
        uq = tensor.contract(sp.gather(u), self._btabs)
        return sp.scatter_add(
            tensor.contract_t(self.wq * self.beta_q * uq, self._btabs))

    def diag_A(self, k: jax.Array) -> jax.Array:
        """Real diagonal of A(k) (for Jacobi / Chebyshev scaling)."""
        k = k.astype(self.rdtype)
        return jnp.asarray(self._diag_S) + jnp.sum(k * k) * self._diag_Ma

    @property
    def diag_M(self) -> np.ndarray:
        return self._diag_M

    @property
    def diag0(self) -> np.ndarray:
        """k-independent (k=0) stiffness diagonal — GMG smoother scaling."""
        return self._diag_S

    # -- spectral (twisted-DFT block) engine --------------------------------

    def _coef_elem_invariant(self) -> bool:
        """True when α and β repeat identically in every element
        (includes constants) — the FastDiag factorization is then EXACT
        for the quasi-periodic twin discretization."""
        q = self.space.q
        d = self.space.dim
        shape = tuple(x for n in self.space.grid.shape for x in (n, q))
        for a in (self._alpha_q64, self._beta_q64):
            a6 = np.broadcast_to(a, shape)
            ref = a6[(slice(0, 1), slice(None)) * d]
            if not np.allclose(a6, ref, rtol=1e-12, atol=0.0):
                return False
        return True

    def qp_fastdiag(self):
        """FastDiag bundle ("A" = −∇·α∇ stiffness, "M" = β-mass) of the
        QUASI-PERIODIC twin discretization (phases in the wrap instead
        of pointwise ik — operators/qplaplace.py). Exact for element-
        translation-invariant coefficients; mean-coefficient twin
        otherwise. Host setup, cached."""
        if not hasattr(self, "_qp_fd"):
            from bravais_tpu.operators.fastdiag import FastDiag
            from bravais_tpu.operators.qplaplace import QPLaplace
            sp = self.space
            if self._coef_elem_invariant():
                al, be = self._alpha_fn, self._beta_fn
            else:
                al = float(np.mean(self._alpha_q64))
                be = float(np.mean(self._beta_q64))
            # Constant coefficients: probe the k=0 applies on the
            # shrunken same-Jacobian twin grid — identical stencils at
            # O((3/n)^d) the host probing cost (grid.stencil_twin;
            # covers every production FastDiag: empty-lattice exact and
            # varying-coefficient mean twins are both constants).
            ext_sp = sp
            if (all(n >= 3 for n in sp.grid.shape)
                    and any(n > 3 for n in sp.grid.shape)
                    and not callable(al) and not callable(be)
                    and np.ndim(al) == 0 and np.ndim(be) == 0):
                ext_sp = H1Space.make(sp.grid.stencil_twin(), sp.p, sp.q)
            stiff = QPLaplace(ext_sp, alpha=al, dtype=self.dtype)
            mass = QPLaplace(ext_sp, alpha=0.0, beta=be, shift=1.0,
                             dtype=self.dtype)
            fd = FastDiag(sp.grid.shape, sp.p, 1,
                          sp.grid.lattice.A, self.dtype)
            k0 = np.zeros(sp.dim)
            fd.add_stencil(
                "A", lambda u: stiff.apply_A_np(u, k0),
                cache_key=("h1A", sp.q,
                           np.asarray(stiff._alpha_q64).tobytes()),
                extract_shape=ext_sp.grid.shape)
            fd.add_stencil(
                "M", lambda u: mass.apply_A_np(u, k0),
                cache_key=("h1M", sp.q,
                           np.asarray(mass._beta_q64).tobytes()),
                extract_shape=ext_sp.grid.shape)
            self._qp_fd = fd
        return self._qp_fd

    def qp_fd_shift(self) -> float:
        """Band-scale shift for the (A+sM)⁻¹ block preconditioner."""
        B = self.space.grid.lattice.B
        return float(0.5 * np.max(np.sum(B * B, axis=1))
                     * np.mean(self._beta_q64))

    def make_solve_fn(self, engine: str = "spectral",
                      fd_shift: float | None = None,
                      scale_floor: float | None = None,
                      rr_tol: float | None | str = "prod"):
        """Solve hook for BandSweep: LOBPCG entirely in the twisted-DFT
        block basis (the scalar twin of curlcurl's spectral engine,
        SURVEY.md §2.2 #12-13) — per-iteration ops are batched D×D
        block matvecs (D = pᵈ), with the essentially exact (A+sM)⁻¹
        block preconditioner and the exact O(candidates·D³) f64 host
        refine (FastDiag.spectral_refine_np).

        NOTE: solves the QUASI-PERIODIC discretization of the same
        Bloch eigenproblem (phases in the periodic wrap instead of
        pointwise ik terms). Both Galerkin spaces converge at the same
        order to the same bands; discrete eigenvalues differ only at
        discretization-error level — validated against the analytic
        oracle in tests."""
        from bravais_tpu.eigen.lobpcg import PROD_RR_TOL, lobpcg

        # "prod" = measured production RR stop; None = machine precision.
        rr = PROD_RR_TOL if isinstance(rr_tol, str) else rr_tol
        if engine != "spectral":
            raise ValueError(f"unknown engine {engine!r}")
        if min(self.space.grid.shape) < 3:
            raise ValueError("spectral engine needs n_i >= 3 per axis")
        if not self._coef_elem_invariant():
            raise ValueError(
                "engine='spectral' requires element-translation-"
                "invariant coefficients; use the default (Jacobi/GMG-"
                "preconditioned matrix-free) path")
        self.qp_fastdiag()  # host stencil extraction, cached
        sfloor = scale_floor if scale_floor is not None else (
            0.3 if jnp.dtype(self.dtype) == jnp.complex64 else 3e-2)
        s_default = fd_shift if fd_shift is not None else None

        def solve(op, X0, k, nev, tol, maxiter, precond_in):
            fd = op.qp_fastdiag()
            theta = fd._theta(k)
            F = fd._fwd_mats(theta)
            TA = fd.blocks([("A", 1.0)], k)
            TM = fd.blocks([("M", 1.0)], k)
            s_ = float(s_default if s_default is not None
                       else op.qp_fd_shift())
            # HPD shifted pencil: Cholesky inverse (half the LU cost)
            import jax.scipy.linalg as _jsl
            Tsh = TA + s_ * TM
            Lc = jnp.linalg.cholesky(Tsh)
            eyeD = jnp.broadcast_to(
                jnp.eye(Tsh.shape[-1], dtype=Tsh.dtype), Tsh.shape)
            Yc = _jsl.solve_triangular(Lc, eyeD, lower=True)
            Tpc = jnp.conj(jnp.swapaxes(Yc, -1, -2)) @ Yc

            def bmv(T, x):
                return jnp.einsum("bij,bj->bi", T, x)

            X0b = jax.vmap(lambda x: fd.to_blocks(x, F))(X0)
            res = lobpcg(lambda x: bmv(TA, x), lambda x: bmv(TM, x),
                         X0b, nev, maxiter=maxiter, tol=tol,
                         precond=lambda R: bmv(Tpc, R),
                         scale_floor=sfloor, rr_tol=rr)
            support = jnp.sum(jnp.abs(res.eigenvectors) ** 2, axis=-1)
            Xf = jax.vmap(lambda v: fd.from_blocks(v, F)
                          )(res.eigenvectors)
            return res._replace(eigenvectors=Xf), support

        solve.provides_support = True
        solve.refine_np = (lambda support, k, nev:
                           self.qp_fastdiag().spectral_refine_np(
                               support, k, nev))
        return solve

    # -- host f64 twins (for the final Rayleigh–Ritz refinement) ------------

    def apply_A_np(self, u: np.ndarray, k: np.ndarray) -> np.ndarray:
        """Matrix-free A(k) apply on host in float64/complex128 — same
        math as :meth:`apply_A` via the NumPy twins. Used by the f64
        Rayleigh–Ritz polish (SURVEY.md §7.0 precision plan d)."""
        sp = self.space
        d = sp.dim
        shape, pp, cl = sp.grid.shape, (sp.p,) * d, (True,) * d
        B64 = sp.basis.B
        D64 = sp.basis.D
        tabs = [[D64 if r == i else B64 for i in range(d)] for r in range(d)]
        wq = sp.quad_weight()
        aq = self._alpha_q64
        Jinv = sp.grid.Jinv
        u = np.asarray(u, np.complex128)
        k = np.asarray(k, np.float64)
        kb = k.reshape((d,) + (1,) * 2 * d)
        ue = tensor.gather_np(u, shape, pp, cl)
        uq = tensor.contract_np(ue, [B64] * d)
        ghat = np.stack([tensor.contract_np(ue, tabs[r]) for r in range(d)])
        g = np.einsum("rs,s...->r...", Jinv.T, ghat)
        w = g + 1j * kb * uq
        f = aq * w
        s = -1j * np.sum(kb * f, axis=0)
        fhat = np.einsum("rs,s...->r...", Jinv, f)
        y = tensor.contract_t_np(wq * s, [B64] * d)
        for r in range(d):
            y = y + tensor.contract_t_np(wq * fhat[r], tabs[r])
        return tensor.scatter_add_np(y, shape, pp, cl)

    def apply_M_np(self, u: np.ndarray, k=None) -> np.ndarray:
        # k accepted for interface uniformity with the quasi-periodic
        # Maxwell operator; the Bloch-shifted scalar mass is k-free.
        sp = self.space
        d = sp.dim
        shape, pp, cl = sp.grid.shape, (sp.p,) * d, (True,) * d
        B64 = sp.basis.B
        uq = tensor.contract_np(
            tensor.gather_np(np.asarray(u, np.complex128), shape, pp, cl),
            [B64] * d)
        return tensor.scatter_add_np(
            tensor.contract_t_np(sp.quad_weight() * self._beta_q64 * uq,
                                 [B64] * d), shape, pp, cl)

    # -- host-side diagonal precomputation (NumPy) --------------------------

    def _build_diagonals(self):
        """diag_S[j] = Σ_q w α Σ_rs Ginv[rs] ĝ_r ĝ_s |_loc(j) and
        diag_Mα[j] = Σ_q w α φ_j(x_q)² — via squared-table contractions."""
        sp = self.space
        d = sp.dim
        Ginv = sp.grid.Ginv
        wa = (self.wq * self.alpha_q).astype(np.float64)
        BB = self.B * self.B
        args = (sp.grid.shape, (sp.p,) * d, (True,) * d)
        diag_S = 0.0
        for r in range(d):
            for s in range(d):
                tabs = []
                for i in range(d):
                    if i == r and i == s:
                        tabs.append(self.D * self.D)
                    elif i == r or i == s:
                        tabs.append(self.D * self.B)
                    else:
                        tabs.append(BB)
                diag_S = diag_S + Ginv[r, s] * tensor.contract_t_np(wa, tabs)
        rd = np.dtype(self.rdtype)
        return (tensor.scatter_add_np(diag_S, *args).astype(rd),
                tensor.scatter_add_np(tensor.contract_t_np(wa, [BB] * d),
                                      *args).astype(rd))

    def _mass_diagonal(self, coef_q):
        sp = self.space
        d = sp.dim
        BB = self.B * self.B
        wb = (self.wq * coef_q).astype(np.float64)
        return tensor.scatter_add_np(
            tensor.contract_t_np(wb, [BB] * d), sp.grid.shape,
            (sp.p,) * d, (True,) * d).astype(np.dtype(self.rdtype))
