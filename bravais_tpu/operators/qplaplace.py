"""Quasi-periodic scalar Laplacian  Λ φ = −∇·(α ∇φ)  on H1_qp.

The deflation operator of the Maxwell solve, L = Gᴴ M_ε G
(curlcurl.apply_Lk), equals this operator EXACTLY at matching
quadrature: ⟨Gφ, M_ε Gψ⟩ = ∫ ε ∇φ·conj(∇ψ). Having it standalone gives
the multigrid hierarchy for the deflation solve (eigen/gmg.QPGMG) —
the rebuild's replacement for the BoomerAMG-on-auxiliary-space part of
hypre AMS (SURVEY.md §2.2 #12).

k enters only through the wrap phases e^{i k·a_i} (traced).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from bravais_tpu.operators.helmholtz import CoefLike, eval_coefficient
from bravais_tpu.spaces import tensor
from bravais_tpu.spaces.h1 import H1Space

__all__ = ["QPLaplace"]


class QPLaplace:
    """Optionally mass-shifted: Λ φ = −∇·(α∇φ) + shift·β φ — the
    shifted variant is the auxiliary operator of the Hiptmair–Xu
    preconditioner for A + σM (eigen/gmg.QPGMG levels)."""

    def __init__(self, space: H1Space, alpha: CoefLike = 1.0,
                 beta: CoefLike = 1.0, shift: float = 0.0,
                 dtype=jnp.complex64):
        self.space = space
        self.dtype = jnp.dtype(dtype)
        self.rdtype = jnp.finfo(self.dtype).dtype
        self.shift = float(shift)
        rd = np.dtype(self.rdtype)
        d = space.dim

        xq = space.qpoints_phys()
        self._alpha_q64 = eval_coefficient(alpha, xq)
        self._beta_q64 = eval_coefficient(beta, xq)
        self.beta_q = self._beta_q64.astype(rd)
        self.alpha_q = self._alpha_q64.astype(rd)
        self.wq = space.quad_weight().astype(rd)
        self.B = space.basis.B.astype(rd)
        self.D = space.basis.D.astype(rd)
        self.Ginv = space.grid.Ginv.astype(rd)
        self.A_rows = space.grid.lattice.A.astype(np.float64)
        self._tabs = [[self.D if r == i else self.B for i in range(d)]
                      for r in range(d)]
        # diagonal: |phases| = 1 so it is k-independent; reuse the
        # squared-table construction of the Bloch-shifted operator.
        from bravais_tpu.operators.helmholtz import BlochHelmholtz
        helm = BlochHelmholtz(space, alpha=alpha, beta=beta, dtype=dtype)
        self._diag = np.maximum(
            np.asarray(helm._diag_S)
            + self.shift * np.asarray(helm._diag_M), 1e-30)

    def phases(self, k):
        ka = jnp.asarray(self.A_rows.astype(self.rdtype)) @ k.astype(
            self.rdtype)
        return jnp.exp(1j * ka).astype(self.dtype)

    def apply_A(self, u: jax.Array, k: jax.Array) -> jax.Array:
        sp = self.space
        d = sp.dim
        u = u.astype(self.dtype)
        ph = self.phases(k)
        ue = tensor.gather_qp(u, sp.grid.shape, (sp.p,) * d, (True,) * d,
                              ph)
        ghat = jnp.stack([tensor.contract(ue, self._tabs[r])
                          for r in range(d)])
        z = (self.alpha_q * self.wq) * jnp.einsum(
            "rs,s...->r...", jnp.asarray(self.Ginv), ghat)
        y = 0.0
        for r in range(d):
            y = y + tensor.contract_t(z[r], self._tabs[r])
        if self.shift != 0.0:
            uq = tensor.contract(ue, [self.B] * d)
            y = y + self.shift * tensor.contract_t(
                self.beta_q * self.wq * uq, [self.B] * d)
        return tensor.scatter_add_qp(y, sp.grid.shape, (sp.p,) * d,
                                     (True,) * d, ph)

    def diag_A(self, k=None) -> np.ndarray:
        return self._diag

    @property
    def diag0(self) -> np.ndarray:
        return self._diag

    def apply_A_np(self, u, k):
        """f64 host twin (used for λ_max bounds; phases at k=0 — the
        bound is phase-insensitive)."""
        sp = self.space
        d = sp.dim
        u = np.asarray(u, np.complex128)
        B64, D64 = sp.basis.B, sp.basis.D
        tabs = [[D64 if r == i else B64 for i in range(d)]
                for r in range(d)]
        args = (sp.grid.shape, (sp.p,) * d, (True,) * d)
        ue = tensor.gather_np(u, *args)
        ghat = np.stack([tensor.contract_np(ue, tabs[r]) for r in range(d)])
        z = (self._alpha_q64 * sp.quad_weight()) * np.einsum(
            "rs,s...->r...", sp.grid.Ginv, ghat)
        y = 0.0
        for r in range(d):
            y = y + tensor.contract_t_np(z[r], tabs[r])
        if self.shift != 0.0:
            uq = tensor.contract_np(ue, [B64] * d)
            y = y + self.shift * tensor.contract_t_np(
                self._beta_q64 * sp.quad_weight() * uq, [B64] * d)
        return tensor.scatter_add_np(y, *args)
