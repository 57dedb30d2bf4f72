"""Matrix-free Bloch Maxwell curl-curl operator on tensor Nédélec —
QUASI-PERIODIC formulation.

SURVEY.md App. B.2 (the JAX equivalent of the reference's Maxwell assembly,
§2.1 #4). The Bloch problem is realized the way the reference's MFEM
stack realizes it (phased periodic dof identification, §3.2) rather
than by shifting the operator: fields satisfy u(x + a_i) = e^{i k·a_i}
u(x), the operator is the PLAIN curl-curl

    a(u, v) = ∫ μ⁻¹ (∇×u)·conj(∇×v),   m(u, v) = ∫ ε u·conj(v),

and k enters ONLY through the wrap phases φ_i = e^{i k·a_i} in the
element gather/scatter (traced scalars — one compiled program serves
every k-point).

Why this and not the shifted-operator form: with the shift, the discrete
near-kernel is not the image of any computable discrete gradient —
deflation leaks "ghost" eigenvalues into the physical spectrum
(measured: a ghost at 1.003 below the first band 3.356 at n=4, p=2).
In the quasi-periodic form the twisted discrete de Rham sequence is
EXACT: kernel(curl) = ∇ H1_qp for every k not in the reciprocal lattice,
so divergence-projection deflation (App. C.3) removes the entire
nullspace exactly. At k = Γ the three harmonic constants remain (the
physical ω→0 limit + one gauge mode); sweeps nudge exact-Γ points by an
infinitesimal k (the standard planewave-code practice).

Covariant transforms with the constant Jacobian J: u_phys = J^{-T} û,
curl_phys = J curl̂(û)/det J (App. C.1).
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from bravais_tpu.operators.helmholtz import CoefLike, eval_coefficient
from bravais_tpu.spaces import tensor
from bravais_tpu.spaces.h1 import H1Space
from bravais_tpu.spaces.nedelec import NedelecSpace

__all__ = ["BlochCurlCurl"]

_CYC = ((0, 1, 2), (1, 2, 0), (2, 0, 1))  # (r, s, t) cyclic triples


class BlochCurlCurl:
    """A(k), M applies and exact gradient-deflation ops for
    (∇+ik)×μ⁻¹(∇+ik)× u = ω² ε u, realized quasi-periodically on
    ``space`` (NedelecSpace). Fields: (3, N1, N2, N3) complex."""

    #: host twins accept a leading block axis (refine-stage batching)
    supports_batched_np = True

    def __init__(self, space: NedelecSpace, eps: CoefLike = 1.0,
                 mu_inv: CoefLike = 1.0, dtype=jnp.complex64):
        self.space = space
        self.dtype = jnp.dtype(dtype)
        self.rdtype = jnp.finfo(self.dtype).dtype
        rd = np.dtype(self.rdtype)

        xq = space.qpoints_phys()
        self._eps_fn = eps          # kept for GMG rediscretization
        self._mu_inv_fn = mu_inv
        self._eps_q64 = eval_coefficient(eps, xq)
        self._mu_inv_q64 = eval_coefficient(mu_inv, xq)
        self.eps_q = self._eps_q64.astype(rd)
        self.mu_inv_q = self._mu_inv_q64.astype(rd)
        self.wq = space.quad_weight().astype(rd)
        g = space.grid
        self.A_rows = g.lattice.A.astype(np.float64)   # rows a_i
        self.J = g.J.astype(rd)
        self.Jinv = g.Jinv.astype(rd)
        self.Ginv = g.Ginv.astype(rd)
        self.detJs = float(np.linalg.det(g.J))
        # Companion scalar H1 space (same grid/order/quadrature) for the
        # deflation solve's Jacobi diagonal (k=0 Laplacian-with-ε diag).
        from bravais_tpu.operators.helmholtz import BlochHelmholtz
        self.h1 = H1Space.make(g, space.p, space.q)
        self._helm = BlochHelmholtz(self.h1, alpha=eps, beta=eps,
                                    dtype=dtype)
        self._h1_diag0 = np.maximum(
            np.asarray(self._helm.diag_A(jnp.zeros(3))), 1e-12)
        self._diag_A, self._diag_M = self._build_diagonals()

    # -- phases --------------------------------------------------------------

    def phases(self, k):
        """φ_i = e^{i k·a_i} for the three primitive directions (traced)."""
        ka = jnp.asarray(self.A_rows.astype(self.rdtype)) @ k.astype(
            self.rdtype)
        return jnp.exp(1j * ka).astype(self.dtype)

    # -- element restriction -------------------------------------------------

    def _gather(self, u, c, ph):
        sp = self.space
        return tensor.gather_qp(u, sp.grid.shape, (sp.p,) * 3,
                                sp.flags(c), ph)

    def _scatter(self, r, c, ph):
        sp = self.space
        return tensor.scatter_add_qp(r, sp.grid.shape, (sp.p,) * 3,
                                     sp.flags(c), ph)

    # -- applies -------------------------------------------------------------

    def _tables(self):
        sp = self.space
        if not hasattr(self, "_tab_cache"):
            rd = np.dtype(self.rdtype)
            self._tab_cache = {
                "val": [[t.astype(rd) for t in sp.value_tables(c)]
                        for c in range(3)],
                "der": [[[t.astype(rd) for t in sp.deriv_tables(c, s)]
                         for s in range(3)] for c in range(3)],
            }
        return self._tab_cache

    # -- component-stacked fast path -----------------------------------
    #
    # The reference einsum path launches ~36 small contraction kernels
    # per apply (3 components x dims x fwd/transpose) — dispatch-bound
    # at practical sizes. The stacked path pads the open direction to
    # p+1 (zero slot + zero table column), stacks the three components,
    # and vmaps each contraction over the component axis: one BATCHED
    # dot per (stage, dim) instead of three. Verified equal to apply_A
    # to roundoff (tests/test_curlcurl.py).

    def _stacked_tables(self):
        if hasattr(self, "_stk"):
            return self._stk
        sp = self.space
        rd = np.dtype(self.rdtype)

        def embed(T):  # (q, p) open table -> (q, p+1), zero last column
            return np.pad(T, ((0, 0), (0, 1))).astype(rd)

        Bc = sp.closed.B.astype(rd)
        Dc = sp.closed.D.astype(rd)
        Bo = embed(sp.open.B)
        Do = embed(sp.open.D)
        val = tuple(
            np.stack([Bo if i == c else Bc for c in range(3)])
            for i in range(3))                      # per-dim (3, q, p+1)
        der = []
        for s2 in range(3):
            der.append(tuple(
                np.stack([(Do if i == c else Dc) if i == s2
                          else (Bo if i == c else Bc) for c in range(3)])
                for i in range(3)))
        # transpose-path sign/index: for ordered (s, t), s != t, the
        # unique r with {r,s,t} = {0,1,2}; sign +1 if (r,s,t) cyclic.
        sign = np.zeros((3, 3), np.int8)
        ridx = np.zeros((3, 3), np.int8)
        for r, s2, t in _CYC:
            sign[s2, t], ridx[s2, t] = 1, r
            sign[t, s2], ridx[t, s2] = -1, r
        self._stk = dict(val=val, der=der, sign=sign, ridx=ridx)
        return self._stk

    def _gather_stacked(self, u, ph):
        sp = self.space
        outs = []
        for c in range(3):
            g = u[c]
            for i in range(3):
                ax = 2 * i
                if i == c:   # open dim: reshape + zero pad slot
                    shp = g.shape
                    g = g.reshape(*shp[:ax], sp.grid.shape[i], sp.p,
                                  *shp[ax + 1:])
                    pad = [(0, 0)] * g.ndim
                    pad[ax + 1] = (0, 1)
                    g = jnp.pad(g, pad)
                else:
                    g = tensor.gather_axis(g, ax, sp.grid.shape[i], sp.p,
                                           ph[i])
            outs.append(g)
        return jnp.stack(outs)

    def _scatter_stacked(self, r, ph):
        sp = self.space
        outs = []
        for c in range(3):
            g = r[c]
            for i in reversed(range(3)):
                ax = 2 * i
                if i == c:   # open dim: drop pad slot, reshape
                    g = jax.lax.slice_in_dim(g, 0, sp.p, axis=ax + 1)
                    shp = g.shape
                    g = g.reshape(*shp[:ax], sp.grid.shape[i] * sp.p,
                                  *shp[ax + 2:])
                else:
                    g = tensor.scatter_add_axis(g, ax, sp.grid.shape[i],
                                                sp.p, ph[i])
            outs.append(g)
        return jnp.stack(outs)

    def apply_A(self, u: jax.Array, k: jax.Array) -> jax.Array:
        """y = A(k) u — component-stacked fast path (production)."""
        u = u.astype(self.dtype)
        ph = self.phases(k)
        stk = self._stacked_tables()
        vmc = jax.vmap(tensor.contract, in_axes=(0, (0, 0, 0)))
        vmt = jax.vmap(tensor.contract_t, in_axes=(0, (0, 0, 0)))
        ue = self._gather_stacked(u, ph)
        D = [vmc(ue, stk["der"][s2]) for s2 in range(3)]  # D[s][t]=∂̂_s û_t
        chat = jnp.stack([D[s2][t] - D[t][s2] for _, s2, t in _CYC])
        cph = jnp.einsum("rs,s...->r...", jnp.asarray(self.J),
                         chat) / self.detJs
        f = (self.mu_inv_q * self.wq) * cph
        cf = jnp.einsum("sr,s...->r...", jnp.asarray(self.J),
                        f) / self.detJs
        y = 0.0
        sign, ridx = stk["sign"], stk["ridx"]
        for s2 in range(3):
            V = jnp.stack([cf[ridx[s2, t]] * float(sign[s2, t])
                           if t != s2 else jnp.zeros_like(cf[0])
                           for t in range(3)])
            y = y + vmt(V, stk["der"][s2])
        return self._scatter_stacked(y, ph)

    def apply_M(self, u: jax.Array, k: jax.Array = None,
                ph=None) -> jax.Array:
        """y = M u — component-stacked fast path (production). Mass
        wraps with phases: pass ``k`` or precomputed ``ph``."""
        u = u.astype(self.dtype)
        if ph is None:
            ph = self.phases(k)
        stk = self._stacked_tables()
        vmc = jax.vmap(tensor.contract, in_axes=(0, (0, 0, 0)))
        vmt = jax.vmap(tensor.contract_t, in_axes=(0, (0, 0, 0)))
        ue = self._gather_stacked(u, ph)
        uhat = vmc(ue, stk["val"])
        g = (self.eps_q * self.wq) * jnp.einsum(
            "rs,s...->r...", jnp.asarray(self.Ginv), uhat)
        return self._scatter_stacked(vmt(g, stk["val"]), ph)

    def apply_A_ref(self, u: jax.Array, k: jax.Array) -> jax.Array:
        """Reference (unstacked) einsum implementation of A(k) u — kept
        for cross-checking the stacked fast path."""
        sp = self.space
        u = u.astype(self.dtype)
        ph = self.phases(k)
        tabs = self._tables()
        ue = [self._gather(u[c], c, ph) for c in range(3)]
        chat = []
        for r, s, t in _CYC:
            chat.append(tensor.contract(ue[t], tabs["der"][t][s])
                        - tensor.contract(ue[s], tabs["der"][s][t]))
        chat = jnp.stack(chat)
        cph = jnp.einsum("rs,s...->r...", self.J, chat) / self.detJs
        f = (self.mu_inv_q * self.wq) * cph
        cf = jnp.einsum("sr,s...->r...", self.J, f) / self.detJs
        y = [0.0, 0.0, 0.0]
        for r, s, t in _CYC:
            y[t] = y[t] + tensor.contract_t(cf[r], tabs["der"][t][s])
            y[s] = y[s] - tensor.contract_t(cf[r], tabs["der"][s][t])
        return jnp.stack([self._scatter(y[c], c, ph) for c in range(3)])

    def apply_M_ref(self, u: jax.Array, k: jax.Array = None,
                    ph=None) -> jax.Array:
        """Reference (unstacked) einsum implementation of M u."""
        sp = self.space
        u = u.astype(self.dtype)
        if ph is None:
            ph = (self.phases(k) if k is not None
                  else (None, None, None))
        tabs = self._tables()
        ue = [self._gather(u[c], c, ph) for c in range(3)]
        uhat = jnp.stack([tensor.contract(ue[c], tabs["val"][c])
                          for c in range(3)])
        g = (self.eps_q * self.wq) * jnp.einsum("rs,s...->r...",
                                                jnp.asarray(self.Ginv),
                                                uhat)
        y = [tensor.contract_t(g[c], tabs["val"][c]) for c in range(3)]
        return jnp.stack([self._scatter(y[c], c, ph) for c in range(3)])

    # -- host f64 twins (refinement) ----------------------------------------

    def _np_phases(self, k):
        return np.exp(1j * (self.A_rows @ np.asarray(k, np.float64)))

    def _apply_np(self, u, k, which):
        """f64 host apply via a phase-twisted numpy path.

        Accepts a single field (3, N₁, N₂, N₃) or a BLOCK
        (m, 3, N₁, N₂, N₃): the block axis is moved last, where every
        axis-positional helper below ignores it (trailing broadcast) —
        one pass through the tensordot pipeline for all m vectors
        instead of m passes (the refine-stage host cost fix)."""
        u = np.asarray(u, np.complex128)
        if u.ndim == 5:  # block (m, 3, N₁, N₂, N₃) → batch axis last
            out = self._apply_np_core(np.moveaxis(u, 0, -1), k, which,
                                      batched=True)
            return np.moveaxis(out, -1, 0)
        return self._apply_np_core(u, k, which, batched=False)

    def _apply_np_core(self, u, k, which, batched):
        sp = self.space
        ph = self._np_phases(k)
        bc = (Ellipsis, None) if batched else Ellipsis
        Bc, Dc = sp.closed.B, sp.closed.D
        Bo, Do = sp.open.B, sp.open.D

        def gath(uc, c):
            out = uc
            for i in range(3):
                ax = 2 * i
                shape = out.shape
                n, p = sp.grid.shape[i], sp.p
                if i == c:
                    out = out.reshape(*shape[:ax], n, p, *shape[ax + 1:])
                else:
                    out = out.reshape(*shape[:ax], n, p, *shape[ax + 1:])
                    first = np.take(out, [0], axis=ax + 1)
                    rolled = np.roll(first, -1, axis=ax)
                    sel = [slice(None)] * rolled.ndim
                    sel[ax] = slice(n - 1, n)
                    rolled[tuple(sel)] = rolled[tuple(sel)] * ph[i]
                    out = np.concatenate([out, rolled], axis=ax + 1)
            return out

        def scat(rc, c):
            out = rc
            for i in reversed(range(3)):
                ax = 2 * i
                n, p = sp.grid.shape[i], sp.p
                if i == c:
                    shape = out.shape
                    out = out.reshape(*shape[:ax], n * p, *shape[ax + 2:])
                else:
                    main = np.take(out, range(p), axis=ax + 1).copy()
                    last = np.take(out, [p], axis=ax + 1)
                    rolled = np.roll(last, 1, axis=ax)
                    sel = [slice(None)] * rolled.ndim
                    sel[ax] = slice(0, 1)
                    rolled[tuple(sel)] = rolled[tuple(sel)] * np.conj(ph[i])
                    idx = (slice(None),) * (ax + 1) + (0,)
                    main[idx] += np.squeeze(rolled, axis=ax + 1)
                    shape = main.shape
                    out = main.reshape(*shape[:ax], n * p, *shape[ax + 2:])
            return out

        def vtab(c):
            return [Bo if i == c else Bc for i in range(3)]

        def dtab(c, s):
            out = []
            for i in range(3):
                if i == c:
                    out.append(Do if i == s else Bo)
                else:
                    out.append(Dc if i == s else Bc)
            return out

        ue = [gath(u[c], c) for c in range(3)]
        wq = sp.quad_weight()
        if which == "M":
            uhat = np.stack([tensor.contract_np(ue[c], vtab(c))
                             for c in range(3)])
            g = (self._eps_q64 * wq)[bc] * np.einsum(
                "rs,s...->r...", sp.grid.Ginv, uhat)
            y = [tensor.contract_t_np(g[c], vtab(c)) for c in range(3)]
            return np.stack([scat(y[c], c) for c in range(3)])
        chat = []
        for r, s, t in _CYC:
            chat.append(tensor.contract_np(ue[t], dtab(t, s))
                        - tensor.contract_np(ue[s], dtab(s, t)))
        chat = np.stack(chat)
        cph = np.einsum("rs,s...->r...", sp.grid.J, chat) / self.detJs
        f = (self._mu_inv_q64 * wq)[bc] * cph
        cf = np.einsum("sr,s...->r...", sp.grid.J, f) / self.detJs
        y = [0.0, 0.0, 0.0]
        for r, s, t in _CYC:
            y[t] = y[t] + tensor.contract_t_np(cf[r], dtab(t, s))
            y[s] = y[s] - tensor.contract_t_np(cf[r], dtab(s, t))
        return np.stack([scat(y[c], c) for c in range(3)])

    def apply_Gk_np(self, phi, k):
        """f64 host twin of :meth:`apply_Gk`. Accepts (N₁,N₂,N₃) or a
        block (m, N₁,N₂,N₃) — the batch axis rides trailing through the
        positional helpers (one tensordot pipeline for all m)."""
        phi = np.asarray(phi, np.complex128)
        if phi.ndim == 4:
            out = self._apply_Gk_np_core(np.moveaxis(phi, 0, -1), k)
            return np.moveaxis(out, -1, 0)  # (3, N..., m) → (m, 3, N...)
        return self._apply_Gk_np_core(phi, k)

    def _apply_Gk_np_core(self, phi, k):
        sp = self.space
        ph = self._np_phases(k)
        out = []
        for c in range(3):
            g = tensor.gather_axis_np(phi, c, sp.grid.shape[c], sp.p,
                                      ph[c])
            d = np.moveaxis(
                np.tensordot(sp.Dnode, g, axes=((1,), (c + 1,))), 0, c + 1)
            shape = d.shape
            out.append(d.reshape(*shape[:c], sp.grid.shape[c] * sp.p,
                                 *shape[c + 2:]))
        return np.stack(out)

    def apply_GkH_np(self, u, k):
        """f64 host twin of :meth:`apply_GkH`. Accepts (3, N₁,N₂,N₃) or
        a block (m, 3, N₁,N₂,N₃)."""
        u = np.asarray(u, np.complex128)
        if u.ndim == 5:
            out = self._apply_GkH_np_core(np.moveaxis(u, 0, -1), k)
            return np.moveaxis(out, -1, 0)
        return self._apply_GkH_np_core(u, k)

    def _apply_GkH_np_core(self, u, k):
        sp = self.space
        ph = self._np_phases(k)
        acc = 0.0
        for c in range(3):
            shape = u[c].shape
            r = u[c].reshape(*shape[:c], sp.grid.shape[c], sp.p,
                             *shape[c + 1:])
            d = np.moveaxis(
                np.tensordot(sp.Dnode, r, axes=((0,), (c + 1,))), 0, c + 1)
            acc = acc + tensor.scatter_add_axis_np(d, c, sp.grid.shape[c],
                                                   sp.p, ph[c])
        return acc

    def gradient_component_np(self, u, k, cg_iters: int = 12) -> np.ndarray:
        """f64 host P u = G L⁻¹ Gᴴ M u — the refine-stage leakage
        cleanup: exact fast-diagonal solve when ε is
        element-invariant, else fd-preconditioned CG on the true L.
        ``u`` may have a leading block axis (m, 3, N₁, N₂, N₃)."""
        k = np.asarray(k, np.float64)
        u = np.asarray(u, np.complex128)
        lsolve = self.fastdiag_L().solver_np([("L", 1.0)], k)
        if self._coef_elem_invariant():
            # exact direct solve; fully batched applies (blocks ride a
            # trailing axis through the tensordot pipelines)
            rhs = self.apply_GkH_np(self.apply_M_np(u, k), k)
            return self.apply_Gk_np(lsolve(rhs), k)
        if u.ndim == 5:  # varying ε: per-row preconditioned CG
            return np.stack([self._grad_comp_np_one(x, k, lsolve,
                                                    cg_iters)
                             for x in u])
        return self._grad_comp_np_one(u, k, lsolve, cg_iters)

    def _grad_comp_np_one(self, u, k, lsolve, cg_iters):
        rhs = self.apply_GkH_np(self.apply_M_np(u, k), k)
        phi = lsolve(rhs)
        if not self._coef_elem_invariant():
            # lsolve is the mean-ε solve: polish with preconditioned CG
            # on the true L (f64; exactness only matters for kernel dirs)
            def L(x):
                return self.apply_GkH_np(
                    self.apply_M_np(self.apply_Gk_np(x, k), k), k)

            r = rhs - L(phi)
            p_ = lsolve(r)
            rz = np.vdot(r, p_)
            for _ in range(cg_iters):
                Ap = L(p_)
                denom = np.vdot(p_, Ap)
                if abs(denom) < 1e-300 or abs(rz) < 1e-300:
                    break
                alpha = rz / denom
                phi = phi + alpha * p_
                r = r - alpha * Ap
                z = lsolve(r)
                rz_new = np.vdot(r, z)
                p_ = z + (rz_new / rz) * p_
                rz = rz_new
        return self.apply_Gk_np(phi, k)

    def apply_A_np(self, u, k):
        return self._apply_np(u, k, "A")

    def apply_M_np(self, u, k=None):
        # k is needed for the phase wrap; refine passes it positionally
        # via a partial bound in host_rayleigh_ritz (see refine module).
        if k is None:
            raise ValueError("apply_M_np requires k (quasi-periodic mass)")
        return self._apply_np(u, k, "M")

    # ------------------------------------------------------------------
    # Discrete gradient G (exact: ∇ H1_qp ⊂ ND_qp) and deflation
    # ------------------------------------------------------------------

    def apply_Gk(self, phi: jax.Array, k: jax.Array) -> jax.Array:
        """∇φ : quasi-periodic H1 scalar -> ND field (exact)."""
        sp = self.space
        phi = phi.astype(self.dtype)
        ph = self.phases(k)
        Dn = jnp.asarray(sp.Dnode.astype(np.dtype(self.rdtype)))
        out = []
        for c in range(3):
            g = tensor.gather_axis(phi, c, sp.grid.shape[c], sp.p, ph[c])
            d = jnp.moveaxis(
                jnp.tensordot(Dn, g, axes=((1,), (c + 1,))), 0, c + 1)
            shape = d.shape
            out.append(d.reshape(*shape[:c], sp.grid.shape[c] * sp.p,
                                 *shape[c + 2:]))
        return jnp.stack(out)

    def apply_GkH(self, u: jax.Array, k: jax.Array) -> jax.Array:
        sp = self.space
        u = u.astype(self.dtype)
        ph = self.phases(k)
        Dn = jnp.asarray(sp.Dnode.astype(np.dtype(self.rdtype)))
        acc = 0.0
        for c in range(3):
            shape = u[c].shape
            r = u[c].reshape(*shape[:c], sp.grid.shape[c], sp.p,
                             *shape[c + 1:])
            d = jnp.moveaxis(
                jnp.tensordot(Dn, r, axes=((0,), (c + 1,))), 0, c + 1)
            acc = acc + tensor.scatter_add_axis(d, c, sp.grid.shape[c],
                                                sp.p, ph[c])
        return acc

    # Auxiliary-space (Hiptmair-Xu / hypre-AMS) preconditioning was
    # prototyped here in round 1 (nodal interpolation Pi + scalar/vector
    # QP-GMG auxiliary solves) and measured SLOWER than Jacobi for the
    # eigensolve in both unshifted and band-scale-shifted forms; the
    # twisted-DFT fast block-diagonalization below replaced it as the
    # production hypre-AMS equivalent (SURVEY.md 2.2 #12) and is both
    # exact and cheaper. The losing variants were removed (git history:
    # 'AMS building blocks').

    # ------------------------------------------------------------------
    # Fast block-diagonalization (twisted DFT) — operators/fastdiag.py
    # ------------------------------------------------------------------

    def _coef_elem_invariant(self) -> bool:
        """True when ε and μ⁻¹ repeat identically in every element
        (includes constants) — then the FastDiag factorization is EXACT."""
        q = self.space.q
        for a in (self._eps_q64, self._mu_inv_q64):
            a6 = np.broadcast_to(
                a, tuple(x for n in self.space.grid.shape
                         for x in (n, q)))
            ref = a6[:1, :, :1, :, :1, :]
            if not np.allclose(a6, ref, rtol=1e-12, atol=0.0):
                return False
        return True

    def coef_contrast(self) -> float:
        """max/min ratio over ε and μ⁻¹ quadrature values — bounds the
        condition number of the mean-twin-preconditioned operators."""
        out = 1.0
        for a in (self._eps_q64, self._mu_inv_q64):
            a = np.asarray(a, np.float64)
            out = max(out, float(a.max() / max(a.min(), 1e-300)))
        return out

    def adaptive_cg_iters(self) -> int:
        """Inner-PCG budget for the true-L projector and shifted-
        operator solves: ≈3√κ steps drive the CG error factor
        ((√κ−1)/(√κ+1))^its below ~3e-3 at contrast κ. Measured
        (round 3, ε=30 sphere): 8 fixed steps → 92 LOBPCG iterations,
        16 → 20; this rule gives 17."""
        return int(max(8, np.ceil(3.0 * np.sqrt(self.coef_contrast()))))

    def fastdiag(self):
        """FastDiag bundle with "A" and "M" stencils. Exact when the
        coefficients are element-translation-invariant (every headline
        empty-lattice config); otherwise built from the MEAN-coefficient
        twin — still a spectrally equivalent (contrast-bounded)
        preconditioner. Host setup, cached."""
        if not hasattr(self, "_fd"):
            from bravais_tpu.operators.fastdiag import FastDiag
            sp = self.space
            # Constant coefficients (the exact empty-lattice case AND
            # the varying-ε mean twin): probe the k=0 applies on the
            # shrunken same-Jacobian twin grid — identical stencils at
            # O((3/n)³) the host probing cost (grid.stencil_twin).
            # Element-invariant CALLABLE coefficients keep the
            # production grid (the twin grid spans a different
            # physical region).
            shrink = (all(n >= 3 for n in sp.grid.shape)
                      and any(n > 3 for n in sp.grid.shape))
            if self._coef_elem_invariant():
                if (shrink and not callable(self._eps_fn)
                        and not callable(self._mu_inv_fn)
                        and np.ndim(self._eps_fn) == 0
                        and np.ndim(self._mu_inv_fn) == 0):
                    twin = BlochCurlCurl(
                        NedelecSpace.make(sp.grid.stencil_twin(), sp.p,
                                          sp.q),
                        eps=float(self._eps_fn),
                        mu_inv=float(self._mu_inv_fn),
                        dtype=self.dtype)
                else:
                    twin = self
            else:
                tsp = (NedelecSpace.make(sp.grid.stencil_twin(), sp.p,
                                         sp.q) if shrink else sp)
                twin = BlochCurlCurl(
                    tsp, eps=float(np.mean(self._eps_q64)),
                    mu_inv=float(np.mean(self._mu_inv_q64)),
                    dtype=self.dtype)
            k0 = np.zeros(3)
            fd = FastDiag(sp.grid.shape, sp.p, 3, self.A_rows, self.dtype)
            ck = (sp.q, np.asarray(twin._eps_q64).tobytes(),
                  np.asarray(twin._mu_inv_q64).tobytes())
            tshape = twin.space.grid.shape
            fd.add_stencil("A", lambda u: twin.apply_A_np(u, k0),
                           cache_key=("ccA",) + ck,
                           extract_shape=tshape)
            fd.add_stencil("M", lambda u: twin.apply_M_np(u, k0),
                           cache_key=("ccM",) + ck,
                           extract_shape=tshape)
            self._fd = fd
            self._fd_twin = twin
        return self._fd

    def fastdiag_L(self):
        """Scalar FastDiag with the deflation-Laplacian stencil "L"
        (L = Gᴴ M_ε G ≡ QPLaplace(α=ε) at matching quadrature)."""
        if not hasattr(self, "_fdL"):
            from bravais_tpu.operators.fastdiag import FastDiag
            from bravais_tpu.operators.qplaplace import QPLaplace
            eps = (self._eps_fn if self._coef_elem_invariant()
                   else float(np.mean(self._eps_q64)))
            sp = self.h1
            # Constant ε: probe on the shrunken same-Jacobian twin
            # grid (see fastdiag(); identical stencils, ~seconds of
            # host setup instead of minutes).
            if (all(n >= 3 for n in sp.grid.shape)
                    and any(n > 3 for n in sp.grid.shape)
                    and not callable(eps) and np.ndim(eps) == 0):
                sp = H1Space.make(sp.grid.stencil_twin(), sp.p, sp.q)
            qpl = QPLaplace(sp, alpha=eps, dtype=self.dtype)
            fd = FastDiag(self.h1.grid.shape, self.h1.p, 1, self.A_rows,
                          self.dtype)
            k0 = np.zeros(3)
            fd.add_stencil(
                "L", lambda u: qpl.apply_A_np(u, k0),
                cache_key=("ccL", self.h1.q,
                           np.asarray(qpl._alpha_q64).tobytes()),
                extract_shape=sp.grid.shape)
            self._fdL = fd
        return self._fdL

    def fastdiag_G(self):
        """The fastdiag bundle with the rectangular discrete-gradient
        stencil "G" (ND ← H1) added — the spectral engine builds the
        deflation operator L = GᴴMG directly in block space from it."""
        fd = self.fastdiag()
        if "G" not in fd.stencils:
            from bravais_tpu.operators.fastdiag import (
                _disk_cached, extract_stencil_rect)
            k0 = np.zeros(3)
            sp = self.space
            # G is coefficient-free — always probe on the fastdiag
            # twin's (possibly shrunken same-Jacobian) grid.
            twin = getattr(self, "_fd_twin", self)
            fd.stencils["G"] = _disk_cached(
                ("ccG", sp.grid.shape, sp.p, self.A_rows.tobytes()),
                lambda: extract_stencil_rect(
                    lambda u: twin.apply_Gk_np(u, k0), 3, 1,
                    twin.space.grid.shape, twin.space.p))
        return fd

    def spectral_refine_np(self, support: np.ndarray, k: np.ndarray,
                           nev: int, topk: int = 4, tau: float = 1e-5
                           ) -> tuple:
        """f64 eigenvalue refinement for the SPECTRAL engine.

        The twisted-DFT blocks are exact invariant subspaces of the
        discrete pencil (A(k), M) (element-translation-invariant
        coefficients), so the exact discrete eigenvalues are the union
        over frequencies of each block's deflated D×D eigenvalues.
        ``support[r, b] = Σ_j |X̂[r, b, j]|²`` (device-computed block
        energy of LOBPCG row r) identifies the ≤ m·topk candidate blocks
        that carry the converged bands; this does an exact f64
        generalized eigensolve of ONLY those blocks — O(candidates·D³)
        host flops (milliseconds) instead of the all-dof host
        Rayleigh–Ritz (seconds), and the result is the exact discrete
        spectrum rather than a subspace-limited RR value.

        Gradient deflation per block: σ-SHIFT instead of an explicit
        nullspace basis (round-4 host-latency trim — the refine is
        per-k critical-path work on the single-core host). The shifted
        pencil (Â + σ·M̂Ĝ L̂⁻¹ĜᴴM̂, M̂) with L̂ = ĜᴴM̂Ĝ leaves every
        physical eigenpair EXACT (Â x = λ M̂ x with λ≠0 implies
        ĜᴴM̂ x = 0 because ĜᴴÂ = (ÂĜ)ᴴ = 0) while moving the whole
        gradient subspace to eigenvalue σ; one 64×64 Cholesky + a
        subset eigh of the lowest nev+2 pairs replaces the SVD
        nullspace + full deflated eigh (measured ~2× per block). σ from
        :meth:`fd_sigma` sits ≥2.5× above the nev-th band; shifted
        copies are additionally dropped at 0.9σ, and the residual
        certificate is computed against the ORIGINAL pencil, so a
        σ-copy can never certify. Rank drop at θ→0 (Γ) is handled by
        the same δ-regularized-Cholesky zero-direction guard as the
        device projector. Returns (eigenvalues[:nev], residuals[:nev])
        with residuals the f64 full-pencil residual norms — essentially
        machine precision, an a-posteriori certificate (blocks are
        exact invariant subspaces, so block residual = full residual).
        """
        import scipy.linalg

        fd = self.fastdiag_G()
        # Candidate blocks from the nev+2 LOWEST rows only (rows are
        # sorted ascending): the upper guard rows spread support over
        # blocks that refine eigenvalues we discard (measured 9 → 5
        # candidate blocks at m=16/nev=10 — the refine is per-k
        # critical-path host work). +2 covers a near-degenerate swap at
        # the nev boundary; the device-vs-refine cross-check in
        # BandSweep._refine_host backstops a missed block.
        nrows = min(nev + 2, support.shape[0])
        idx = fd.candidate_blocks(support[:nrows], topk, tau)
        if idx.size == 0:
            # All-zero support (collapsed device block): nothing to
            # refine — signal the caller's fallback path.
            return None
        k = np.asarray(k, np.float64)
        TA, TM, TG = fd.blocks_np_multi(["A", "M", "G"], k, idx)
        sigma = self.fd_sigma(nev + 4)            # ≥2.5× the nev-th band
        lams, ress = [], []
        for A_, M_, G_ in zip(TA, TM, TG):
            A_ = 0.5 * (A_ + A_.conj().T)
            M_ = 0.5 * (M_ + M_.conj().T)
            W = M_ @ G_                            # (D, Dh1)
            L = 0.5 * ((G_.conj().T @ W) + (G_.conj().T @ W).conj().T)
            nh = L.shape[0]
            tr = max(float(np.trace(L).real) / nh, 0.0)
            delta = max(1e-12 * tr, np.finfo(np.float64).tiny)
            Lc = scipy.linalg.cholesky(L + delta * np.eye(nh), lower=True)
            dg = np.real(np.diag(Lc)).copy()
            drop = (dg * dg) <= 2.0 * delta        # θ→0 rank drop at Γ
            if drop.any():
                # Zero the dropped directions via a huge pivot (the
                # device projector's guard, in f64).
                big = dg.max() / np.finfo(np.float64).eps
                Lc[drop, :] = 0.0
                Lc[:, drop] = 0.0
                Lc[drop, drop] = big
            Y = scipy.linalg.solve_triangular(Lc, W.conj().T, lower=True)
            As = A_ + sigma * (Y.conj().T @ Y)    # + σ·M̂ĜL̂⁻¹ĜᴴM̂
            # Manual Cholesky reduction to a STANDARD subset eigh: the
            # MRRR driver (zheevr, eigenvalues 0..nev+1 only) is ~2×
            # faster than LAPACK's generalized-subset hegvx at D=192.
            Rm = scipy.linalg.cholesky(M_, lower=True)
            T1 = scipy.linalg.solve_triangular(Rm, As, lower=True)
            Ast = scipy.linalg.solve_triangular(
                Rm, T1.conj().T, lower=True)       # L⁻¹ As L⁻ᴴ
            kmax = min(nev + 1, Ast.shape[0] - 1)
            w, Yv = scipy.linalg.eigh(0.5 * (Ast + Ast.conj().T),
                                      subset_by_index=[0, kmax],
                                      driver="evr")
            keep = w < 0.9 * sigma                # drop shifted ∇-copies
            #       (copies sit at EXACTLY σ; physical bands are below
            #        σ/2.5 by fd_sigma's margin)
            w, Yv = w[keep], Yv[:, keep]
            X = scipy.linalg.solve_triangular(Rm, Yv, lower=True,
                                              trans='C')  # L⁻ᴴ y
            MX = M_ @ X
            R = A_ @ X - MX * w[None, :]          # ORIGINAL pencil
            nrm = np.maximum(np.linalg.norm(MX, axis=0), 1e-30)
            lams.append(w)
            ress.append(np.linalg.norm(R, axis=0) / nrm)  # absolute
        allw = np.concatenate(lams)
        allr = np.concatenate(ress)
        order = np.argsort(allw)[:nev]
        lam = allw[order]
        scale = np.maximum(np.abs(lam),
                           max(3e-2 * float(np.abs(allw).max()), 1e-3))
        return lam, allr[order] / scale

    def default_fd_shift(self) -> float:
        """Spectral shift s for the (A + sM)⁻¹ fast-diagonal
        preconditioner: the band scale (≈ first-bands magnitude), so
        low physical modes get gain ~1/(λ+s) ≳ 1/(2s) while the huge
        high end is crushed — the classic shifted-inverse balance."""
        B = self.space.grid.lattice.B
        return float(0.5 * np.max(np.sum(B * B, axis=1)))

    def fd_sigma(self, m: int) -> float:
        """Kernel shift σ matched to the fast-diagonal preconditioner:
        ≈2.5× an empty-lattice upper estimate of the m-th block
        eigenvalue (scaled by mean ε). Kernel directions land just above
        the block's bands — far enough to repel leakage, close enough
        that (A+sM)⁻¹ keeps the preconditioned spectrum tight. The
        λmax-scale default (:attr:`sigma_shift`) was measured to
        TRIPLE the iteration count under the fd preconditioner (σ/s ≫ 1
        re-inflates the preconditioned spectrum) and is also the
        f32-noise amplifier of the round-1 n=8 p=3 failure."""
        import itertools as _it
        lat = self.space.grid.lattice
        kc = 0.5 * lat.B.sum(axis=0)
        vals = sorted(float(np.sum((kc + np.asarray(mm, np.float64)
                                    @ lat.B) ** 2))
                      for mm in _it.product(range(-3, 4), repeat=3))
        vals = sorted(v for v in vals[:m] for _ in (0, 1))[:m]
        lam_m = vals[-1] / max(float(np.mean(self._eps_q64)), 1e-30)
        return max(2.5 * lam_m, 2.0 * self.default_fd_shift())

    def fd_precond(self, k, shift: float | None = None):
        """Outer LOBPCG preconditioner  R ↦ (A + sM)⁻¹ R  via the fast
        block-diagonalization (the hypre-AMS replacement, SURVEY.md
        §2.2 #12). Single-field callable; k may be traced."""
        s_ = float(shift if shift is not None else self.default_fd_shift())
        return self.fastdiag().solver([("A", 1.0), ("M", s_)], k)

    def fd_precond_cg(self, k, shift: float | None = None,
                      inner_iters: int = 4):
        """Contrast-robust outer preconditioner for varying ε:
        R ↦ x ≈ (A + sM)⁻¹R by ``inner_iters`` fixed PCG steps on the
        TRUE shifted operator, preconditioned by the mean-coefficient
        fast-diagonal solve. The mean twin is spectrally equivalent
        with contrast-bounded κ, so a handful of inner iterations
        recovers most of the exact inverse's quality at any contrast
        (the hypre-AMS-for-heterogeneous-ε replacement)."""
        s_ = float(shift if shift is not None
                   else self.default_fd_shift())
        minv = self.fastdiag().solver([("A", 1.0), ("M", s_)], k)
        sA = jnp.asarray(s_, self.rdtype)

        def apply(x):
            return self.apply_A(x, k) + sA * self.apply_M(x, k)

        def pc(R):
            x = jnp.zeros_like(R)
            z = minv(R)

            def body(i, st):
                x, r, p, rz = st
                Ap = apply(p)
                denom = jnp.vdot(p, Ap)
                alpha = jnp.where(jnp.abs(denom) > 1e-30, rz / denom,
                                  0.0)
                x = x + alpha * p
                r = r - alpha * Ap
                zn = minv(r)
                rzn = jnp.vdot(r, zn)
                beta = jnp.where(jnp.abs(rz) > 1e-30, rzn / rz, 0.0)
                return x, r, zn + beta * p, rzn

            return jax.lax.fori_loop(
                0, inner_iters, body, (x, R, z, jnp.vdot(R, z)))[0]

        return pc

    def gradient_component_fd(self, u: jax.Array, k: jax.Array) -> jax.Array:
        """P u via the DIRECT fast-diagonal L-solve (exact projector for
        element-invariant ε). Spectral (eigh) inverse: stable on the
        ill-conditioned near-Γ block, pseudo-inverse at exact Γ."""
        lsolve = self.fastdiag_L().solver([("L", 1.0)], k, method="eigh")
        rhs = self.apply_GkH(self.apply_M(u, k), k)
        return self.apply_Gk(lsolve(rhs), k)

    def qp_L(self):
        """The quasi-periodic ε-Laplacian TWIN of L = Gᴴ M_ε G.

        Discrete de Rham exactness makes this an IDENTITY, not an
        approximation: ∇(H1_p) lies exactly in the Nédélec space, and
        self.h1 shares the Nédélec quadrature (same q), so
        QPLaplace(h1, α=ε).apply_A == apply_GkH∘apply_M∘apply_Gk to
        machine precision (gated by
        tests/test_gmg.py::test_qp_laplace_is_exactly_Lk; measured
        4e-16 relative at n=4 p=3). The twin's apply is one
        sum-factorized element apply (~30 XLA ops) versus the ~300
        tiny ops of the three-operator chain — the fix for the
        op-issue-latency-bound Chebyshev kernel projector
        (docs/STATUS.md §0d-throughput)."""
        if not hasattr(self, "_qp_L"):
            from bravais_tpu.operators.qplaplace import QPLaplace
            self._qp_L = QPLaplace(self.h1, alpha=self._eps_fn,
                                   dtype=self.dtype)
        return self._qp_L

    def apply_Lk(self, phi: jax.Array, k: jax.Array) -> jax.Array:
        """L φ = Gᴴ M_ε G φ — the quasi-periodic ε-weighted Laplacian
        (computed via the exact :meth:`qp_L` twin; see its docstring)."""
        return self.qp_L().apply_A(phi, k)

    def qp_gmg(self, **kw):
        """Multigrid on the quasi-periodic ε-Laplacian — EXACTLY the
        deflation operator L = Gᴴ M_ε G at the fine level (same
        quadrature), so a few Richardson+V-cycle steps replace the
        ~20-30 Jacobi-CG iterations of the gradient projection.
        Built lazily and cached."""
        if not hasattr(self, "_qpgmg"):
            from bravais_tpu.eigen.gmg import QPGMG
            self._qpgmg = QPGMG(self.h1, alpha=self._eps_fn,
                                dtype=self.dtype, **kw)
        return self._qpgmg

    def gradient_component(self, u: jax.Array, k: jax.Array,
                           cg_iters: int = 25,
                           lprecond=None) -> jax.Array:
        """P u = G L⁻¹ Gᴴ M u — the M-orthogonal projection of ``u``
        onto the gradient subspace (App. C.3). L solved by
        preconditioned CG (``lprecond``: callable r -> z, or None for
        Jacobi) with at most ``cg_iters`` steps AND an early exit on
        tolerance or stagnation. The exit is load-bearing in f32, not
        an optimization: past its floor, the CG recursion keeps
        'converging' while x drifts — measured (ε=30 sphere, round 3):
        16 fixed steps → 20 LOBPCG iterations, but 17 → 67 and
        24 → 121, because the post-floor drift injects range(G) noise
        into every projected block row. For a discrete PHYSICAL
        eigenvector (λ>0), Gᴴ M u = 0 exactly, so P u = 0 regardless
        of the CG tolerance; accuracy only matters for kernel
        directions."""
        rhs = self.apply_GkH(self.apply_M(u, k), k)
        dpc = jnp.asarray(self._h1_diag0)
        pc = lprecond if lprecond is not None else (lambda r: r / dpc)
        rdt = self.rdtype

        x0 = jnp.zeros_like(rhs)
        z0 = pc(rhs)
        rz0 = jnp.vdot(rhs, z0)
        rhs_n = jnp.linalg.norm(rhs.ravel())
        # ‖r_true‖ target: ~30·eps relative — the dtype's honest floor
        # (callers like the f64 refine-stage cleanup rely on
        # near-machine projection; in f32 the best-iterate tracking
        # below makes running to the floor safe).
        rtol = (30.0 * jnp.finfo(rdt).eps * rhs_n).astype(rdt)

        def cond(st):
            x, r, p, rz, bx, brn, i = st
            return jnp.logical_and(i < cg_iters, brn > rtol)

        def body(st):
            x, r, p, rz, bx, brn, i = st
            Ap = self.apply_Lk(p, k)
            # L and the preconditioner are HPD: α, β are real-positive
            # in exact arithmetic. Using the real parts (and requiring
            # a POSITIVE denominator) discards the f32 cancellation
            # noise that otherwise produces huge spurious steps when
            # pᴴLp cancels to ~0 near the solver floor.
            denom = jnp.real(jnp.vdot(p, Ap))
            rzr = jnp.real(rz)
            alpha = jnp.where(denom > 1e-30, rzr / denom, 0.0
                              ).astype(x.dtype)
            x = x + alpha * p
            r = r - alpha * Ap
            z = pc(r)
            rz_new = jnp.vdot(r, z)
            beta = jnp.where(jnp.abs(rzr) > 1e-30,
                             jnp.real(rz_new) / rzr, 0.0
                             ).astype(x.dtype)
            # TRUE residual (fresh L·x): past the f32 floor the CG
            # recursion residual keeps 'converging' while x drifts, so
            # the returned iterate is the argmin of the honest residual
            # over the trajectory — never weaker than any smaller fixed
            # budget, immune to post-floor drift. (No stagnation exit:
            # the true-residual 2-norm legitimately oscillates mid-CG —
            # only the A-norm error is monotone — so a plateau test
            # fires early and returns a weak projection; measured
            # ε=30: plateau-exit → 192 LOBPCG its vs ~20 here.)
            rn = jnp.linalg.norm(
                (rhs - self.apply_Lk(x, k)).ravel()).astype(rdt)
            better = rn < brn
            bx = jnp.where(better, x, bx)
            brn = jnp.minimum(brn, rn)
            return (x, r, z + beta * p, rz_new, bx, brn, i + 1)

        st0 = (x0, rhs, z0, rz0, x0, rhs_n.astype(rdt),
               jnp.asarray(0, jnp.int32))
        phi = jax.lax.while_loop(cond, body, st0)[4]
        return self.apply_Gk(phi, k)

    def cheby_bounds(self) -> tuple:
        """Rigorous spectrum bounds of the mean-twin-preconditioned
        deflation Laplacian: L = GᴴM_εG and L̃ = ε̄·GᴴM₁G weight the
        SAME gradient quadrature, so the generalized Rayleigh quotient
        lies in [min ε/ε̄, max ε/ε̄] exactly."""
        e = np.asarray(self._eps_q64, np.float64)
        ebar = float(np.mean(e))
        return float(e.min()) / ebar, float(e.max()) / ebar

    def cheby_steps(self, target: float = 0.15) -> int:
        """Chebyshev step count for ~``target`` kernel contraction per
        application: m = ⌈ln(2/target)/ln(1/ρ)⌉, ρ = (√κ−1)/(√κ+1).

        ``target`` exists for f64 ORACLE solves (benchmarks/
        certify_dielectric.py): a 1e-9-residual oracle needs kernel
        contraction far below the production 0.15 or the projector
        leakage caps the achievable residual (measured round 5: the
        production-contraction f64 oracle degenerated outright at the
        R point, λ=−3966 kernel collapse). Production paths always use
        the measured 0.15 default below.

        The 0.15 target (was 0.05) is measured, not asserted
        (benchmarks/exp_field_op_budget.py, CUB ε-sphere n=4 p=2,
        production device stop): LOBPCG iterations and refined
        eigenvalue error are IDENTICAL down to contraction ~0.2
        (steps 8→4 at ε=13, 11→5 at ε=30); the cliff sits at ~0.33
        (ε=30 steps=4: 14→19 iters) and ~0.4–0.5 diverges outright
        (ε=30 steps=3: garbage flagged by the f64 certificate at 7.0).
        0.15 keeps ≥2 steps of margin to the cliff at both contrasts
        while cutting the projector's sequential op chain ~40% — the
        dominant per-iteration cost of the dispatch-latency-bound
        varying-ε path."""
        a, b = self.cheby_bounds()
        kappa = b / max(a, 1e-12)
        sq = np.sqrt(max(kappa, 1.0 + 1e-12))
        rho = (sq - 1.0) / (sq + 1.0)
        if rho <= 0.0:
            return 4
        return int(max(4, np.ceil(np.log(2.0 / target)
                                  / np.log(1.0 / rho))))

    def gradient_component_cheby(self, u: jax.Array, k: jax.Array,
                                 steps: int | None = None,
                                 lsolve=None) -> jax.Array:
        """P u ≈ G L⁻¹ Gᴴ M u via PRECONDITIONED CHEBYSHEV on the true
        L = GᴴM_εG with the mean-ε fast-diagonal solve as the
        preconditioner — the varying-ε production projector.

        Why Chebyshev and not (P)CG here: any G·W·GᴴM maps gradients
        to gradients and exactly annihilates physical (M-orthogonal)
        vectors, so the ONLY requirement is that the error polynomial
        contracts on the preconditioned spectrum. Chebyshev with the
        rigorous bounds of :meth:`cheby_bounds` is a FIXED polynomial:
        residual poly r(0)=1 and |r(λ)| ≤ 1 on [0, b] make it
        unconditionally non-amplifying, it needs no inner products
        (no f32 recursion instability — the measured CG knife-edge:
        16 steps → 20 LOBPCG iterations, 17 → 67 at ε=30), and it is
        reduction-free (no serializing reductions)."""
        a, b = self.cheby_bounds()
        if steps is None:
            steps = self.cheby_steps()
        if lsolve is None:
            lsolve = self.fastdiag_L().solver([("L", 1.0)], k,
                                              method="eigh")
        rhs = self.apply_GkH(self.apply_M(u, k), k)
        theta = 0.5 * (b + a)
        delta = max(0.5 * (b - a), 1e-12 * theta)
        sigma = theta / delta
        rho0 = 1.0 / sigma
        d0 = lsolve(rhs) * (1.0 / theta)

        def body(i, st):
            x, r, d, rho = st
            x = x + d
            r = r - self.apply_Lk(d, k)
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = (rho_new * rho) * d + (2.0 * rho_new / delta) * lsolve(r)
            return x, r, d, rho_new

        x, r, d, _ = jax.lax.fori_loop(
            0, steps - 1, body,
            (jnp.zeros_like(rhs), rhs, d0,
             jnp.asarray(rho0, self.rdtype)))
        return self.apply_Gk(x + d, k)

    def project_out_gradients(self, u: jax.Array, k: jax.Array,
                              cg_iters: int = 25,
                              lprecond=None) -> jax.Array:
        """u ← u − P u (divergence-projection deflation)."""
        return u - self.gradient_component(u, k, cg_iters, lprecond)

    @property
    def sigma_shift(self) -> float:
        """σ for the gradient-subspace spectral shift: safely above the
        physical bands of interest (a λ_max-scale Gershgorin-style
        estimate from the diagonals)."""
        return float(np.mean(self._diag_A) / np.mean(self._diag_M))

    def gradient_component_gmg(self, u: jax.Array, k: jax.Array,
                               cycles: int = 3) -> jax.Array:
        """P u via the QP-GMG inner solve (see :meth:`qp_gmg`)."""
        rhs = self.apply_GkH(self.apply_M(u, k), k)
        phi = self.qp_gmg().solve(k, rhs, cycles)
        return self.apply_Gk(phi, k)

    def make_solve_fn(self, cg_iters: int = 25,
                      sigma: float | None = None,
                      deflation_gmg: bool = False,
                      deflation: str | None = None,
                      precond: str | None = None,
                      fd_shift: float | None = None,
                      scale_floor: float | None = None,
                      engine: str = "field",
                      proj_method: str = "chol",
                      pc_rep: str = "inv",
                      inner_iters: int = 3,
                      xp_project: bool = True,
                      rr_tol: float | None | str = "prod",
                      cheby_target: float | None = None) -> Callable:
        """Solve hook for BandSweep: LOBPCG on the gradient-shifted
        operator Ã = A + σ·M P (P = gradient projector).

        Why a SHIFT and not per-iteration projection: A annihilates
        gradients (eigenvalue 0 < every physical band), so any roundoff
        leakage of kernel components into the block gets AMPLIFIED by a
        projected iteration (observed: divergence at the FCC W point
        after ~200 f64 iterations). The shift makes kernel directions
        spectrally repulsive (eigenvalue σ) while leaving physical modes
        untouched EXACTLY (Gᴴ M u_phys = 0), so leakage self-corrects.

        ``deflation``: "cg" (σ-shift; fd-preconditioned CG projector,
        ``cg_iters``), "gmg" (σ-shift; QPGMG cycles), "fastdiag"
        (σ-shift with the direct twisted-DFT solve), "project"
        (per-iteration (I−P) projection with the exact fast-diagonal
        projector — NO σ term; production default for element-invariant
        coefficients), "project-cheby" (per-iteration projection with
        the TRUE-L preconditioned-Chebyshev projector — NO σ term; the
        varying-ε production default: inexact-but-contracting is safe
        because the output lives in range(G), while the mean-twin
        direct solve amplifies), or "project-cg" (CG variant, kept for
        comparison — knife-edge in f32). Why "project"
        beats the shift in f32: P carries absolute noise ~ε/√w₀ from
        the f32 rhs; the shift formulation injects σ·(that noise) into
        every operator apply (measured: an 87-iteration near-Γ crawl at
        n=6 p=3 vs 19 in f64), while under projection the noise lands
        in the kernel where A annihilates it — residuals never see it.
        Projected iterations were unstable in round 1 ONLY because the
        CG-based projector was inexact (divergence at W after ~200
        iters); the spectral fast-diagonal projector removes that.

        ``precond``: None (use the preconditioner the sweep passes in,
        default Jacobi) or "fastdiag" ((A + sM)⁻¹ via the block
        factorization — the hypre-AMS replacement). All fast-diagonal
        pieces are built ONCE per k-point, outside the LOBPCG loop.
        """
        from bravais_tpu.eigen.lobpcg import PROD_RR_TOL, lobpcg

        # f32 residual-scale floor: the ω²→0 bands near Γ cannot reach
        # absolute residuals below the f32 apply-noise floor; the f64
        # host refine certifies their eigenvalues independently, so the
        # device loop may stop at a proportionally looser scale.
        sfloor = scale_floor if scale_floor is not None else (
            0.3 if jnp.dtype(self.dtype) == jnp.complex64 else 3e-2)
        # Rayleigh–Ritz eigh stop: "prod" = the measured production
        # default (PROD_RR_TOL); None = machine precision (oracle runs).
        rr = PROD_RR_TOL if isinstance(rr_tol, str) else rr_tol
        if engine == "spectral":
            return self._make_spectral_solve_fn(fd_shift, sfloor,
                                                proj_method, pc_rep,
                                                rr_tol=rr)
        defl = deflation or ("gmg" if deflation_gmg else "cg")
        if defl == "project" and not self._coef_elem_invariant():
            # The "project" variant feeds the DIRECT fast-diagonal
            # projector into LOBPCG's per-iteration X/P deflation. With
            # varying ε that solver is only the mean-ε TWIN: its error
            # operator I − L̃⁻¹L has eigenvalues up to contrast−1, so
            # per-iteration use AMPLIFIES the kernel (the measured
            # round-2 150-iteration stall at ε=13). Fail loudly instead
            # of silently re-opening that regression.
            raise ValueError(
                "deflation='project' requires element-translation-"
                "invariant coefficients (its direct fast-diagonal "
                "kernel projector is exact only then); use "
                "deflation='project-cheby' for varying eps — the "
                "true-L preconditioned-Chebyshev projector contracts "
                "the kernel at any contrast")
        if defl == "gmg":
            self.qp_gmg()  # build hierarchy eagerly (host setup)
        if defl in ("fastdiag", "project", "project-cg",
                    "project-cheby", "cg"):
            self.fastdiag_L()  # host stencil extraction, cached
            self.qp_L()        # eager twin build (repo rule: never
            #                    first-construct a twin inside a trace)
        if precond in ("fastdiag", "fastdiag-cg"):
            self.fastdiag()

        def solve(op, X0, k, nev, tol, maxiter, precond_in):
            if defl in ("fastdiag", "project"):
                lsolve = op.fastdiag_L().solver([("L", 1.0)], k,
                                                method="eigh")

                def proj(u):
                    rhs = op.apply_GkH(op.apply_M(u, k), k)
                    return op.apply_Gk(lsolve(rhs), k)
            elif defl == "project-cheby":
                # Varying-ε PRODUCTION projection: preconditioned
                # Chebyshev on the true L (gradient_component_cheby
                # docstring for why this beats CG here). Unlike the
                # mean-TWIN direct projector (error operator
                # I − L̃⁻¹L with eigenvalues up to contrast−1 ⇒ kernel
                # AMPLIFICATION, the measured round-2 stall), the
                # Chebyshev polynomial on the rigorous twin bounds
                # contracts the kernel unconditionally, and its output
                # lives in range(G), so it can only ever move the
                # gradient component — per-iteration X/P deflation is
                # safe at any contrast.
                lpc = op.fastdiag_L().solver([("L", 1.0)], k,
                                             method="eigh")
                steps = (None if cheby_target is None
                         else op.cheby_steps(cheby_target))
                proj = partial(op.gradient_component_cheby, k=k,
                               lsolve=lpc, steps=steps)
            elif defl == "project-cg":
                # CG variant of the above (kept for comparison; the
                # Chebyshev projector is the production default — CG's
                # data-dependent recursion is knife-edge in f32, see
                # gradient_component).
                lpc = op.fastdiag_L().solver([("L", 1.0)], k,
                                             method="eigh")
                proj = partial(op.gradient_component, k=k,
                               cg_iters=cg_iters, lprecond=lpc)
            elif defl == "gmg":
                proj = partial(op.gradient_component_gmg, k=k)
            else:
                # CG on the TRUE deflation Laplacian, preconditioned by
                # the mean-ε fast-diagonal solve (contrast-bounded κ ⇒
                # near-exact projection in few iterations at any ε).
                lpc = op.fastdiag_L().solver([("L", 1.0)], k,
                                             method="eigh")
                proj = partial(op.gradient_component, k=k,
                               cg_iters=cg_iters, lprecond=lpc)
            X0p = X0 - jax.vmap(proj)(X0)

            if precond == "fastdiag":
                pc = op.fd_precond(k, shift=fd_shift)
            elif precond == "fastdiag-cg":
                # inner_iters=3 production default: measured iteration-
                # neutral vs 4 (and even 2) at ε ∈ {13, 30} with
                # unchanged refined accuracy (exp_field_op_budget.py);
                # 3 keeps one measured step of margin while cutting the
                # inner-PCG op chain 25%.
                pc = op.fd_precond_cg(k, shift=fd_shift,
                                      inner_iters=inner_iters)
            else:
                pc = precond_in

            if defl in ("project", "project-cg", "project-cheby"):
                pc_proj = ((lambda R: (lambda z: z - proj(z))(pc(R)))
                           if pc is not None else
                           (lambda R: R - proj(R)))
                # Per-iteration X/P deflation needs a projector that
                # CONTRACTS the kernel: the exact fast-diagonal solve
                # ("project", element-invariant ε) or true-L PCG
                # ("project-cg", any ε). The mean-TWIN direct solve
                # must NOT be used here (kernel amplification up to
                # contrast−1 per iteration — the measured round-2
                # 150-iteration stall at ε=13).
                # ``xp_project=False`` drops the per-iteration X/P
                # deflation (the 2m-row projector call), keeping only
                # the W-side projection inside the preconditioner.
                # MEASURED CATASTROPHIC (round 4d, CUB ε-sphere n=4
                # p=2): spurious kernel modes take over the block
                # (rel_err ~1.0 vs the dense direct solve at every
                # contrast; warm chains collapse to ~0 eigenvalues) —
                # RR-recombination roundoff alone feeds the kernel
                # faster than W-side projection drains it. The X/P
                # deflation is LOAD-BEARING; the knob exists to keep
                # that fact measurable, not for production use.
                kproj = proj if xp_project else None
                return lobpcg(lambda x: op.apply_A(x, k),
                              lambda x: op.apply_M(x, k), X0p,
                              nev, maxiter=maxiter, tol=tol,
                              precond=pc_proj, scale_floor=sfloor,
                              kernel_project=kproj,
                              rr_tol=rr)

            if sigma is not None:
                sig_val = sigma
            elif precond in ("fastdiag", "fastdiag-cg"):
                # σ matched to the fd-preconditioner scale for BOTH the
                # direct and the inner-PCG preconditioner variants: the
                # λmax-scale default was measured to TRIPLE iteration
                # counts under fd preconditioning (fd_sigma docstring) —
                # round 2 ran the varying-ε config ("fastdiag-cg") with
                # the wrong branch (81–120 iters/k at ε=13).
                sig_val = op.fd_sigma(X0.shape[0])
            else:
                sig_val = op.sigma_shift
            sig = jnp.asarray(sig_val, op.rdtype)

            def A_shifted(x):
                return op.apply_A(x, k) + sig * op.apply_M(proj(x), k)

            return lobpcg(A_shifted, lambda x: op.apply_M(x, k), X0p,
                          nev, maxiter=maxiter, tol=tol, precond=pc,
                          scale_floor=sfloor, rr_tol=rr)

        return solve

    def _make_spectral_solve_fn(self, fd_shift, sfloor,
                                proj_method: str = "qr",
                                pc_rep: str = "inv",
                                rr_tol: float | None = None) -> Callable:
        """LOBPCG run ENTIRELY in the twisted-DFT block basis — the
        dense batched-GEMM path for element-translation-invariant coefficients
        (every empty-lattice config, incl. the headline benchmark).

        One transform in, one transform out; every per-iteration
        operation (A, M, the exact gradient projector, the (A+sM)⁻¹
        preconditioner) is a batched D×D block matvec. F/√(Πn) is
        unitary, so the pencil in block coordinates is unitarily
        similar to (A, M): identical eigenvalues, identical relative
        residuals; eigenvectors are back-transformed at the end.
        """
        from bravais_tpu.eigen.jacobi_eigh import jacobi_eigh
        from bravais_tpu.eigen.lobpcg import lobpcg

        if not self._coef_elem_invariant():
            raise ValueError(
                "engine='spectral' requires element-translation-"
                "invariant coefficients; use the field engine")
        self.fastdiag_G()  # host stencil extraction (A, M, G), cached

        def build_pc(op, k, TATM=None):
            """(A+sM)⁻¹ preconditioner blocks at k — the largest piece
            of per-k setup (blocks + batched Cholesky + triangular
            inverse). ``pc_rep`` picks the representation:

            * "factor" — return the triangular factor
              Yc = L⁻¹ only; the preconditioner applies as Ycᴴ(Yc·R),
              two batched GEMMs per call. Skips the explicit YcᴴYc
              product in setup (a (B, D, D)×(B, D, D) batched matmul,
              ~29 GFLOP at the n=8 p=4 headline) at the price of one
              extra skinny GEMM per LOBPCG iteration (~2.4 GFLOP at
              m=16) — a net win whenever iters/k stays below ~10.
            * "inv" (default) — the explicit inverse YcᴴYc; one GEMM
              per apply.

            Exposed separately so chain launches can build it ONCE per
            launch (at the middle k of the chain) and reuse it across
            the chain's solves: it is only a preconditioner, so a few-k
            staleness costs at most a few extra iterations while saving
            the build at every other k."""
            fd = op.fastdiag_G()
            s_ = float(fd_shift if fd_shift is not None
                       else op.default_fd_shift())
            import jax.scipy.linalg as _jsl
            if TATM is not None:
                # Reuse the solve's already-built (TA, TM): one device
                # add instead of a third stencil-GEMM + (B, D, D) HBM
                # write per k.
                Tsh = TATM[0] + jnp.asarray(s_, op.rdtype) * TATM[1]
            else:
                Tsh = fd.blocks([("A", 1.0), ("M", s_)], k)
            Lc = jnp.linalg.cholesky(Tsh)
            eyeD = jnp.broadcast_to(
                jnp.eye(Tsh.shape[-1], dtype=Tsh.dtype), Tsh.shape)
            Yc = _jsl.solve_triangular(Lc, eyeD, lower=True)
            if pc_rep == "factor":
                return Yc
            return jnp.conj(jnp.swapaxes(Yc, -1, -2)) @ Yc

        def bmv(T, x):
            return jnp.einsum("bij,bj->bi", T, x)

        def proj_state(TM, TG, TGH):
            """k-dependent factor/spectral state of the exact gradient
            projector (the ~14 ms piece of per-k setup) — split out so
            ``build_setup`` can batch it chain-wide (vmap) exactly like
            the preconditioner blocks."""
            if proj_method == "chol":
                # Direct Cholesky of L = ĜᴴM̂Ĝ (Dh1×Dh1) — 3× cheaper
                # to build than the Cholesky-QR route (measured 13 vs
                # 42 ms at n=8 p=4: one chol(64) instead of chol(192) +
                # QR(192×64)). Forming L squares κ(W), but κ(W) ≈ 60 at
                # the standard 2e-2 Γ-nudge — far below the 1/√eps_f32
                # ≈ 4000 where Cholesky-QR starts to matter. A relative
                # δ-regularization keeps f32 chol stable through the
                # near-singular nudged-Γ block (resolves w/w̄ ≥ ~2e-7);
                # directions at/below δ (the exact-Γ harmonic) are
                # zeroed via the same huge-diagonal trick as the QR
                # guard rather than amplified by 1/δ.
                Lb = TGH @ (TM @ TG)                # (B, Dh1, Dh1)
                trm = jnp.real(jnp.trace(Lb, axis1=-2, axis2=-1)
                               ) / Lb.shape[-1]
                delta = (1e-7 * trm).astype(self.rdtype)
                Lreg = Lb + delta[:, None, None] * jnp.eye(
                    Lb.shape[-1], dtype=Lb.dtype)
                Rl = jnp.linalg.cholesky(Lreg)      # lower
                dg = jnp.real(jnp.diagonal(Rl, axis1=-2, axis2=-1))
                big = jnp.max(dg) / jnp.asarray(
                    jnp.finfo(self.rdtype).eps, self.rdtype)
                # Floor delta at finfo.tiny and compare with <=: a
                # whole (near-)zero L block has trace ≈ 0 ⇒ delta ≈ 0,
                # and a strict '<' against 2·delta could never fire —
                # solve_triangular would then divide by a ~0 Cholesky
                # diagonal instead of zeroing the direction (only
                # reachable at un-nudged exact-Γ).
                dfloor = jnp.maximum(delta, jnp.asarray(
                    jnp.finfo(self.rdtype).tiny, self.rdtype))
                tiny = (dg * dg) <= (2.0 * dfloor)[:, None]
                return Rl + ((tiny * big).astype(Rl.dtype)[..., None]
                             * jnp.eye(Rl.shape[-1], dtype=Rl.dtype))
            if proj_method == "qr":
                # Cholesky-QR projector: W = chol(M̂)ᴴ Ĝ = QR gives
                # L = ĜᴴM̂Ĝ = RᴴR, so L⁻¹ = R⁻¹R⁻ᴴ via two batched
                # triangular solves. κ(R) = √κ(L) — numerically on par
                # with the spectral pseudo-inverse, and cheaper than the
                # batched Jacobi eigh of L. Rank drop at θ→0 (the
                # exact-Γ harmonic point) guarded by pushing tiny R
                # diagonals to a huge value, which zeroes those
                # directions in the solve — the pinv truncation.
                C = jnp.linalg.cholesky(TM)
                W = jnp.conj(jnp.swapaxes(C, -1, -2)) @ TG
                _, Rq = jnp.linalg.qr(W)
                dg = jnp.abs(jnp.diagonal(Rq, axis1=-2, axis2=-1))
                big = jnp.max(dg) / jnp.asarray(
                    jnp.finfo(self.rdtype).eps, self.rdtype)
                tiny = dg < 1e-7 * jnp.max(dg, axis=-1, keepdims=True)
                return Rq + ((tiny * big).astype(Rq.dtype)[..., None]
                             * jnp.eye(Rq.shape[-1], dtype=Rq.dtype))
            Lb = TGH @ TM @ TG                        # (B, Dh1, Dh1)
            w, V = jacobi_eigh(Lb)
            good = w > 0.0
            winv = jnp.where(good, 1.0 / jnp.where(good, w, 1.0), 0.0)
            return (winv, V)

        def make_proj(TM, TG, TGH, pst):
            import jax.scipy.linalg as jsl
            if proj_method == "chol":
                Rl = pst

                def proj(x):
                    r = bmv(TGH, bmv(TM, x))
                    z = jsl.solve_triangular(Rl, r[..., None],
                                             lower=True)
                    phi = jsl.solve_triangular(Rl, z, lower=True,
                                               trans='C')
                    return bmv(TG, phi[..., 0])
            elif proj_method == "qr":
                Rq = pst

                def proj(x):
                    r = bmv(TGH, bmv(TM, x))
                    z = jsl.solve_triangular(Rq, r[..., None],
                                             lower=False, trans='C')
                    phi = jsl.solve_triangular(Rq, z, lower=False)
                    return bmv(TG, phi[..., 0])
            else:
                winv, V = pst
                VH = jnp.conj(jnp.swapaxes(V, -1, -2))

                def proj(x):
                    r = bmv(TGH, bmv(TM, x))
                    phi = bmv(V, winv.astype(x.dtype) * bmv(VH, r))
                    return bmv(TG, phi)
            return proj

        def build_setup(op, k):
            """The FULL per-k device setup as one vmappable pytree:
            (TA, TM, TG) stencil blocks, (A+sM)⁻¹ preconditioner, and
            the gradient-projector factor. Chain launches build this
            for every chain k in ONE batched call before the scan
            (sweep pc-mode "batched-setup"), amortizing the whole
            latency-bound ~85 ms/k setup (STATUS §6 gap 1: ~45 ms pc +
            ~14 ms projector + ~9 ms assembly) at the price of chain×
            the setup working set (~520 MB/k at the n=8 p=4 headline:
            3×(B,D,D) + (B,D,Dh1) + (B,Dh1,Dh1) complex64)."""
            fd = op.fastdiag_G()
            TA = fd.blocks([("A", 1.0)], k)
            TM = fd.blocks([("M", 1.0)], k)
            TG = fd.blocks([("G", 1.0)], k)          # (B, Dnd, Dh1)
            TGH = jnp.conj(jnp.swapaxes(TG, -1, -2))
            Tpc = build_pc(op, k, (TA, TM))
            return (TA, TM, TG, Tpc, proj_state(TM, TG, TGH))

        def solve(op, X0, k, nev, tol, maxiter, precond_in, pc=None,
                  setup=None):
            fd = op.fastdiag_G()
            theta = fd._theta(k)
            F = fd._fwd_mats(theta)
            if setup is not None:
                TA, TM, TG, Tpc, pst = setup
                TGH = jnp.conj(jnp.swapaxes(TG, -1, -2))
            else:
                TA = fd.blocks([("A", 1.0)], k)
                TM = fd.blocks([("M", 1.0)], k)
                TG = fd.blocks([("G", 1.0)], k)      # (B, Dnd, Dh1)
                TGH = jnp.conj(jnp.swapaxes(TG, -1, -2))
                # (A+sM)⁻¹ via Cholesky (HPD): half the LU-inverse
                # flops; preconditioner-level accuracy is all that's
                # needed.
                # ``pc``: a prebuilt (possibly neighboring-k) block
                # inverse from build_pc.
                Tpc = build_pc(op, k, (TA, TM)) if pc is None else pc
                pst = proj_state(TM, TG, TGH)
            proj = make_proj(TM, TG, TGH, pst)

            if pc_rep == "factor":
                def pcond(R):
                    # Tpc is the triangular factor Yc = L⁻¹:
                    # (A+sM)⁻¹R = Ycᴴ(Yc·R) — adjoint GEMM via einsum
                    # (no materialized (B, D, D) transpose).
                    z = jnp.einsum("bji,bj->bi", jnp.conj(Tpc),
                                   bmv(Tpc, R))
                    return z - proj(z)
            else:
                def pcond(R):
                    z = bmv(Tpc, R)
                    return z - proj(z)

            X0b = jax.vmap(lambda x: fd.to_blocks(x, F))(X0)
            X0b = X0b - jax.vmap(proj)(X0b)
            res = lobpcg(lambda x: bmv(TA, x), lambda x: bmv(TM, x),
                         X0b, nev, maxiter=maxiter, tol=tol,
                         precond=pcond, scale_floor=sfloor,
                         kernel_project=proj, rr_tol=rr_tol)
            # Block support of each converged row — the tiny (m, B)
            # array the f64 spectral refine needs instead of the full
            # eigenvector block (spectral_refine_np).
            support = jnp.sum(jnp.abs(res.eigenvectors) ** 2, axis=-1)
            Xf = jax.vmap(lambda v: fd.from_blocks(v, F, squeeze=False)
                          )(res.eigenvectors)
            return res._replace(eigenvectors=Xf), support

        solve.provides_support = True
        solve.refine_np = self.spectral_refine_np
        solve.build_pc = build_pc
        solve.build_setup = build_setup
        return solve

    # ------------------------------------------------------------------
    # diagonals (k-independent: |phase| = 1)
    # ------------------------------------------------------------------

    def diag_A(self, k: jax.Array = None) -> jax.Array:
        return jnp.asarray(self._diag_A)

    @property
    def diag_M(self) -> np.ndarray:
        return self._diag_M

    def _build_diagonals(self):
        sp = self.space
        rd = np.dtype(self.rdtype)
        wmu = sp.quad_weight() * self._mu_inv_q64
        weps = sp.quad_weight() * self._eps_q64
        Bo, Do = sp.open.B, sp.open.D
        Bc, Dc = sp.closed.B, sp.closed.D
        J = sp.grid.J
        JtJ = J.T @ J
        det2 = np.linalg.det(J) ** 2
        eye = np.eye(3)

        def scat(r, c):
            return tensor.scatter_add_np(r, sp.grid.shape, (sp.p,) * 3,
                                         sp.flags(c))

        diag_A = []
        diag_M = []
        for c in range(3):
            dcurl = 0.0
            for s in range(3):
                for s2 in range(3):
                    if s == c or s2 == c:
                        continue
                    Kss = (np.cross(eye[s], eye[c]) @ JtJ
                           @ np.cross(eye[s2], eye[c])) / det2
                    tabs = []
                    for i in range(3):
                        if i == c:
                            a = Do if s == i else Bo
                            b = Do if s2 == i else Bo
                        else:
                            a = Dc if s == i else Bc
                            b = Dc if s2 == i else Bc
                        tabs.append(a * b)
                    dcurl = dcurl + Kss * tensor.contract_t_np(wmu, tabs)
            diag_A.append(scat(dcurl, c))
            Gcc = sp.grid.Ginv[c, c]
            btabs = [(Bo * Bo) if i == c else (Bc * Bc) for i in range(3)]
            diag_M.append(scat(Gcc * tensor.contract_t_np(weps, btabs), c))
        return (np.stack(diag_A).real.astype(rd),
                np.stack(diag_M).real.astype(rd))
