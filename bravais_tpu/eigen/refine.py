"""Host float64 Rayleigh–Ritz refinement.

The f32 LOBPCG converges residuals to ~1e-5 and eigenvalues to ~3e-6
relative (the f32 Rayleigh–Ritz noise floor). One final Rayleigh–Ritz in
float64 on the HOST — using the operators' matrix-free NumPy twins —
recovers eigenvalues to ~residual²/gap accuracy (≪1e-6), implementing
the precision plan of SURVEY.md §7.0 item d without an f64 device
solve.

Cost per k-point: ``rows`` applies of A and M on host (the per-k
critical path of every sweep whose engine lacks the spectral refine —
the whole varying-ε dielectric axis) plus a rows×rows Hermitian
eigensolve. Eigenvector blocks cross the device boundary as stacked
[Re, Im] real arrays (utils/reim.py).

Maxwell gradient-kernel handling: guard rows from
maxiter-exhausted f32 solves can carry (∇+ik)φ components whose
Rayleigh quotient ~0 would surface as a spurious low band. Two
mechanisms, chosen by coefficient structure:

* element-invariant ε — exact direct fast-diagonal projection of the
  block (batched, milliseconds);
* varying ε — σ-SHIFT of the gradient subspace inside the Rayleigh–
  Ritz: Ĝ_A ← Ĝ_A + σ·Kp with Kp = ⟨GᴴM x_i, L̃⁻¹ GᴴM x_j⟩ and L̃ the
  mean-ε twin solve. The shift term vanishes EXACTLY on physical
  vectors (A x = λ M x, λ≠0 ⇒ GᴴM x = 0) for ANY HPD L̃, while every
  gradient direction is pushed up by ≥ σ·(min ε/ε̄) — so exactness
  does not depend on twin quality, only the repulsion margin does.
  This replaced the per-row true-L preconditioned CG projection
  (measured 2.3 s of the 4.6 s host refine at the n=6 p=3 dielectric
  production size — per-k critical-path work). Reported eigenvalues
  are the ORIGINAL-pencil Rayleigh quotients of the shifted-pencil
  Ritz vectors, and the residual certificate is computed against the
  original pencil, so suppressed-but-nonzero leakage stays visible.
  Accuracy trade (unlike the exact projection): the eigenvalue error
  is SECOND order in the block's gradient leakage ε — measured ~17·ε²
  relative (tests/test_fastdiag.py sigma-shift test). Production
  leakage after the device's per-iteration contracting kernel
  projection is ≤1e-4, keeping the error below the 1e-6 production
  bar (gated by the ε=13/30 f32-certification tests).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.linalg

from bravais_tpu.utils.reim import from_reim_np

__all__ = ["host_rayleigh_ritz"]


def host_rayleigh_ritz(op, X_reim: np.ndarray, k: np.ndarray, nev: int,
                       rows: Optional[int] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """f64 Rayleigh–Ritz of the pencil (A(k), M) on span(X[:rows]).

    ``X_reim``: (2, m, *dof_shape) real-stacked eigenvector block from
    the device solve, rows ascending by device Ritz value. ``rows``
    (default nev+2, capped at m) restricts the subspace to the lowest
    rows — the guard tail refines bands that are discarded anyway,
    and every host apply here is per-k critical-path time. Returns
    (eigenvalues[:nev], residuals[:nev]) where residuals are relative
    f64 residual norms — an independent a-posteriori accuracy
    certificate for each band.
    """
    X = from_reim_np(np.asarray(X_reim)).astype(np.complex128)
    rows = min(X.shape[0], rows if rows is not None else nev + 2)
    X = X[:rows]
    m = X.shape[0]
    k = np.asarray(k, np.float64)
    is_maxwell = (hasattr(op, "gradient_component_np")
                  and min(op.space.grid.shape) >= 3)
    invariant = is_maxwell and op._coef_elem_invariant()
    if invariant:
        # Exact direct fast-diagonal projection (batched, cheap).
        X = X - op.gradient_component_np(X, k)
    Xf = X.reshape(m, -1)

    if getattr(op, "supports_batched_np", False):
        AXs = np.asarray(op.apply_A_np(X, k))
        MXs = np.asarray(op.apply_M_np(X, k))
    else:
        AXs = np.stack([op.apply_A_np(x, k) for x in X])
        MXs = np.stack([op.apply_M_np(x, k) for x in X])
    AX = AXs.reshape(m, -1)
    MX = MXs.reshape(m, -1)
    GA = Xf.conj() @ AX.T
    GM = Xf.conj() @ MX.T
    GA = 0.5 * (GA + GA.conj().T)
    GM = 0.5 * (GM + GM.conj().T)
    GAs = GA
    if is_maxwell and not invariant:
        # Varying-ε Maxwell: σ-shift of the gradient subspace (see
        # module docstring). σ is the fd_sigma band-scale estimate
        # divided by the twin lower bound a = min ε/ε̄, so the shifted
        # gradient floor σ·a keeps fd_sigma's ≥2.5× margin over the
        # nev-th band at any contrast.
        a, _ = op.cheby_bounds()
        sigma = op.fd_sigma(m) / max(a, 1e-12)
        C = op.apply_GkH_np(MXs, k)               # (m, N₁,N₂,N₃) H1
        lsolve = op.fastdiag_L().solver_np([("L", 1.0)], k)
        Z = lsolve(C)
        Cf = C.reshape(m, -1)
        Zf = Z.reshape(m, -1)
        Kp = Cf.conj() @ Zf.T
        GAs = GA + sigma * 0.5 * (Kp + Kp.conj().T)
    # Guard against (near-)dependent columns from the f32 solve.
    w, V = scipy.linalg.eigh(GM)
    good = w > 1e-10 * w.max()
    C_ = V[:, good] / np.sqrt(w[good])
    H = C_.conj().T @ GAs @ C_
    theta, Y = scipy.linalg.eigh(0.5 * (H + H.conj().T))
    nev_req = nev
    nev = min(nev, theta.size)
    coeff = C_ @ Y[:, :nev]                     # (m, nev)
    # Eigenvalues: ORIGINAL-pencil Rayleigh quotients of the Ritz
    # vectors (coeff is GM-orthonormal) — drops the +σ‖leak‖² bias of
    # the shifted pencil's Ritz values (zero when no shift was used).
    lam = np.real(np.diag(coeff.conj().T @ GA @ coeff))
    order = np.argsort(lam)
    lam = lam[order]
    coeff = coeff[:, order]
    AXr = coeff.T @ AX
    MXr = coeff.T @ MX
    R = AXr - lam[:, None] * MXr
    scale = np.maximum(np.abs(lam), max(3e-2 * np.abs(lam).max(), 1e-3))
    res = np.linalg.norm(R, axis=1) / scale
    if nev < nev_req:
        # Rank-deficient block (degenerate device exit): keep the fixed
        # output contract — pad with the top value and an unconverged
        # residual sentinel (finite; res>=1e6 is the failure signal).
        pad = nev_req - nev
        top = lam[-1] if nev else 0.0
        lam = np.concatenate([lam, np.full(pad, top)])
        res = np.concatenate([res, np.full(pad, 1e6)])
    return lam, res
