"""Batched Hermitian eigensolver via cyclic (round-robin) Jacobi.

Used in place of ``jnp.linalg.eigh`` inside the LOBPCG Rayleigh–Ritz
(see SURVEY.md §7.2 item 1 context) for its accuracy on graded
matrices: a Rayleigh–Ritz matrix whose W-block carries Rayleigh
quotients up to λ_max(A) has a wide spectral range, and in f32 a
QDWH-style eigh can lose its LOW eigenvalues. Two-sided Jacobi inherits
the graded-matrix relative accuracy of Demmel–Veselić: rotations compare
entries locally, so small eigenvalues survive a large ‖H‖. The kernel is
a while_loop of small matmuls, cheap to compile. Whether the GPU's
``jnp.linalg.eigh`` (cuSOLVER) can take its place is an open question
(its time at the production shape is recorded by chip_smoke.py).

Algorithm: fixed ``sweeps`` of n−1 round-robin rounds; each round
applies n/2 disjoint complex Givens rotations simultaneously as one
n×n rotation matrix (3 small matmuls) — batched/vmap-friendly, static
shapes. Converges quadratically; 10 sweeps is ample for n ≤ 64 in f32.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["jacobi_eigh"]


@lru_cache(maxsize=None)
def _round_robin_schedule(n: int) -> np.ndarray:
    """(n-1, 2, n//2) int32: per round, the (top, bottom) index rows of
    the classic circle-method tournament pairing. n must be even."""
    assert n % 2 == 0
    others = list(range(1, n))
    rounds = []
    for r in range(n - 1):
        rot = others[r:] + others[:r]
        lst = [0] + rot
        top = lst[: n // 2]
        bot = lst[n // 2:][::-1]
        rounds.append([top, bot])
    return np.asarray(rounds, dtype=np.int32)


@lru_cache(maxsize=None)
def _perm_chain(n: int):
    """Static per-round permutations for the scatter-free sweep.

    Round r pairs (p_j, q_j) (p=min, q=max of the tournament pairing).
    ``P_r`` maps original coordinates into the canonical pair layout
    [p_0..p_{h-1}, q_0..q_{h-1}] (h = n/2): (P H Pᵀ)[j, j+h] = H[p_j,
    q_j]. Returns (P0, Qs, Plast) with Q_r = P_r @ P_{r-1}ᵀ the
    layout-r-1 → layout-r transition — all {0,1} float32 constants, so
    every per-round index operation becomes a small constant matmul
    instead of a traced-index scatter/gather."""
    sched = _round_robin_schedule(n)
    h = n // 2
    Ps = []
    for r in range(n - 1):
        top, bot = sched[r]
        p = np.minimum(top, bot)
        q = np.maximum(top, bot)
        P = np.zeros((n, n), np.float32)
        P[np.arange(h), p] = 1.0
        P[np.arange(h, n), q] = 1.0
        Ps.append(P)
    # T_r folds the layout-r → layout-r+1 transition into the round-r
    # rotation (C_r = B_r T_r, one matmul instead of a separate
    # two-sided Q conjugation); the last T re-enters the ORIGINAL
    # layout so the sweep body is layout-closed.
    Ts = [Ps[r] @ Ps[r + 1].T for r in range(n - 2)] + [Ps[-1]]
    return Ps[0], Ts


def jacobi_eigh(H: jax.Array, sweeps: int = 24,
                rel_tol: float | None = None):
    """Eigendecomposition of a Hermitian matrix (..., n, n).

    Returns (w, V): w (..., n) real ascending, V (..., n, n) with
    columns the eigenvectors, H ≈ V diag(w) Vᴴ. Odd n is padded
    internally. Pure jax; jit/vmap-safe. Runs until the off-diagonal
    Frobenius mass drops below ~eps·‖H‖ or ``sweeps`` sweeps (cap —
    ill-conditioned whitening Grams genuinely need >10).

    ``rel_tol``: optional looser Rutishauser stop — converged when
    every |H_ij| ≤ rel_tol·√|H_ii H_jj| (default: machine eps).
    Callers whose downstream use is subspace-iterative (the LOBPCG
    Rayleigh–Ritz: errors self-correct through the next iteration's
    re-whitening) can save the final quadratic-convergence sweeps;
    callers that use (w, V) as an exact factorization (fastdiag
    stencil eigenbases, spectral projectors) must keep the default.
    """
    n0 = H.shape[-1]
    cdtype = H.dtype
    rdtype = jnp.finfo(cdtype).dtype
    n = n0 + (n0 % 2)
    if n != n0:
        # Pad with a DECOUPLED row/col (zero off-diagonals, so every
        # rotation touching it is the identity) whose diagonal exceeds
        # the spectrum (Gershgorin) — it sorts last and is sliced off.
        big = 2.0 * jnp.max(jnp.sum(jnp.abs(H), axis=-1)) + 1.0
        pad = [(0, 0)] * (H.ndim - 2) + [(0, 1), (0, 1)]
        H = jnp.pad(H, pad)
        idx = (Ellipsis, n0, n0)
        H = H.at[idx].set(big.astype(cdtype))

    eye = jnp.eye(n, dtype=cdtype)
    batch_shape = H.shape[:-2]
    V = jnp.broadcast_to(eye, batch_shape + (n, n))

    # Scatter-free sweep: a formulation that scans over the tournament
    # schedule with TRACED pair indices lowers every round to dynamic
    # scatters/gathers, a chain of latency-bound small ops. Here each
    # round r instead
    # conjugates by a STATIC permutation into the canonical pair layout
    # [p_0..p_{h-1} | q_0..q_{h-1}]: pair data live on the diagonal and
    # the ±h off-diagonals (plain jnp.diagonal reads), and the rotation
    # matrix B is built from constant {0,1} masks by elementwise
    # multiplies — every per-round op is a small constant matmul or an
    # elementwise op; no scatter, no gather, no traced index.
    h = n // 2
    P0, Ts = _perm_chain(n)
    P0c = jnp.asarray(P0, cdtype)
    Tcs = [jnp.asarray(T, cdtype) for T in Ts]
    supmask = jnp.asarray(np.eye(n, k=h), cdtype)
    submask = jnp.asarray(np.eye(n, k=-h), cdtype)
    tiny = jnp.asarray(jnp.finfo(rdtype).tiny, rdtype) * 100

    def _rot_B(Hp):
        """Block rotation in the canonical pair layout: B[j,j] =
        B[j+h,j+h] = c_j, B[j,j+h] = s_j, B[j+h,j] = -s̄_j."""
        d = jnp.real(jnp.diagonal(Hp, axis1=-2, axis2=-1))
        app, aqq = d[..., :h], d[..., h:]
        apq = jnp.diagonal(Hp, offset=h, axis1=-2, axis2=-1)
        absa = jnp.abs(apq)
        safe = absa > tiny
        phase = jnp.where(safe, apq / jnp.where(safe, absa, 1.0), 1.0 + 0j)
        tau = (aqq - app) / (2.0 * jnp.where(safe, absa, 1.0))
        # sign(0) must be +1 here (τ=0 ⇒ the full 45° rotation).
        sgn = jnp.where(tau >= 0, 1.0, -1.0).astype(rdtype)
        t = sgn / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau))
        t = jnp.where(safe, t, 0.0)
        c = jax.lax.rsqrt(1.0 + t * t)
        s = (t * c).astype(cdtype) * phase         # complex sine
        cc = c.astype(cdtype)
        cfull = jnp.concatenate([cc, cc], axis=-1)
        ssup = jnp.concatenate([jnp.zeros_like(s), s], axis=-1)
        ssub = jnp.concatenate([-jnp.conj(s), jnp.zeros_like(s)], axis=-1)
        return (eye * cfull[..., None, :]
                + supmask * ssup[..., None, :]
                + submask * ssub[..., None, :])

    eps2 = jnp.asarray(rel_tol if rel_tol is not None
                       else jnp.finfo(rdtype).eps, rdtype) ** 2

    def not_done(state):
        # Relative (Rutishauser) criterion: converged when every
        # |H_ij|² ≤ eps² |H_ii H_jj|. Absolute criteria are NOT enough:
        # whitening divides by sqrt(w), amplifying absolute-level
        # residual couplings between small and large eigenvalues.
        H, V, i = state
        d = jnp.abs(jnp.diagonal(H, axis1=-2, axis2=-1))
        tiny = jnp.asarray(jnp.finfo(rdtype).tiny, rdtype) * 1e6
        dd = jnp.maximum(d[..., :, None] * d[..., None, :], tiny)
        ratio = jnp.abs(H) ** 2 / dd
        n_ = H.shape[-1]
        offmask = 1.0 - jnp.eye(n_, dtype=rdtype)
        worst = jnp.max(ratio * offmask)
        return jnp.logical_and(i < sweeps, worst > eps2)

    def one_sweep(state):
        H, V, i = state
        Hp = P0c @ H @ P0c.T
        Vp = V @ P0c.T
        for r in range(n - 1):
            C = _rot_B(Hp) @ Tcs[r]
            CH = jnp.conj(jnp.swapaxes(C, -1, -2))
            Hp = CH @ Hp @ C
            # Re-hermitize the touched structure cheaply.
            Hp = 0.5 * (Hp + jnp.conj(jnp.swapaxes(Hp, -1, -2)))
            Vp = Vp @ C
        # Tcs[-1] re-entered the original layout: Hp/Vp ARE H/V.
        return (Hp, Vp, i + 1)

    H, V, _ = jax.lax.while_loop(not_done, one_sweep,
                                 (H, V, jnp.asarray(0, jnp.int32)))

    w = jnp.real(jnp.diagonal(H, axis1=-2, axis2=-1))
    order = jnp.argsort(w, axis=-1)
    w = jnp.take_along_axis(w, order, axis=-1)
    V = jnp.take_along_axis(V, order[..., None, :], axis=-1)
    if n != n0:  # drop the decoupled pad (sorted last; e_{n0} vector)
        w = w[..., :n0]
        V = V[..., :n0, :n0]
    return w, V
