"""Complex LOBPCG eigensolver — fixed-shape, jit/vmap-compatible.

The rebuild's replacement for hypre's BLOPEX LOBPCG (SURVEY.md §2.2 #13,
App. C.2): finds the lowest ``nev`` eigenpairs of the Hermitian pencil
(A, M), A x = λ M x, with

* a block of ``m = nev + guard`` vectors (band/block parallelism — the
  block axis turns every matvec and Gram product into a GEMM, §2.3);
* soft locking by masking (shapes never change, so one XLA program
  serves every k-point and the whole solver can sit under vmap/shard_map);
* basis stabilization in the Rayleigh–Ritz step following the
  Duersch–Shao–Yang approach: eigendecomposition-based whitening of the
  S-basis Gram matrix with spectral-threshold dropping of near-null
  directions (critical in float32 — precision plan SURVEY.md §7.0 item 4).

Conventions: block arrays are (m, N) with each ROW a vector;
⟨x, y⟩ = conj(x)·y; Gram G[i, j] = ⟨s_i, Op s_j⟩ = (conj(S) @ (Op S).T).
A new basis with coefficient matrix C (t_β = Σ_i C[i, β] s_i) has rows
T = C.T @ S and Gram C^H G C.

The operator interface is functional: ``A(X)`` and ``M(X)`` map blocks
``(m, *dof_shape) -> same shape``; preconditioner ``P(R)`` likewise.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from bravais_tpu.eigen.jacobi_eigh import jacobi_eigh

__all__ = ["lobpcg", "LobpcgResult"]


class LobpcgResult(NamedTuple):
    eigenvalues: jax.Array     # (nev,) real, ascending
    eigenvectors: jax.Array    # (m, *dof_shape) — first nev rows converged
    iterations: jax.Array      # () int32
    residual_norms: jax.Array  # (nev,) relative residual norms at exit
    converged: jax.Array       # (nev,) bool


class _Carry(NamedTuple):
    X: jax.Array
    AX: jax.Array
    MX: jax.Array
    P: jax.Array
    AP: jax.Array
    MP: jax.Array
    res: jax.Array
    it: jax.Array
    done: jax.Array


def _flatten_op(op, dof_shape):
    """Lift an op on (*dof_shape,) fields, vmapped over the block axis,
    to an op on (m, N) matrices."""
    def f(X):
        Y = jax.vmap(lambda x: op(x.reshape(dof_shape)))(X)
        return Y.reshape(X.shape[0], -1)
    return f


#: Production Rayleigh–Ritz eigh stop (see ``lobpcg`` ``rr_tol``):
#: measured ITERATION- AND ACCURACY-NEUTRAL up to 1e-3 on both engines
#: (benchmarks/exp_rr_tol.py — spectral FCC vs analytic, field
#: dielectric ε ∈ {13, 30} vs complex128 direct; identical iteration
#: counts, eigenvalue errors, and f64 residual certificates), so 1e-4
#: keeps one measured decade of margin while skipping the RR eigh's
#: final machine-precision sweeps (~70% of the spectral engine's
#: per-iteration device time is this eigh).
PROD_RR_TOL = 1e-4


def _hermitize(G):
    return 0.5 * (G + jnp.conj(G.T))


def _whiten(G, eps):
    """C with C^H G C ≈ I on the well-conditioned subspace of the
    Hermitian PSD Gram G, dropping directions with eigenvalue below
    ``eps * max`` (DSY-style stabilization). Dropped directions become
    zero columns; returns (C, good_mask)."""
    w, V = jacobi_eigh(_hermitize(G))
    wmax = jnp.maximum(jnp.max(jnp.abs(w)), jnp.finfo(w.dtype).tiny)
    good = w > eps * wmax
    inv = jnp.where(good, jax.lax.rsqrt(jnp.where(good, w, 1.0)), 0.0)
    return V * inv[None, :], good


def _whiten_chol(G, eps):
    """Cholesky-based whitening — same contract as :func:`_whiten`
    (C with CᴴGC ≈ I on the well-conditioned subspace + good mask),
    at a fraction of the latency: one n×n Cholesky + triangular
    inverse replaces the Jacobi eigendecomposition, halving the
    serialized small-eigh count per LOBPCG iteration (the Ritz eigh is
    irreducible, this one is not).

    δ-regularized: chol(G + δI) with δ = eps·max(diag) matches the
    DSY drop threshold semantics — directions whose Gram eigenvalue
    is ≤ δ come out damped by w/(w+δ) instead of exactly dropped, and
    are flagged via the whitened M-norm diag(CᴴGC) = 1 − δ‖C[:,i]‖²
    < 1/2. An indefinite-by-roundoff Gram (negative pivot) NaN-poisons
    every Cholesky row from the first bad pivot on; those rows are
    rebuilt as huge decoupled diagonals, which zeroes them in the
    inverse and drops the directions — S is ordered [X | W | P] with
    the M-orthonormal X block first, so a bad pivot can only cost
    directions in the W/P tail for one iteration."""
    import jax.scipy.linalg as jsl
    G = _hermitize(G)
    rdtype = jnp.finfo(G.dtype).dtype
    n = G.shape[-1]
    dmax = jnp.maximum(jnp.max(jnp.real(jnp.diagonal(G))),
                       jnp.asarray(jnp.finfo(rdtype).tiny, rdtype))
    # δ must sit WELL above the Cholesky pivot-cancellation noise
    # (~eps·(n + √N)·dmax — same order as the eigh drop threshold
    # 50·eps·dmax): a pure-noise direction whose pivot lands at 2–3×
    # the noise floor would pass the mnorm keep test with O(1/√δ)
    # amplification and inject a garbage Ritz value (measured: λ=-182
    # on a ‖A‖≈70 pencil after over-iteration in f32). 20× the eigh
    # threshold gives a robust margin; the more aggressive dropping is
    # harmless (DSY orthogonalization tolerances up to √eps still
    # converge — dropped directions return as fresh W next iteration).
    delta = 20.0 * eps * dmax
    eye = jnp.eye(n, dtype=G.dtype)
    L = jnp.linalg.cholesky(G + delta * eye)
    finite_row = jnp.all(jnp.isfinite(
        jnp.stack([jnp.real(L), jnp.imag(L)])), axis=(0, 2))
    big = (dmax / jnp.asarray(jnp.finfo(rdtype).eps, rdtype))
    L = jnp.where(finite_row[:, None], L, 0.0)
    L = L + jnp.diag(jnp.logical_not(finite_row).astype(rdtype)
                     * big).astype(G.dtype)
    Cm = jsl.solve_triangular(L, eye, lower=True)      # L^{-1}
    # C = L^{-H}: CᴴGC = I − δ·CmCmᴴ; column norms of C = row norms
    # of Cm, so the damped/dropped test is one cheap row reduction.
    mnorm = 1.0 - delta * jnp.sum(jnp.abs(Cm) ** 2, axis=1)
    good = jnp.logical_and(mnorm > 0.5, finite_row)
    # Match _whiten's contract exactly: dropped directions become ZERO
    # columns. Without this their ~1/√δ-scaled entries contaminate H
    # (entries ~‖A‖/δ), and the Jacobi RR loses the small Ritz values
    # on the wildly-scaled matrix (measured: total collapse on a
    # rank-deficient block in f64).
    Cm = Cm * good[:, None].astype(Cm.dtype)
    # CholeskyQR2 second pass. One pass is NOT enough under
    # over-iteration: Cholesky's backward error is normwise, so a
    # near-dependent direction's pivot carries absolute noise
    # ~eps·n·dmax — a pure-noise direction can pass the mnorm test
    # with O(1/√δ) amplification and inject Ritz garbage (measured:
    # λ drifting to -25 on a ‖A‖≈70 f32 pencil past convergence;
    # jacobi_eigh whitening is immune via Demmel–Veselić relative
    # accuracy). Re-measuring the whitened Gram G₂ = CᴴGC from the
    # ORIGINAL G re-tests every kept direction against the truth:
    # genuine directions give diag ≈ 1 and a clean second factor;
    # amplified noise gives diag ≈ 0 ± (noise/δ) ≪ 1/2 (or a NaN
    # row) and is dropped. κ(G₂) ≈ 1, so the second factor also
    # restores orthonormality to O(eps) — the CholQR2 property.
    G2 = Cm @ G @ jnp.conj(Cm).T
    d2 = jnp.real(jnp.diagonal(G2))
    good = jnp.logical_and(good, d2 > 0.5)
    gm = good.astype(rdtype)
    G2 = (G2 * (gm[:, None] * gm[None, :]).astype(G2.dtype)
          + jnp.diag(1.0 - gm).astype(G2.dtype))
    L2 = jnp.linalg.cholesky(_hermitize(G2))
    fin2 = jnp.all(jnp.isfinite(
        jnp.stack([jnp.real(L2), jnp.imag(L2)])), axis=(0, 2))
    good = jnp.logical_and(good, fin2)
    L2 = jnp.where(fin2[:, None], L2, 0.0)
    L2 = L2 + jnp.diag(jnp.logical_not(fin2).astype(rdtype)
                       * big).astype(G.dtype)
    Cm2 = jsl.solve_triangular(L2, eye, lower=True) @ Cm
    Cm2 = Cm2 * good[:, None].astype(Cm2.dtype)
    return jnp.conj(Cm2).T, good


def lobpcg(A: Callable, M: Optional[Callable], X0: jax.Array, nev: int,
           maxiter: int = 200, tol: float = 1e-6,
           precond: Optional[Callable] = None,
           scale_floor: float = 3e-2,
           kernel_project: Optional[Callable] = None,
           rr_method: str = "chol",
           rr_tol: Optional[float] = None) -> LobpcgResult:
    """LOBPCG on the Hermitian pencil (A, M) — see module docstring.

    ``X0``: (m, *dof_shape) complex initial block, m >= nev. ``M=None``
    means identity mass. Relative residual: ‖Ax − λMx‖ / scale with
    scale = max(|λ_j|, ``scale_floor``·max|λ|, 1e-3) — the floor lets
    near-zero bands (e.g. the ω²→0 Maxwell bands near Γ) converge
    without demanding absolute accuracy below the dtype's apply-noise
    floor. Callers that certify eigenvalues independently (the f64
    host Rayleigh–Ritz refine) may relax it (e.g. 0.3 in f32).
    Traced end-to-end (lax.while_loop): jit/vmap/shard_map-safe; under
    vmap the loop runs until every batch element converges.

    ``rr_method``: "chol" (default — Cholesky whitening of the S-basis
    Gram, half the per-iteration small-eigh latency) or "eigh" (the
    DSY eigendecomposition whitening; exact rank-revealing drop).

    ``rr_tol``: optional looser stop for the per-iteration Rayleigh–
    Ritz Jacobi eigh (see :func:`jacobi_eigh` ``rel_tol``) — RR
    rotation errors self-correct through the next iteration's
    re-whitening, so the final quadratic-convergence sweeps can be
    skipped mid-iteration. None keeps machine precision.
    """
    dof_shape = X0.shape[1:]
    m = X0.shape[0]
    if nev > m:
        raise ValueError(f"nev={nev} exceeds block size m={m}")
    cdtype = X0.dtype
    rdtype = jnp.finfo(cdtype).dtype
    eps = jnp.asarray(50.0 * jnp.finfo(rdtype).eps, rdtype)
    floor = jnp.asarray(scale_floor, rdtype)

    Af = _flatten_op(A, dof_shape)
    Mf = _flatten_op(M, dof_shape) if M is not None else (lambda X: X)
    Pf = _flatten_op(precond, dof_shape) if precond is not None else None
    # Exact-nullspace deflation hook: ``kernel_project(x)`` returns the
    # KERNEL COMPONENT of x (e.g. the (∇+ik)∇φ component for curl-curl).
    # It is subtracted from the updated X and P every iteration — f32
    # roundoff constantly reseeds the kernel, where A ≈ 0 makes it LOOK
    # like a converged lowest band (observed: a 7.6e-4 ghost eigenvalue
    # at the FCC W point that captured a Ritz position for 150
    # iterations). A annihilates the removed component, so AX needs no
    # correction (O(eps) error); MX gets the cheap exact update.
    Kf = (_flatten_op(kernel_project, dof_shape)
          if kernel_project is not None else None)

    X = X0.reshape(m, -1).astype(cdtype)
    # Reseed degenerate warm-start rows. A previous loose or degenerate
    # solve can hand back exactly-zero rows (whitening-dropped, sorted
    # last) — and zero rows are ABSORBING under the LOBPCG update
    # (R = 0 ⇒ W = 0), so without reseeding the effective block shrinks
    # monotonically across a warm-started k-chain (measured round 4:
    # total collapse of the scalar warm sweep from the second k on).
    # Deterministic key: one compiled program, reproducible runs.
    # Floor the scale so an ALL-zero block (max(rn) == 0 would make the
    # comparison all-False) still reseeds every row; healthy warm rows
    # are M-orthonormalized eigenvectors with 2-norms of order 1.
    rn = jnp.linalg.norm(X, axis=1)
    bad0 = rn < 1e-6 * jnp.maximum(jnp.max(rn), 1.0)
    fr = jax.random.normal(jax.random.PRNGKey(0x5EED),
                           (2, m, X.shape[1]), rdtype)
    X = jnp.where(bad0[:, None], (fr[0] + 1j * fr[1]).astype(cdtype), X)

    def gram(U, V):
        return jnp.conj(U) @ V.T

    def m_orthonormalize(X, MX):
        C, _ = _whiten(gram(X, MX), eps)
        return C.T @ X, C.T @ MX

    X, MX = m_orthonormalize(X, Mf(X))
    AX = Af(X)  # (X changed in orthonormalization; A of new X needed)
    zeros = jnp.zeros_like(X)
    c0 = _Carry(X=X, AX=AX, MX=MX, P=zeros, AP=zeros, MP=zeros,
                res=jnp.full((m,), jnp.inf, rdtype),
                it=jnp.asarray(0, jnp.int32), done=jnp.asarray(False))

    def cond(c: _Carry):
        return jnp.logical_and(c.it < maxiter, jnp.logical_not(c.done))

    def body(c: _Carry):
        X, AX, MX = c.X, c.AX, c.MX
        # Ritz values of current (M-orthonormal) X.
        lam = jnp.real(jnp.sum(jnp.conj(X) * AX, axis=1))
        R = AX - MX * lam[:, None].astype(cdtype)
        # Residual scale: per-band |λ|, floored by a fraction of the block
        # spectrum so zero modes (e.g. the λ=0 band at Γ) can converge.
        scale = jnp.maximum(jnp.abs(lam),
                            jnp.maximum(floor * jnp.max(jnp.abs(lam)),
                                        jnp.asarray(1e-3, rdtype)))
        rel = jnp.linalg.norm(R, axis=1) / scale
        # A whitening-dropped (all-zero) row has lam=0, R=0 — it must
        # read as UNconverged (+inf), not as a spurious eigenvalue 0.
        xnorm = jnp.real(jnp.sum(jnp.conj(X) * MX, axis=1))
        rel = jnp.where(xnorm > 0.5, rel, jnp.inf)
        conv = rel < tol

        W = Pf(R) if Pf is not None else R
        # M-project out span(X):  w_i -= Σ_j ⟨x_j, M w_i⟩ x_j.
        W = W - (jnp.conj(W) @ MX.T).conj() @ X
        # Soft locking: zero converged rows of W and P (mask, not reshape).
        mask = jnp.logical_not(conv)[:, None].astype(rdtype)
        W = W * mask
        P, AP, MP = c.P * mask, c.AP * mask, c.MP * mask

        AW, MW = Af(W), Mf(W)
        # Normalize W and P rows to unit M-norm: keeps the S-basis Gram
        # well-scaled near convergence (else tiny-residual directions fall
        # below the whitening drop threshold and progress stalls).
        tiny = jnp.asarray(jnp.finfo(rdtype).tiny, rdtype)

        def rownorm(U, MU):
            s = jax.lax.rsqrt(jnp.maximum(
                jnp.real(jnp.sum(jnp.conj(U) * MU, axis=1)), tiny))
            # Exact-zero (locked) rows stay zero.
            nz = (jnp.linalg.norm(U, axis=1) > 0).astype(rdtype)
            return (s * nz)[:, None]

        sw = rownorm(W, MW)
        sp_ = rownorm(P, MP)
        W, AW, MW = W * sw, AW * sw, MW * sw
        P, AP, MP = P * sp_, AP * sp_, MP * sp_

        S = jnp.concatenate([X, W, P], axis=0)          # (3m, N)
        AS = jnp.concatenate([AX, AW, AP], axis=0)
        MS = jnp.concatenate([MX, MW, MP], axis=0)

        whiten = _whiten_chol if rr_method == "chol" else _whiten
        C, good = whiten(gram(S, MS), eps)              # (3m, 3m)
        H = _hermitize(jnp.conj(C.T) @ gram(S, AS) @ C)
        # Dropped directions: push their Ritz values above the spectrum,
        # but only moderately — a Gershgorin bound keeps the matrix scale
        # sane (f32 eigh solvers lose accuracy on wildly-scaled input).
        gersh = jnp.max(jnp.sum(jnp.abs(H), axis=1))
        big = 2.0 * gersh + jnp.asarray(1.0, rdtype)
        H = H + jnp.diag(jnp.logical_not(good).astype(rdtype) * big)
        theta, Y = jacobi_eigh(H, rel_tol=rr_tol)       # ascending
        Ym = (C @ Y[:, :m]).astype(cdtype)              # coeffs of new X
        Xn, AXn, MXn = Ym.T @ S, Ym.T @ AS, Ym.T @ MS
        # Implicit new P: W/P components of the update (X-block zeroed).
        Yp = Ym.at[:m, :].set(0)
        Pn, APn, MPn = Yp.T @ S, Yp.T @ AS, Yp.T @ MS
        # Whiteout guard: if whitening dropped EVERY direction (an f32
        # pathology on a fully-plateaued basis), the update above is
        # identically zero — and the zero state is absorbing. Freeze the
        # block instead; the degeneration/stagnation stops below then
        # terminate the loop with the previous (finite) iterate.
        ok = (jnp.sum(good.astype(jnp.int32)) > 0)
        Xn = jnp.where(ok, Xn, X)
        AXn = jnp.where(ok, AXn, AX)
        MXn = jnp.where(ok, MXn, MX)
        Pn = jnp.where(ok, Pn, c.P)
        APn = jnp.where(ok, APn, c.AP)
        MPn = jnp.where(ok, MPn, c.MP)
        if Kf is not None:
            # One 2m-row batched call instead of two m-row calls: the
            # projector's fixed per-call work (basis transforms inside
            # e.g. the Chebyshev gradient projector) amortizes over the
            # doubled batch — the X/P deflation is per-iteration cost.
            K2 = Kf(jnp.concatenate([Xn, Pn], axis=0))
            M2 = Mf(K2)
            Kx, Kp_ = K2[:m], K2[m:]
            Xn, MXn = Xn - Kx, MXn - M2[:m]
            Pn, MPn = Pn - Kp_, MPn - M2[m:]

        # done must be RANK-AWARE: test the nev LOWEST healthy Ritz
        # rows, not rows [:nev]. Row order is ascending only after an
        # RR update — on a warm start (previous k's sort) or when an
        # easy problem converges rows to higher eigenvectors first,
        # rows [:nev] can all be converged WITHOUT being the lowest
        # bands, and the rank-blind test exited after 1 iteration with
        # the true band unconverged in a guard row (measured: band-1
        # residual 4e-4 and eigenvalue error 1.6e-6 at the SQR X point
        # under warm start — round-4 bug fix).
        lam_eff = jnp.where(xnorm > 0.5, lam, jnp.inf)
        low = jnp.argsort(lam_eff)[:nev]
        done = jnp.all(rel[low] < tol)
        # Degeneration stop: whitening-dropped rows never revive (their
        # residual is zero, so W contributes nothing), so once fewer
        # than nev healthy rows remain the solve CANNOT complete —
        # further iterations only degrade the survivors (measured
        # round 4: grinding to the all-zero state by maxiter). Exit;
        # the unhealthy rows surface as converged=False + the host
        # refine fallback.
        nhealthy = jnp.sum((xnorm > 0.5).astype(jnp.int32))
        done = jnp.logical_or(done, nhealthy < nev)
        return _Carry(X=Xn, AX=AXn, MX=MXn, P=Pn, AP=APn, MP=MPn,
                      res=rel, it=c.it + 1, done=done)

    # Segmented iteration with periodic refresh: AX/MX/AP/MP are only
    # ever formed by linear recombination inside a segment; recomputing
    # them from scratch between segments kills the slow drift that can
    # otherwise turn the Rayleigh–Ritz matrix indefinite on hard
    # (degenerate-cluster) problems. An outer while_loop keeps this
    # vmap-safe (a lax.cond would compute both branches under vmap).
    # seg=16 (was 64): the Cholesky whitening trusts the measured MS
    # Gram, and 64 recombinations of f32 drift were measured to feed it
    # garbage (λ drifting below λmin(A) past convergence); at 16 both
    # whitening methods are stable and the refresh overhead (2 fused
    # applies per 16 iterations) is ~12%.
    seg = 16

    def seg_cond(c: _Carry):
        return jnp.logical_and(c.it < maxiter, jnp.logical_not(c.done))

    def seg_body(c: _Carry):
        AXn, MXn = Af(c.X), Mf(c.X)
        APn, MPn = Af(c.P), Mf(c.P)
        c = c._replace(AX=AXn, MX=MXn, AP=APn, MP=MPn)
        it0 = c.it

        # Tracked residual: worst of the nev BEST finite rows. Raw
        # c.res[:nev] is in unsorted row order and can contain the inf
        # sentinel of a whitening-dropped row — then isfinite(res0) is
        # False FOREVER and the stagnation stop is disarmed exactly on
        # the runs that need it (measured round 4: 400-iteration grind
        # to the absorbing zero state on a knife-edge loose stop).
        def tracked(res):
            big = jnp.asarray(1e6, rdtype)
            resh = jnp.where(jnp.isfinite(res), jnp.minimum(res, big),
                             big)
            return jnp.max(jnp.sort(resh)[:nev])

        res0 = tracked(c.res)

        def inner_cond(c2: _Carry):
            return jnp.logical_and(
                jnp.logical_and(c2.it < maxiter, c2.it - it0 < seg),
                jnp.logical_not(c2.done))

        c = jax.lax.while_loop(inner_cond, body, c)
        # Stagnation stop: if a whole 64-iteration segment made
        # essentially NO progress on the worst tracked residual, we are
        # at a numerical floor (observed in f32 near Γ, where the exact
        # deflation solve amplifies roundoff into an ~1e-3 residual
        # floor while the refined eigenvalues are already converged).
        # The threshold must be lax: warm-started solves legitimately
        # crawl through <30%-per-segment plateaus mid-convergence (a
        # 0.7 threshold was measured to stop real solves at 1.6e-3).
        res1 = tracked(c.res)
        floored = res1 > 0.97 * res0
        return c._replace(done=jnp.logical_or(c.done, floored))

    c = jax.lax.while_loop(seg_cond, seg_body, c0)

    # Final Ritz data on exit state (X is M-orthonormal up to roundoff).
    nrm = jnp.maximum(jnp.real(jnp.sum(jnp.conj(c.X) * c.MX, axis=1)),
                      jnp.asarray(jnp.finfo(rdtype).tiny, rdtype))
    lam = jnp.real(jnp.sum(jnp.conj(c.X) * c.AX, axis=1)) / nrm
    R = c.AX - c.MX * lam[:, None].astype(cdtype)
    rel = jnp.linalg.norm(R, axis=1) / jnp.maximum(
        jnp.abs(lam), jnp.maximum(floor * jnp.max(jnp.abs(lam)),
                                  jnp.asarray(1e-3, rdtype)))
    # Zero (whitening-dropped) rows: mark unconverged AND sort last so a
    # spurious λ=0 can never displace a real band from the nev window.
    healthy = nrm > 0.5 * jnp.max(nrm)
    rel = jnp.where(healthy, rel, jnp.inf)
    lam = jnp.where(healthy, lam, jnp.inf)
    order = jnp.argsort(lam)
    lam, rel = lam[order], rel[order]
    Xout = c.X[order]
    # If unhealthy rows land inside the nev window (more dropped rows
    # than guard vectors) the inf sentinels must not leak into caller
    # outputs (JSON/band tables): clamp eigenvalues to
    # the largest healthy value and residuals to a large finite number;
    # ``converged`` stays False for them, which is the detectable signal.
    finite = jnp.isfinite(lam)
    lam_top = jnp.max(jnp.where(finite, lam, -jnp.inf))
    lam_top = jnp.where(jnp.isfinite(lam_top), lam_top,
                        jnp.asarray(0.0, rdtype))
    lam = jnp.where(finite, lam, lam_top)
    # jnp.minimum propagates NaN, so a diverged solve (NaN lam on a
    # healthy row ⇒ NaN rel) needs the where form to land at the finite
    # sentinel too — converged=False stays the failure signal
    #.
    rel = jnp.where(jnp.isfinite(rel),
                    jnp.minimum(rel, jnp.asarray(1e6, rdtype)),
                    jnp.asarray(1e6, rdtype))
    return LobpcgResult(eigenvalues=lam[:nev],
                        eigenvectors=Xout.reshape(m, *dof_shape),
                        iterations=c.it,
                        residual_norms=rel[:nev],
                        converged=rel[:nev] < tol)
