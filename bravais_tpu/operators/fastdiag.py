"""Fast block-diagonalization of quasi-periodic operators (twisted DFT).

The accelerator-native replacement for hypre-AMS as the *outer* Maxwell
preconditioner (SURVEY.md §2.2 #12) and for the inner deflation solve
(App. C.3), exploiting the structured periodic grid more aggressively
than multigrid can:

Every quasi-periodic operator in this framework (curl-curl A, mass M,
deflation Laplacian L) is invariant under *element* translations — k
enters only through the boundary wrap phases (operators/curlcurl.py
docstring). On the n₁×n₂×n₃ element grid each such operator is
block-circulant with nearest-neighbor stencil: with element-owned dof
blocks u[e] (size D = ncomp·pᵈ),

    (A u)[e] = Σ_{δ ∈ {-1,0,1}ᵈ} S_δ u[e+δ],

with quasi-periodic continuation u[e+n] = e^{i k·a} u[e].  The twisted
discrete Fourier transform  û[m] = Σ_e e^{-i θ_m·e} u[e], with
θ_{m,i} = (k·a_i + 2π m_i)/n_i, block-diagonalizes it EXACTLY:

    Â(k)_m = Σ_δ S_δ e^{i θ_m·δ}        (one D×D block per frequency m).

The S_δ are k-independent and real; they are extracted ONCE on the host
(f64 NumPy twins) by probing unit element-dof fields at an interior
element. Per k-point everything is dense batched linear algebra — DFT
matmuls, block assembly, batched inverse, batched matvec — i.e. GEMM
work, all inside one jitted program with k traced.

Uses:
* ``solver([("A",1),("M",s)], k)`` → an (essentially exact) (A+sM)⁻¹:
  the LOBPCG outer preconditioner. Exact for element-translation-
  invariant coefficients (the headline empty-lattice configs); for
  spatially varying ε build the FastDiag from the MEAN coefficient —
  still a spectrally-equivalent preconditioner (contrast-bounded).
* ``solver([("L",1)], k, refine=1)`` → direct deflation solve,
  replacing the QPGMG V-cycles (exact projector → the f32-at-scale
  robustness fix).

Validity requires n_i ≥ 3 (stencil extraction needs an interior
element) — always true for production grids.
"""

from __future__ import annotations

import itertools
from typing import Callable, List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["FastDiag", "extract_stencil"]


def _disk_cached(key_obj, compute):
    """Load/store a numpy array under a content-hash key in the repo's
    stencil cache (BRAVAIS_STENCIL_CACHE overrides; empty string
    disables). Atomic write; any IO failure falls back to computing."""
    import hashlib
    import os
    import pickle

    cdir = os.environ.get(
        "BRAVAIS_STENCIL_CACHE",
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))),
            ".stencil_cache"))
    if not cdir:
        return compute()
    try:
        key = hashlib.sha256(
            pickle.dumps(key_obj, protocol=4)).hexdigest()[:32]
        path = os.path.join(cdir, key + ".npy")
        if os.path.exists(path):
            return np.load(path)
        arr = compute()
        os.makedirs(cdir, exist_ok=True)
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            np.save(f, arr)
        os.replace(tmp, path)
        return arr
    except (OSError, pickle.PicklingError):
        return compute()


def extract_stencil_rect(apply0: Callable, ncomp_out: int, ncomp_in: int,
                         shape: Sequence[int], p: int) -> np.ndarray:
    """Rectangular variant of :func:`extract_stencil` for operators
    between two dof layouts on the same element grid (e.g. the discrete
    gradient G: scalar H1 → 3-component ND). Returns
    (3ᵈ, ncomp_out·pᵈ, ncomp_in·pᵈ)."""
    shape = tuple(int(n) for n in shape)
    d = len(shape)
    if any(n < 3 for n in shape):
        raise ValueError(f"FastDiag needs n_i >= 3 per axis, got {shape}")
    e0 = tuple(n // 2 for n in shape)
    offsets = list(itertools.product((-1, 0, 1), repeat=d))
    Dout = ncomp_out * p ** d
    Din = ncomp_in * p ** d
    out = np.zeros((len(offsets), Dout, Din), np.complex128)
    N = tuple(n * p for n in shape)
    col = 0
    for c in range(ncomp_in):
        for loc in itertools.product(range(p), repeat=d):
            u = np.zeros((ncomp_in,) + N, np.complex128)
            u[(c,) + tuple(e0[i] * p + loc[i] for i in range(d))] = 1.0
            y = apply0(u if ncomp_in > 1 else u[0])
            y = np.asarray(y).reshape((ncomp_out,) + N)
            for s, off in enumerate(offsets):
                sl = tuple(slice((e0[i] + off[i]) * p,
                                 (e0[i] + off[i]) * p + p)
                           for i in range(d))
                out[len(offsets) - 1 - s, :, col] = \
                    y[(slice(None),) + sl].reshape(Dout)
            col += 1
    if np.max(np.abs(out.imag)) <= 1e-12 * max(np.max(np.abs(out)), 1.0):
        return out.real.copy()
    return out


def extract_stencil(apply0: Callable, ncomp: int, shape: Sequence[int],
                    p: int) -> np.ndarray:
    """Extract the (3ᵈ, D, D) neighbor-coupling blocks of a
    quasi-periodic operator from its k=0 host apply.

    ``apply0``: u -> A(k=0) u on (ncomp, *N) fields ((*N,) if ncomp==1),
    N_i = n_i p.  Probes every element-local basis dof of an interior
    element; the response at elements e0+δ is column (c, l) of S_δ.
    """
    shape = tuple(int(n) for n in shape)
    d = len(shape)
    if any(n < 3 for n in shape):
        raise ValueError(f"FastDiag needs n_i >= 3 per axis, got {shape}")
    e0 = tuple(n // 2 for n in shape)
    offsets = list(itertools.product((-1, 0, 1), repeat=d))
    D = ncomp * p ** d
    out = np.zeros((len(offsets), D, D), np.float64)
    N = tuple(n * p for n in shape)
    col = 0
    for c in range(ncomp):
        for loc in itertools.product(range(p), repeat=d):
            u = np.zeros((ncomp,) + N, np.complex128)
            u[(c,) + tuple(e0[i] * p + loc[i] for i in range(d))] = 1.0
            y = apply0(u if ncomp > 1 else u[0])
            y = np.asarray(y).reshape((ncomp,) + N)
            if np.max(np.abs(y.imag)) > 1e-12 * max(np.max(np.abs(y)), 1.0):
                raise ValueError("operator is not real at k=0 — not a "
                                 "quasi-periodic stencil operator")
            for s, off in enumerate(offsets):
                # y[e0+off] = S_{-off} u[e0]  ⇒  store at index of -off,
                # which is the reversed position in the product order.
                sl = tuple(slice((e0[i] + off[i]) * p,
                                 (e0[i] + off[i]) * p + p)
                           for i in range(d))
                out[len(offsets) - 1 - s, :, col] = \
                    y[(slice(None),) + sl].real.reshape(D)
            col += 1
    return out


class FastDiag:
    """Twisted-DFT block-diagonal factory for one dof layout.

    Host state only (stencils, shapes); all traced work happens inside
    the methods, so instances can be closed over by jitted programs
    (operator-state convention, CLAUDE.md).
    """

    def __init__(self, shape: Sequence[int], p: int, ncomp: int,
                 A_rows: np.ndarray, dtype=jnp.complex64):
        self.shape = tuple(int(n) for n in shape)
        self.d = len(self.shape)
        self.p = int(p)
        self.ncomp = int(ncomp)
        self.A_rows = np.asarray(A_rows, np.float64)  # rows a_i
        self.dtype = jnp.dtype(dtype)
        self.rdtype = jnp.finfo(self.dtype).dtype
        self.D = ncomp * p ** self.d
        self.nblocks = int(np.prod(self.shape))
        self.offsets = np.asarray(
            list(itertools.product((-1, 0, 1), repeat=self.d)), np.int64)
        self.stencils: dict[str, np.ndarray] = {}

    def add_stencil(self, name: str, apply0: Callable,
                    cache_key=None, extract_shape=None) -> "FastDiag":
        """Extract (or load) the k=0 stencil. ``cache_key``: any
        picklable object fully determining the stencil (operator
        coefficients, grid, order) — enables the disk cache (stencil
        extraction probes hundreds of f64 host applies, ~minutes of
        single-core time per fresh process at production sizes).
        ``extract_shape``: probe on a SMALLER grid than the production
        one — ``apply0`` must then be the operator twin on a
        ``PeriodicGrid.stencil_twin`` grid (same element Jacobian,
        element-invariant coefficients), whose stencils are identical
        at a fraction of the probing cost."""
        shp = (tuple(int(n) for n in extract_shape)
               if extract_shape is not None else self.shape)

        def compute():
            return extract_stencil(apply0, self.ncomp, shp, self.p)
        self.stencils[name] = (_disk_cached(
            ("stencil", name, self.shape, self.p, self.ncomp,
             self.A_rows.tobytes(), cache_key), compute)
            if cache_key is not None else compute())
        return self

    # -- traced pieces -------------------------------------------------

    def _theta(self, k) -> List[jax.Array]:
        """Per-axis twisted frequencies θ_{m,i} = (k·a_i + 2πm)/n_i."""
        ka = jnp.asarray(self.A_rows.astype(self.rdtype)) @ k.astype(
            self.rdtype)
        return [(ka[i] + 2.0 * jnp.pi
                 * jnp.arange(n, dtype=self.rdtype)) / n
                for i, n in enumerate(self.shape)]

    def _fwd_mats(self, theta) -> List[jax.Array]:
        """F_i[m, e] = e^{-i θ_m e} (inverse is Fᴴ/n)."""
        out = []
        for i, n in enumerate(self.shape):
            e = jnp.arange(n, dtype=self.rdtype)
            out.append(jnp.exp(-1j * theta[i][:, None] * e[None, :])
                       .astype(self.dtype))
        return out

    def blocks(self, terms: Sequence[Tuple[str, float]], k,
               guard: float = 0.0) -> jax.Array:
        """(nblocks, D, D) blocks of Σ coeff·stencil at wavevector k,
        plus ``guard``·(block trace/D) on the diagonal."""
        theta = self._theta(k)
        # per-δ phase  w[s, b] = Π_i e^{i θ_{m_i} δ_i}
        w = None
        for i in range(self.d):
            zi = jnp.exp(1j * theta[i]).astype(self.dtype)      # (n_i,)
            di = jnp.asarray(self.offsets[:, i].astype(np.float64)
                             .astype(np.dtype(self.rdtype)))     # (S,)
            wi = zi[None, :] ** di[:, None]                      # (S, n_i)
            w = wi if w is None else jnp.einsum("s...,sn->s...n", w, wi)
        w = w.reshape(w.shape[0], -1)                            # (S, B)
        S = np.zeros_like(self.stencils[terms[0][0]])
        for name, coeff in terms:
            S = S + float(coeff) * self.stencils[name]
        Sj = jnp.asarray(S.astype(np.dtype(self.rdtype)))
        T = jnp.einsum("sb,sij->bij", w, Sj)
        if guard:
            tr = jnp.real(jnp.trace(T, axis1=1, axis2=2)) / self.D
            T = T + (guard * tr)[:, None, None] * jnp.eye(
                self.D, dtype=self.dtype)
        return T

    def to_blocks(self, u: jax.Array, F: Sequence[jax.Array]) -> jax.Array:
        """Field (ncomp?, N₁..N_d) → (nblocks, D) twisted-DFT coeffs."""
        d, p = self.d, self.p
        u = u.astype(self.dtype).reshape(
            (self.ncomp,) + tuple(x for n in self.shape for x in (n, p)))
        for i in range(d):
            ax = 1 + 2 * i
            u = jnp.moveaxis(
                jnp.tensordot(F[i], u, axes=((1,), (ax,))), 0, ax)
        perm = [1 + 2 * i for i in range(d)] + [0] + \
            [2 + 2 * i for i in range(d)]
        return u.transpose(perm).reshape(self.nblocks, self.D)

    def from_blocks(self, v: jax.Array, F: Sequence[jax.Array],
                    squeeze: bool = True) -> jax.Array:
        """Inverse of :meth:`to_blocks`."""
        d, p = self.d, self.p
        v = v.reshape(tuple(self.shape) + (self.ncomp,) + (p,) * d)
        perm = [d] + [x for i in range(d) for x in (i, d + 1 + i)]
        u = v.transpose(perm)
        for i in range(d):
            ax = 1 + 2 * i
            Fi_inv = jnp.conj(F[i]).T / self.shape[i]
            u = jnp.moveaxis(
                jnp.tensordot(Fi_inv, u, axes=((1,), (ax,))), 0, ax)
        u = u.reshape((self.ncomp,) + tuple(n * p for n in self.shape))
        return u[0] if (squeeze and self.ncomp == 1) else u

    # -- solvers ---------------------------------------------------------

    def solver(self, terms: Sequence[Tuple[str, float]], k,
               guard: float = 0.0, refine: int = 0,
               method: str = "lu", rcond: float = 0.0) -> Callable:
        """u ↦ (Σ coeff·Op)⁻¹ u as a traced closure: twisted DFT →
        batched block inverse-matvec → inverse DFT. Build once per
        k OUTSIDE hot loops.

        ``method``:
        * "lu"   — batched dense inverse. Right for well-conditioned
          blocks (the shifted (A+sM) preconditioner).
        * "eigh" — batched Jacobi eigendecomposition with spectral
          pseudo-inverse (eigenvalues ≤ ``rcond``·max dropped). Right
          for the deflation Laplacian near Γ: its near-null block makes
          the f32 LU error unstructured (∼κ·eps in every direction),
          while the eigh inverse errs only ALONG eigendirections —
          amplification ~1/√w₀ instead of κ (the round-1 n=8 p=3
          f32-robustness fix). Also gives a clean pseudo-inverse at the
          exactly singular Γ point.

        ``refine`` (lu only): iterative-refinement steps."""
        theta = self._theta(k)
        F = self._fwd_mats(theta)
        T = self.blocks(terms, k, guard=guard)
        if method == "eigh":
            from bravais_tpu.eigen.jacobi_eigh import jacobi_eigh
            w, V = jacobi_eigh(T)
            good = w > rcond * jnp.max(w, axis=-1, keepdims=True)
            winv = jnp.where(good, 1.0 / jnp.where(good, w, 1.0), 0.0)
            VH = jnp.conj(jnp.swapaxes(V, -1, -2))

            def inv_apply(v):
                c = jnp.einsum("bij,bj->bi", VH, v)
                return jnp.einsum("bij,bj->bi", V,
                                  winv.astype(v.dtype) * c)

            Tref = None
        else:
            Tinv = jnp.linalg.inv(T)

            def inv_apply(v):
                return jnp.einsum("bij,bj->bi", Tinv, v)

            Tref = T if refine else None

        def solve(u):
            v = self.to_blocks(u, F)
            x = inv_apply(v)
            if Tref is not None:
                for _ in range(refine):
                    r = v - jnp.einsum("bij,bj->bi", Tref, x)
                    x = x + inv_apply(r)
            return self.from_blocks(x, F).reshape(u.shape)

        return solve

    # -- host (NumPy, f64) twin — used by the refine stage -----------------

    def _phase_weights_np(self, k: np.ndarray):
        """Twisted phase angles θ_i and the per-offset weight matrix
        w (noffsets, nblocks) at k — the SINGLE host-side definition of
        the quasi-periodic phase convention. blocks_np, blocks_np_multi
        and solver_np all derive from this one function so the f64
        refine can never desynchronize from the device blocks."""
        k = np.asarray(k, np.float64)
        theta = [(self.A_rows[i] @ k + 2.0 * np.pi * np.arange(n)) / n
                 for i, n in enumerate(self.shape)]
        w = None
        for i in range(self.d):
            wi = np.exp(1j * theta[i])[None, :] ** \
                self.offsets[:, i].astype(np.float64)[:, None]
            w = wi if w is None else np.einsum("s...,sn->s...n", w, wi)
        return theta, w.reshape(w.shape[0], -1)

    def blocks_np(self, terms: Sequence[Tuple[str, float]],
                  k: np.ndarray, idx=None) -> np.ndarray:
        """f64 host twin of :meth:`blocks`, optionally restricted to the
        flat block indices ``idx`` — the spectral-refine path builds the
        exact small blocks of only the frequencies that carry the
        converged bands (milliseconds instead of an all-dof host
        Rayleigh–Ritz). Rectangular stencils ("G") are supported."""
        _, w = self._phase_weights_np(k)
        if idx is not None:
            w = w[:, np.asarray(idx, np.int64)]
        S = sum(float(c) * self.stencils[nm] for nm, c in terms)
        Sf = S.reshape(S.shape[0], -1)
        if np.isrealobj(Sf):
            # Stencils are REAL f64: two real dgemms instead of the
            # complex×real einsum (measured 85 ms → ~5 ms at 9 blocks,
            # n=8 p=4 — this call sat on the per-k critical path of the
            # host refine, which bounds every sweep mode's throughput).
            T = (np.ascontiguousarray(w.real.T) @ Sf
                 + 1j * (np.ascontiguousarray(w.imag.T) @ Sf))
        else:
            T = w.T @ Sf
        return T.reshape(w.shape[1], S.shape[1], S.shape[2])

    def blocks_np_multi(self, names: Sequence[str], k: np.ndarray,
                        idx=None) -> list:
        """Several stencils' blocks at the same (k, idx) in ONE pair of
        dgemms — the phase factors w and the GEMM launch overhead are
        shared across stencils (the refine needs A, M and G together on
        the per-k critical path). Stencils may have different column
        dimensions (rectangular "G"); rows (ncomp·p^d) must match."""
        _, w = self._phase_weights_np(k)
        if idx is not None:
            w = w[:, np.asarray(idx, np.int64)]
        mats = [self.stencils[nm] for nm in names]
        cols = [m.shape[1] * m.shape[2] for m in mats]
        ck = tuple(names)
        if not hasattr(self, "_multi_cache"):
            self._multi_cache = {}
        Sf = self._multi_cache.get(ck)
        if Sf is None:
            # ~19 MB concatenate at the n=8 p=4 headline — per-k
            # critical-path host work, so cache per names tuple.
            Sf = np.concatenate([m.reshape(m.shape[0], -1)
                                 for m in mats], axis=1)
            self._multi_cache[ck] = Sf
        if np.isrealobj(Sf):
            T = (np.ascontiguousarray(w.real.T) @ Sf
                 + 1j * (np.ascontiguousarray(w.imag.T) @ Sf))
        else:
            T = w.T @ Sf
        out, o = [], 0
        for m, c in zip(mats, cols):
            out.append(T[:, o:o + c].reshape(w.shape[1], m.shape[1],
                                             m.shape[2]))
            o += c
        return out

    def candidate_blocks(self, support: np.ndarray, topk: int = 4,
                         tau: float = 1e-5) -> np.ndarray:
        """Flat block indices carrying the converged bands: per LOBPCG
        row, the ``topk`` largest-|X̂|² blocks above ``tau``·row-max."""
        sup = np.asarray(support, np.float64)
        cand = set()
        for r in range(sup.shape[0]):
            order = np.argsort(sup[r])[::-1][:topk]
            mx = sup[r][order[0]]
            for b in order:
                if sup[r][b] > tau * mx:
                    cand.add(int(b))
        return np.asarray(sorted(cand), np.int64)

    def spectral_refine_np(self, support: np.ndarray, k: np.ndarray,
                           nev: int, scale_floor_abs: float = 1e-3
                           ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact f64 refine for pencils WITHOUT a nullspace to deflate
        (scalar Helmholtz): generalized eigh of only the candidate
        blocks ("A", "M" stencils). Returns (eigenvalues[:nev],
        residual certificates[:nev]) — blocks are exact invariant
        subspaces, so certificates are ~machine precision. The Maxwell
        twin with gradient deflation is curlcurl.spectral_refine_np."""
        import scipy.linalg

        idx = self.candidate_blocks(support)
        if idx.size == 0:
            # Degenerate device solve (all-zero support — e.g. a
            # collapsed block): no candidates to refine. Signal the
            # caller to use its fallback path instead of crashing on
            # an empty concatenate.
            return None
        k = np.asarray(k, np.float64)
        TA = self.blocks_np([("A", 1.0)], k, idx)
        TM = self.blocks_np([("M", 1.0)], k, idx)
        lams, ress = [], []
        for A_, M_ in zip(TA, TM):
            A_ = 0.5 * (A_ + A_.conj().T)
            M_ = 0.5 * (M_ + M_.conj().T)
            w, X = scipy.linalg.eigh(A_, M_)
            MX = M_ @ X
            R = A_ @ X - MX * w[None, :]
            nrm = np.maximum(np.linalg.norm(MX, axis=0), 1e-30)
            lams.append(w)
            ress.append(np.linalg.norm(R, axis=0) / nrm)
        allw = np.concatenate(lams)
        allr = np.concatenate(ress)
        order = np.argsort(allw)[:nev]
        lam = allw[order]
        scale = np.maximum(np.abs(lam),
                           max(3e-2 * float(np.abs(allw).max()),
                               scale_floor_abs))
        return lam, allr[order] / scale

    def solver_np(self, terms: Sequence[Tuple[str, float]],
                  k: np.ndarray, rcond: float = 1e-12) -> Callable:
        """f64 spectral block solver on the host (pseudo-inverse with
        relative eigenvalue cutoff ``rcond``). The eigendecomposition is
        done ONCE here; the returned closure solves any number of
        fields (used by the refine-stage gradient cleanup)."""
        d, p = self.d, self.p
        theta, w = self._phase_weights_np(k)
        F = [np.exp(-1j * th[:, None] * np.arange(n)[None, :])
             for th, n in zip(theta, self.shape)]
        S = sum(float(c) * self.stencils[nm] for nm, c in terms)
        T = np.einsum("sb,sij->bij", w, S)
        lam, V = np.linalg.eigh(0.5 * (T + np.conj(np.swapaxes(T, 1, 2))))
        good = lam > rcond * lam.max(axis=-1, keepdims=True)
        linv = np.where(good, 1.0 / np.where(good, lam, 1.0), 0.0)

        base_ndim = self.d + (1 if self.ncomp > 1 else 0)

        def solve(u):
            u = np.asarray(u, np.complex128)
            if u.ndim == base_ndim + 1:  # leading block axis
                return np.stack([solve(x) for x in u])
            x = u.reshape(
                (self.ncomp,) + tuple(y for n in self.shape
                                      for y in (n, p)))
            for i in range(d):
                ax = 1 + 2 * i
                x = np.moveaxis(np.tensordot(F[i], x, axes=((1,), (ax,))),
                                0, ax)
            perm = [1 + 2 * i for i in range(d)] + [0] + \
                [2 + 2 * i for i in range(d)]
            v = x.transpose(perm).reshape(self.nblocks, self.D)
            c = np.einsum("bij,bj->bi", np.conj(np.swapaxes(V, 1, 2)), v)
            v = np.einsum("bij,bj->bi", V, linv * c)
            v = v.reshape(tuple(self.shape) + (self.ncomp,) + (p,) * d)
            perm2 = [d] + [y for i in range(d) for y in (i, d + 1 + i)]
            x = v.transpose(perm2)
            for i in range(d):
                ax = 1 + 2 * i
                Fi_inv = np.conj(F[i]).T / self.shape[i]
                x = np.moveaxis(
                    np.tensordot(Fi_inv, x, axes=((1,), (ax,))), 0, ax)
            x = x.reshape((self.ncomp,) + tuple(n * p for n in self.shape))
            out = x[0] if self.ncomp == 1 else x
            return out.reshape(np.asarray(u).shape)

        return solve

    def solve_np(self, terms: Sequence[Tuple[str, float]],
                 u: np.ndarray, k: np.ndarray,
                 rcond: float = 1e-12) -> np.ndarray:
        """One-shot convenience wrapper over :meth:`solver_np`."""
        return self.solver_np(terms, k, rcond=rcond)(u)

    def matvec(self, terms: Sequence[Tuple[str, float]], k) -> Callable:
        """u ↦ (Σ coeff·Op) u through the block factorization — a
        cross-check path for tests."""
        theta = self._theta(k)
        F = self._fwd_mats(theta)
        T = self.blocks(terms, k)

        def mv(u):
            v = self.to_blocks(u, F)
            return self.from_blocks(
                jnp.einsum("bij,bj->bi", T, v), F).reshape(u.shape)

        return mv
