"""k-path band sweeps: batched (vmap + sharded) and warm-started modes.

The rebuild of the reference's hot outer loop (SURVEY.md §3.1) per
App. C.5, with both required regimes:

* **throughput mode** — the whole k-chunk's eigensolves are ONE XLA
  program: `vmap` over the k axis, k axis sharded across the device mesh
  (`NamedSharding`), so an entire Brillouin-zone path solves in one
  launch (the headline win, BASELINE.json:5);
* **latency / warm-start mode** — sequential k with the eigenvector
  block warm-started from the previous k-point (adjacent-k subspaces
  overlap strongly; typically several× fewer iterations).

All jit boundaries are real-valued (utils/reim.py): eigenvector
state travels between launches as stacked [Re, Im] device arrays.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from bravais_tpu.eigen.lobpcg import lobpcg
from bravais_tpu.eigen.precond import jacobi
from bravais_tpu.eigen.refine import host_rayleigh_ritz
from bravais_tpu.parallel.mesh import replicated, shard_k
from bravais_tpu.utils.reim import from_reim, to_reim

__all__ = ["BandSweep", "SweepResult"]


@dataclasses.dataclass
class SweepResult:
    """Band table for a sampled k-path.

    eigenvalues : (nk, nev) float — λ (scalar) or ω² (Maxwell)
    iterations  : (nk,) int LOBPCG iterations per k-point
    residuals   : (nk, nev) relative residual norms
    wall_s      : total device wall time (excluding compile)
    compile_s   : time spent in the first (compiling) launch minus steady
    """

    eigenvalues: np.ndarray
    iterations: np.ndarray
    residuals: np.ndarray
    wall_s: float
    compile_s: float = 0.0
    #: (nk, 2, nev, *dof_shape) real-stacked modes (keep_vectors=True)
    eigenvectors: Optional[np.ndarray] = None


class BandSweep:
    """Sweep driver over a set of Cartesian k-points.

    Parameters
    ----------
    operator : object with ``apply_A(u, k)``, ``apply_M(u)``, ``diag_A(k)``
               (BlochHelmholtz / BlochCurlCurl) acting on single fields.
    nev      : number of bands.
    block    : LOBPCG block size (default nev + max(4, nev//2)).
    precond  : "jacobi" | None | callable k -> block-preconditioner.
    """

    def __init__(self, operator, nev: int = 10, block: Optional[int] = None,
                 tol: float = 1e-6, maxiter: int = 200,
                 precond="auto", seed: int = 0,
                 solve_fn: Optional[Callable] = None,
                 refine: Optional[bool] = None,
                 keep_vectors: bool = False,
                 device_tol: Optional[float] = None,
                 restart_tol: Optional[float] = None,
                 rr_tol: "float | None | str" = "prod",
                 near_gamma_tol: Optional[float] = None,
                 near_gamma_norm: float = 0.0):
        # Rayleigh–Ritz eigh stop for the built-in lobpcg path: "prod" =
        # the measured production default (lobpcg.PROD_RR_TOL); None =
        # machine precision (oracle/debug runs). Engine solve_fn hooks
        # carry their own rr_tol via make_solve_fn(rr_tol=...).
        from bravais_tpu.eigen.lobpcg import PROD_RR_TOL
        self.rr_tol = PROD_RR_TOL if isinstance(rr_tol, str) else rr_tol
        self.keep_vectors = keep_vectors
        self.op = operator
        self.nev = nev
        self.m = block if block is not None else nev + max(4, nev // 2)
        self.maxiter = maxiter
        self.precond = precond
        self.seed = seed
        self._solve_fn = solve_fn  # override hook (e.g. Maxwell deflation)
        self._jit_batched = None
        self._jit_single = None
        self._jit_seg = None
        self._jit_chain = None
        # Precision plan (SURVEY.md §7.0): in f32, converge residuals to
        # ~1e-5 on device, then one host f64 Rayleigh–Ritz recovers
        # eigenvalue accuracy ≪1e-6 (residual² error). ``tol`` below the
        # f32 floor is therefore redirected into the refinement step.
        is_f32 = jnp.dtype(operator.dtype) == jnp.complex64
        self.refine = refine if refine is not None else (
            is_f32 and tol < 1e-4)
        self.tol = max(tol, 1e-5) if (is_f32 and self.refine) else tol
        # ``device_tol``: explicit device-loop stopping residual when the
        # f64 refine is active. The SPECTRAL engine's refine is an exact
        # invariant-subspace eigensolve whose accuracy does NOT depend
        # on the device residual — the device loop only has to identify
        # the support blocks (rough convergence suffices) and the
        # device-vs-refine cross-check + f64 residual certificate guard
        # the result. Looser device stops directly cut iterations/k.
        # FIELD-engine refine is a Rayleigh–Ritz over the DEVICE vectors,
        # so its accuracy IS residual-dependent — but QUADRATICALLY
        # (error ~ residual²/gap): measured (benchmarks/
        # exp_field_device_tol.py, CUB dielectric n=4 p=2 vs complex128
        # direct) the refined eigenvalue error is UNCHANGED at 5e-8 for
        # device stops 1e-5 → 1e-4 at ε ∈ {13, 30} while iterations
        # drop 12→10 / 16→14; first movement (5.6e-8) at 3e-4. A 1e-4
        # field device stop keeps a ~20× quadratic margin to the 1e-6
        # production bar (gated: test_dielectric_f32_refine_certified
        # runs the production device_tol). The f64 residual certificate
        # still reports the true achieved residual either way.
        if device_tol is not None and self.refine:
            self.tol = device_tol
        # ``restart_tol``: BATCHED-mode two-phase solve — phase 1 runs
        # every k to this loose residual, phase 2 restarts LOBPCG from
        # phase 1's (sorted, converged-ish) block to ``tol``, all
        # inside the same launch. Rationale: a vmapped while_loop runs
        # until EVERY k converges, so one cold-start straggler bills
        # its worst-case iterations to the whole batch; the restart
        # re-sorts rows, reseeds P, and re-projects — bounding the
        # straggler phase at the loose stop. MEASURED (CPU, CUB ε=13
        # n=4 p=2, nk=8): a LOSS when iteration counts are uniform
        # (max 11 → 13; the second _solve repeats the per-k setup and
        # drops P at the boundary) — only worth trying when the batch
        # has a genuine straggler (e.g. the cold nudged-Γ point at
        # production size). Off by default; parity-gated.
        self.restart_tol = restart_tol
        # ``near_gamma_tol``: looser device stop applied ONLY at k-points
        # with |k| < near_gamma_norm (warm mode). Rationale (round 5,
        # STATUS §0d-cert/§0d-throughput): in f32 the exact-deflation
        # roundoff floor near Γ sits at ~1e-3 — ABOVE the production 1e-4
        # field device stop — so the two smallest-|k| points grind the
        # floor until the segment stagnation guard fires (measured 21%-24%
        # of ALL sweep iterations on config 3), while the f64 refine was
        # CERTIFIED to recover ≤1.9e-7 relative eigenvalue error from
        # exactly those guard exits (benchmarks/certify_dielectric.py:
        # k=1 exited at 1.65e-3 device residual → 1.86e-7 after refine;
        # quadratic error ~ residual²/gap). A near-Γ stop at ~2e-3 exits
        # those points as soon as they reach the certified-benign region
        # instead of burning segments proving they are stuck. Only
        # meaningful with the f64 refine active; ignored otherwise.
        self.near_gamma_tol = near_gamma_tol if self.refine else None
        self.near_gamma_norm = near_gamma_norm
        self._resolve_precond()

    def _tol_for_k(self, k: np.ndarray) -> float:
        """Per-k device stop (host-side): ``near_gamma_tol`` inside the
        ``|k| < near_gamma_norm`` ball, the regular stop elsewhere."""
        if (self.near_gamma_tol is not None and self.near_gamma_norm > 0
                and float(np.linalg.norm(k)) < self.near_gamma_norm):
            return max(self.near_gamma_tol, self.tol)
        return self.tol

    # -- single-k solve (real-valued boundary) ------------------------------

    def _resolve_precond(self):
        """Resolve ``precond="auto"`` and EAGERLY build any solver state
        (the GMG hierarchy) at construction time — never first inside a
        jit trace (CLAUDE.md rule: lazily-built operator state under
        tracing breaks with TracerArrayConversionError the moment the
        build touches the device)."""
        pre = self.precond
        if pre == "auto":
            # Physics-aware default: varying-coefficient SCALAR
            # operators need the geometric-MG preconditioner — plain
            # Jacobi was measured to STALL outright on the stiffness-
            # contrast TE problem (hex air holes ε=13: residual stuck
            # at 0.1, stagnation-stop at 32 iterations, garbage bands)
            # while one V-cycle/iteration converges it in 13 (the
            # BoomerAMG-replacement role, SURVEY §2.2 #11). Everything
            # else keeps Jacobi (Maxwell paths bring their own
            # fastdiag preconditioners through solve_fn).
            from bravais_tpu.operators.helmholtz import BlochHelmholtz
            if (isinstance(self.op, BlochHelmholtz)
                    and not self.op._coef_elem_invariant()):
                pre = "gmg"
            else:
                pre = "jacobi"
        if pre == "gmg":
            from bravais_tpu.eigen.gmg import GMG
            self._gmg = GMG(self.op.space, alpha=self.op._alpha_fn,
                            beta=self.op._beta_fn,
                            dtype=self.op.dtype, fine_op=self.op)
        self._precond_mode = pre

    def _make_precond(self, k):
        pre = self._precond_mode
        if pre == "gmg":
            return self._gmg.precond(k)
        if pre == "jacobi":
            return jacobi(self.op.diag_A(k))
        if callable(pre):
            return pre(k)
        return None

    @property
    def _has_support(self) -> bool:
        """Solve hook returns a per-row block-support array (spectral
        engine) enabling the fast exact f64 refine (spectral_refine_np)."""
        return bool(getattr(self._solve_fn, "provides_support", False))

    def _solve(self, X0_reim, k, pc=None, setup=None, tol=None):
        X0 = from_reim(X0_reim)
        tol = self.tol if tol is None else tol
        if self._solve_fn is not None:
            kw = {} if pc is None else {"pc": pc}
            if setup is not None:
                kw["setup"] = setup
            r = self._solve_fn(self.op, X0, k, self.nev, tol,
                               self.maxiter, self._make_precond(k), **kw)
            if self._has_support:
                r, support = r
                return (r.eigenvalues, r.iterations, r.residual_norms,
                        to_reim(r.eigenvectors), support)
        else:
            r = lobpcg(lambda x: self.op.apply_A(x, k), self.op.apply_M,
                       X0, self.nev, maxiter=self.maxiter, tol=tol,
                       precond=self._make_precond(k), rr_tol=self.rr_tol)
        return (r.eigenvalues, r.iterations, r.residual_norms,
                to_reim(r.eigenvectors))

    def _refine_host(self, out, k):
        """f64 refine of one k-point's device outputs (``_solve`` tuple).

        Spectral engine: exact small-block eigensolve on the support-
        identified frequencies (``spectral_refine_np``, milliseconds);
        cross-checked against the device eigenvalues — a gross mismatch
        means the candidate blocks missed a band, and the all-dof host
        Rayleigh–Ritz is used as fallback. Other engines: host RR."""
        rf = getattr(self._solve_fn, "refine_np", None)
        suspect = False
        if rf is not None and len(out) > 4:
            ref = rf(np.asarray(out[4]), k, self.nev)
            if ref is not None:  # None: empty support (degenerate solve)
                lam, res = ref
                lam_d = np.asarray(out[0])[:self.nev]
                sc = np.maximum(
                    np.abs(lam_d),
                    3e-2 * max(float(np.abs(lam_d).max()), 1e-30))
                if lam.size == lam_d.size and np.all(
                        np.abs(lam - lam_d) / sc < 3e-2):
                    return lam, res
            suspect = True
        if out[3] is None:
            # Chain mode with support-only outputs: the eigenvector
            # block never left the device, so the all-dof fallback is
            # unavailable — keep the (residual-certified) device values
            # rather than trust a refine whose cross-check failed.
            return None
        # Fallback after a FAILED cross-check (or empty support) must
        # use the FULL m-row subspace: the suspected failure mode is a
        # true band mis-sorted into a guard row, which the default
        # nev+2-row trim (a per-k cost optimization for the healthy
        # field path) would exclude by construction.
        X = np.asarray(out[3])
        rows = X.shape[1] if suspect else None
        return host_rayleigh_ritz(self.op, X, k, self.nev, rows=rows)

    def _x0_np(self, dof_shape, rdtype) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        shp = (self.m,) + tuple(dof_shape)
        return np.stack([rng.standard_normal(shp),
                         rng.standard_normal(shp)]).astype(rdtype)

    # -- throughput mode ----------------------------------------------------

    def run(self, k_cart: np.ndarray, mesh=None, chunk: Optional[int] = None,
            writer=None, k_index: Optional[np.ndarray] = None
            ) -> SweepResult:
        """Batched sweep: all k-points vmapped; optionally sharded over
        ``mesh`` (1D device mesh, axis "k") and split into chunks.

        ``writer`` (bands.io.BandWriter): every finished chunk is
        written to disk IMMEDIATELY (crash-safe checkpointing, SURVEY.md
        §5) under global indices ``k_index`` (default 0..nk-1)."""
        sp = self.op.space
        rdtype = np.dtype(self.op.rdtype)
        k_cart = np.asarray(k_cart, rdtype)
        nk, d = k_cart.shape
        ndev = int(np.prod(mesh.devices.shape)) if mesh is not None else 1
        chunk = chunk or nk
        chunk = max(chunk, ndev)
        chunk = ((chunk + ndev - 1) // ndev) * ndev  # ndev-aligned

        nout = 3 if not (self.refine or self.keep_vectors) else (
            5 if self._has_support else 4)
        if self._jit_batched is None:
            if self.restart_tol:
                # Two-phase batched solve (see __init__ restart_tol).
                def one(X0, k):
                    mid = self._solve(X0, k, tol=self.restart_tol)
                    out = self._solve(mid[3], k)
                    return ((out[0], mid[1] + out[1], out[2])
                            + out[3:])[:nout]
                batched = jax.vmap(one, in_axes=(None, 0))
            else:
                batched = jax.vmap(
                    lambda X0, k: self._solve(X0, k)[:nout],
                    in_axes=(None, 0))
            if mesh is not None:
                self._jit_batched = jax.jit(
                    batched,
                    in_shardings=(replicated(mesh), shard_k(mesh)),
                    out_shardings=shard_k(mesh))
            else:
                self._jit_batched = jax.jit(batched)

        X0 = jnp.asarray(self._x0_np(
            getattr(sp, "field_shape", sp.dof_shape), rdtype))
        lam_all = np.zeros((0, self.nev), rdtype)
        its_all = np.zeros((0,), np.int32)
        res_all = np.zeros((0, self.nev), rdtype)
        vecs = [] if self.keep_vectors else None

        def launch(s):
            ks = k_cart[s:s + chunk]
            # Pad every chunk to the FULL chunk length (not just to a
            # multiple of ndev): a ragged final chunk would change the
            # jitted batch shape and recompile for one launch.
            pad = chunk - len(ks)
            if pad:
                ks = np.concatenate([ks, np.repeat(ks[-1:], pad, axis=0)])
            return ks, self._jit_batched(X0, jnp.asarray(ks))

        # Pipelined chunk loop (same discipline as run_warm): queue this
        # chunk's d2h copies, dispatch the NEXT chunk, and only then
        # block + host-refine — the f64 refine overlaps with the device
        # computing chunk j+1 instead of serializing between launches.
        starts = list(range(0, nk, chunk))
        t_start = time.time()
        compile_s = 0.0
        ks, out = launch(starts[0])
        for ci, s in enumerate(starts):
            if ci + 1 < len(starts):
                for o in out:
                    try:
                        o.copy_to_host_async()
                    except (AttributeError, RuntimeError):
                        break
                ks_next, out_next = launch(starts[ci + 1])
            # np.array (copy): np.asarray of device output is read-only,
            # and the refinement below writes into these.
            lam, its, res = (np.array(o) for o in out[:3])
            if ci == 0:
                compile_s = time.time() - t_start
            nkeep = len(k_cart[s:s + chunk])
            if self.refine or self.keep_vectors:
                X_reims = np.asarray(out[3])  # (nk_pad, 2, m, *dof)
            if self.refine:
                sup = np.asarray(out[4]) if len(out) > 4 else None
                for j in range(nkeep):
                    outj = (lam[j], None, None, X_reims[j]) + (
                        (sup[j],) if sup is not None else ())
                    lam[j, :self.nev], res[j, :self.nev] = \
                        self._refine_host(outj, ks[j])
            if vecs is not None:
                vecs.append(X_reims[:nkeep, :, :self.nev])
            lam_all = np.concatenate([lam_all, lam[:nkeep]])
            its_all = np.concatenate([its_all,
                                      np.asarray(its)[:nkeep].astype(np.int32)])
            res_all = np.concatenate([res_all, np.asarray(res)[:nkeep]])
            if writer is not None:
                gidx = (k_index[s:s + nkeep] if k_index is not None
                        else range(s, s + nkeep))
                writer.write_chunk(gidx, lam[:nkeep, :self.nev],
                                   its[:nkeep], res[:nkeep, :self.nev])
            if ci + 1 < len(starts):
                ks, out = ks_next, out_next
        # Steady wall: everything after the first (compiling) chunk's
        # outputs landed — includes every refine that was NOT hidden
        # behind a later chunk's device work (honest throughput).
        wall = time.time() - t_start - compile_s
        return SweepResult(lam_all, its_all, res_all, wall_s=wall,
                           compile_s=compile_s,
                           eigenvectors=(np.concatenate(vecs)
                                         if vecs else None))

    # -- latency / warm-start mode ------------------------------------------

    def run_warm(self, k_cart: np.ndarray, writer=None,
                 k_index: Optional[np.ndarray] = None) -> SweepResult:
        """Sequential sweep warm-starting each k from the previous
        eigenvector block (App. C.5 regime b). With ``writer``, every
        finished k-point is checkpointed immediately."""
        sp = self.op.space
        rdtype = np.dtype(self.op.rdtype)
        k_cart = np.asarray(k_cart, rdtype)

        if self._jit_single is None:
            self._jit_single = jax.jit(self._solve)

        X0 = jnp.asarray(self._x0_np(
            getattr(sp, "field_shape", sp.dof_shape), rdtype))
        # Near-Γ loose stop (see __init__): tol becomes a TRACED scalar
        # argument so one compiled program serves every k (value changes
        # never retrace); when the feature is off the call signature is
        # unchanged (tol baked as a constant — keeps existing programs
        # and cache keys bit-identical).
        use_ktol = (self.near_gamma_tol is not None
                    and self.near_gamma_norm > 0)
        ktol = (lambda i: {"tol": jnp.asarray(self._tol_for_k(k_cart[i]),
                                              rdtype)}) if use_ktol \
            else (lambda i: {})
        lams, itss, ress = [], [], []
        vecs = [] if self.keep_vectors else None
        nk = len(k_cart)
        t_start = time.time()
        out = self._jit_single(X0, jnp.asarray(k_cart[0]), **ktol(0))
        compile_s = 0.0
        for i in range(nk):
            # Pipeline: queue this k's device→host copies FIRST (the
            # stream executes in order — queuing them after the next
            # dispatch would block the host behind k+1's compute), then
            # dispatch the NEXT solve; the f64 refine below then
            # overlaps with the device computing k+1 (warm-started from
            # the still-on-device eigenvector block).
            # With the spectral refine, the full eigenvector block never
            # leaves the device (only the tiny (m, B) support does) —
            # unless modes were requested.
            need_X = self.keep_vectors or not (
                self.refine and self._has_support)
            if i + 1 < nk:
                for j, o in enumerate(out):
                    if j == 3 and not need_X:
                        continue
                    try:
                        o.copy_to_host_async()
                    except (AttributeError, RuntimeError):
                        break
                out_next = self._jit_single(out[3],
                                            jnp.asarray(k_cart[i + 1]),
                                            **ktol(i + 1))
            lam = np.asarray(out[0])   # blocks until solve i is done
            its = int(out[1])
            res = np.asarray(out[2])
            if i == 0:
                compile_s = time.time() - t_start
            if self.refine:
                lam, res = self._refine_host(out, k_cart[i])
            lams.append(lam)
            itss.append(its)
            ress.append(res)
            if vecs is not None:
                vecs.append(np.asarray(out[3])[:, :self.nev])
            if writer is not None:
                gi = int(k_index[i]) if k_index is not None else i
                writer.write_chunk([gi], lam[None, :self.nev],
                                   [its], res[None, :self.nev])
            if i + 1 < nk:
                out = out_next
        wall = time.time() - t_start - compile_s
        return SweepResult(np.asarray(lams), np.asarray(itss, np.int32),
                           np.asarray(ress), wall_s=wall,
                           compile_s=compile_s,
                           eigenvectors=(np.asarray(vecs)
                                         if vecs is not None else None))

    # -- latency mode with in-launch chaining --------------------------------

    def run_warm_chain(self, k_cart: np.ndarray, chain: int = 4,
                       writer=None,
                       k_index: Optional[np.ndarray] = None,
                       reuse_precond: bool = False,
                       precond: str = "per-k") -> SweepResult:
        """Warm sweep with ``chain`` consecutive k-points solved
        SEQUENTIALLY inside one launch (lax.scan carrying the
        eigenvector block on device). Same warm-start iteration counts
        and same per-solve working set as :meth:`run_warm` — but 1/chain
        the launches, for hosts where the per-launch dispatch and fetch
        cost is comparable to the device solve. Unlike
        ``run_warm_sharded`` (vmap across independent chains — S× the
        spectral engine's (B, D, D) setup arrays), sequential in-launch
        chaining adds NO working-set memory."""
        sp = self.op.space
        rdtype = np.dtype(self.op.rdtype)
        k_cart = np.asarray(k_cart, rdtype)
        nk, d = k_cart.shape
        chain = max(1, min(chain, nk))
        npad = ((nk + chain - 1) // chain) * chain - nk
        kp_ = np.concatenate([k_cart, np.repeat(k_cart[-1:], npad,
                                                axis=0)])
        need_X = self.keep_vectors or not (
            self.refine and self._has_support)

        if reuse_precond and precond == "per-k":
            precond = "chain-mid"
        if precond not in ("per-k", "chain-mid", "batched",
                           "batched-setup"):
            raise ValueError(f"unknown precond mode {precond!r}")

        # Resolve engine-capability downgrades FIRST so the program
        # cache below is keyed on the EFFECTIVE mode: asking for a
        # downgraded alias and then its effective mode (either order)
        # must not recompile an identical chain program.
        build_pc = (getattr(self._solve_fn, "build_pc", None)
                    if precond != "per-k" else None)
        build_setup = (getattr(self._solve_fn, "build_setup", None)
                       if precond == "batched-setup" else None)
        if precond == "batched-setup" and build_setup is None:
            precond = "batched"   # engine has no setup hook
        if build_pc is None:
            precond = "per-k"

        # The compiled chain program closes over the pc mode, the chain
        # length (chain-mid's ks[chain//2] index), and the output
        # layout (need_X) — rebuild if a later call changes ANY of
        # them (a silently reused wrong-config program would corrupt
        # A/B comparisons, and a stale chain int would index a wrong-k
        # chain-mid preconditioner).
        key = (precond, chain, need_X)
        if getattr(self, "_jit_chain_key", None) != key:
            self._jit_chain = None
        if self._jit_chain is None:
            self._jit_chain_key = key
            # Effective (post-downgrade) mode — bench.py records this
            # so A/B JSON lines self-describe what actually ran.
            self._jit_chain_mode = precond

            def chain_fn(X0, ks):
                # Preconditioner modes:
                #   per-k     — built inside each scan step (exact).
                #   chain-mid — built ONCE per launch at the chain's
                #               middle k and reused (staleness ≤ chain/2
                #               k-steps; measured to DOUBLE iterations at
                #               chain 8 — kept for small chains only).
                #   batched   — built for ALL chain k in one vmapped
                #               batched-Cholesky call before the scan:
                #               every solve still gets ITS OWN exact-k
                #               preconditioner (identical iterations to
                #               per-k), but the latency-bound per-k
                #               build is issued as one chain-wide
                #               batch. Costs chain× the pc working set.
                #               The per-k projector stays exact in every
                #               mode.
                #   batched-setup — like "batched" but hoists the FULL
                #               per-k setup (stencil blocks + projector
                #               factor + pc) into one vmapped pre-scan
                #               build, at chain× the setup working set.
                #               Iteration path identical to per-k
                #               (parity-gated).
                if precond == "batched-setup":
                    setups = jax.vmap(
                        lambda kk: build_setup(self.op, kk))(ks)

                    def step(X, xk):
                        k, su = xk
                        out = self._solve(X, k, setup=su)
                        ys = ((out[0], out[1], out[2])
                              + ((out[3],) if need_X else ())
                              + ((out[4],) if len(out) > 4 else ()))
                        return out[3], ys
                    Xl, ys = jax.lax.scan(step, X0, (ks, setups))
                    return (Xl,) + ys

                if precond == "batched":
                    pcs = jax.vmap(lambda kk: build_pc(self.op, kk))(ks)

                    def step(X, xk):
                        k, pc = xk
                        out = self._solve(X, k, pc=pc)
                        ys = ((out[0], out[1], out[2])
                              + ((out[3],) if need_X else ())
                              + ((out[4],) if len(out) > 4 else ()))
                        return out[3], ys
                    Xl, ys = jax.lax.scan(step, X0, (ks, pcs))
                    return (Xl,) + ys

                pc = (build_pc(self.op, ks[chain // 2])
                      if precond == "chain-mid" else None)

                def step(X, k):
                    out = self._solve(X, k, pc=pc)
                    ys = ((out[0], out[1], out[2])
                          + ((out[3],) if need_X else ())
                          + ((out[4],) if len(out) > 4 else ()))
                    return out[3], ys
                Xl, ys = jax.lax.scan(step, X0, ks)
                return (Xl,) + ys
            self._jit_chain = jax.jit(chain_fn)

        X0 = jnp.asarray(self._x0_np(
            getattr(sp, "field_shape", sp.dof_shape), rdtype))
        lams, itss, ress, vecs = [], [], [], ([] if self.keep_vectors
                                              else None)
        t_start = time.time()
        compile_s = 0.0
        nlaunch = (nk + npad) // chain
        out = self._jit_chain(X0, jnp.asarray(kp_[:chain]))
        for li in range(nlaunch):
            s0 = li * chain
            # Queue this launch's d2h first, then dispatch the next
            # launch (the stream executes in order),
            # then process/refine while the device runs ahead.
            if li + 1 < nlaunch:
                for o in out[1:]:
                    try:
                        o.copy_to_host_async()
                    except (AttributeError, RuntimeError):
                        break
                out_next = self._jit_chain(
                    out[0], jnp.asarray(kp_[s0 + chain:s0 + 2 * chain]))
            lam = np.array(out[1])           # (chain, m) — blocks
            its = np.asarray(out[2])
            res = np.array(out[3])
            Xs = np.asarray(out[4]) if need_X else None
            sup = (np.asarray(out[-1])
                   if len(out) > (4 + int(need_X)) else None)
            if li == 0:
                compile_s = time.time() - t_start
            for j in range(chain):
                gi = s0 + j
                if gi >= nk:
                    continue
                lj, rj = lam[j], res[j]
                if self.refine:
                    outj = (lam[j], None, None,
                            Xs[j] if Xs is not None else None) + (
                                (sup[j],) if sup is not None else ())
                    ref = self._refine_host(outj, kp_[gi])
                    if ref is not None:
                        lj = lj.copy()
                        rj = rj.copy()
                        lj[:self.nev], rj[:self.nev] = ref
                lams.append(lj)
                itss.append(int(its[j]))
                ress.append(rj)
                if vecs is not None:
                    vecs.append(Xs[j][:, :self.nev])
                if writer is not None:
                    go = int(k_index[gi]) if k_index is not None else gi
                    writer.write_chunk([go], lj[None, :self.nev], [its[j]],
                                       rj[None, :self.nev])
            if li + 1 < nlaunch:
                out = out_next
        wall = time.time() - t_start - compile_s
        return SweepResult(np.asarray(lams)[:, :self.nev],
                           np.asarray(itss, np.int32),
                           np.asarray(ress)[:, :self.nev], wall_s=wall,
                           compile_s=compile_s,
                           eigenvectors=(np.asarray(vecs)
                                         if vecs is not None else None))

    # -- combined regime: warm within segments, sharded across them ---------

    def run_warm_sharded(self, k_cart: np.ndarray, mesh=None, writer=None,
                         k_index: Optional[np.ndarray] = None,
                         segments: Optional[int] = None) -> SweepResult:
        """App. C.5 combined regime: the path is split into CONTIGUOUS
        segments; one launch per path position solves all segments'
        current k-points in parallel (vmapped, segment axis sharded
        over ``mesh`` when given), each warm-started from its segment's
        previous eigenvectors. Wall-clock scales as nk/segments while
        keeping the warm-start iteration savings within each segment.

        ``segments`` defaults to the device count of ``mesh`` (or 4
        single-device). On one device the spectral engine's per-segment
        (B, D, D) block setup scales linearly in S and makes the
        program memory-bound, so the mode's value is MULTI-DEVICE: one
        segment per device keeps warm-start iteration counts while the
        segment axis rides the mesh."""
        sp = self.op.space
        rdtype = np.dtype(self.op.rdtype)
        k_cart = np.asarray(k_cart, rdtype)
        nk, d = k_cart.shape
        base = int(np.prod(mesh.devices.shape)) if mesh is not None else 1
        ndev = segments or (base if mesh is not None else 4)
        if ndev % base:  # segment axis must shard evenly over devices
            ndev = ((ndev + base - 1) // base) * base
        per = (nk + ndev - 1) // ndev
        pad = ndev * per - nk
        kp_ = np.concatenate([k_cart, np.repeat(k_cart[-1:], pad, axis=0)])
        kseg = kp_.reshape(ndev, per, d)

        if self._jit_seg is None:
            batched = jax.vmap(self._solve, in_axes=(0, 0))
            if mesh is not None:
                self._jit_seg = jax.jit(
                    batched,
                    in_shardings=(shard_k(mesh), shard_k(mesh)),
                    out_shardings=shard_k(mesh))
            else:
                self._jit_seg = jax.jit(batched)

        shp = (self.m,) + tuple(getattr(sp, "field_shape", sp.dof_shape))
        X0 = jnp.asarray(np.broadcast_to(
            self._x0_np(shp[1:], rdtype)[None], (ndev, 2) + shp).copy())
        lam_all = np.zeros((ndev, per, self.nev), rdtype)
        its_all = np.zeros((ndev, per), np.int32)
        res_all = np.zeros((ndev, per, self.nev), rdtype)
        vecs = (np.zeros((ndev, per, 2, self.nev) + shp[1:], rdtype)
                if self.keep_vectors else None)
        wall = compile_s = 0.0
        for t in range(per):
            t0 = time.time()
            outs = self._jit_seg(X0, jnp.asarray(kseg[:, t]))
            its, X_reim = outs[1], outs[3]
            if vecs is not None:
                vecs[:, t] = np.asarray(X_reim)[:, :, :self.nev]
            sup = outs[4] if len(outs) > 4 else None
            lam = np.array(outs[0])
            res = np.array(outs[2])
            if self.refine:
                for s_ in range(ndev):
                    gi = s_ * per + t
                    if gi >= nk:
                        continue
                    outj = (lam[s_], None, None, X_reim[s_]) + (
                        (np.asarray(sup[s_]),) if sup is not None
                        else ())
                    lam[s_, :self.nev], res[s_, :self.nev] = \
                        self._refine_host(outj, kseg[s_, t])
            dt = time.time() - t0
            if t == 0:
                compile_s = dt
            else:
                wall += dt
            lam_all[:, t] = lam[:, :self.nev]
            its_all[:, t] = np.asarray(its)
            res_all[:, t] = res[:, :self.nev]
            if writer is not None:
                gis = [s_ * per + t for s_ in range(ndev)
                       if s_ * per + t < nk]
                rows = [s_ for s_ in range(ndev) if s_ * per + t < nk]
                gout = ([int(k_index[g]) for g in gis]
                        if k_index is not None else gis)
                writer.write_chunk(gout, lam[rows, :self.nev],
                                   np.asarray(its)[rows], res[rows,
                                                              :self.nev])
            X0 = X_reim
        lam_flat = lam_all.reshape(ndev * per, self.nev)[:nk]
        its_flat = its_all.reshape(ndev * per)[:nk]
        res_flat = res_all.reshape(ndev * per, self.nev)[:nk]
        return SweepResult(lam_flat, its_flat, res_flat, wall_s=wall,
                           compile_s=compile_s,
                           eigenvectors=(vecs.reshape(
                               (ndev * per, 2, self.nev) + shp[1:])[:nk]
                               if vecs is not None else None))
