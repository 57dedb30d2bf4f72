"""Generic tensor-product element machinery on periodic structured grids.

Implements the E-vector gather / scatter (MFEM's ``ElementRestriction``
equivalent, SURVEY.md §2.2 #8) and the sum-factorized contractions of
SURVEY.md App. B.4 — but exploiting the periodic structured grid so that
the gather is pure reshape + roll + concat (no index gather at all, an
XLA-friendly structural win over the reference's indirection arrays).

Layout convention
-----------------
* Global dof arrays have one axis per spatial dimension: shape
  ``(N_1, ..., N_d)`` with ``N_i = n_i * p_i`` (closed *or* open — the
  periodic dof count is the same, SURVEY.md App. C.1).
* Element-local ("E-vector") arrays interleave element and local axes:
  ``(n_1, l_1, n_2, l_2, ...)`` with ``l_i = p_i + 1`` for closed
  directions (last node shared with the next element) and ``l_i = p_i``
  for open directions.
* Quadrature-space arrays are ``(n_1, q_1, n_2, q_2, ...)``.

All functions are pure JAX, jit/vmap-safe, and dtype-preserving.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp

__all__ = ["gather", "scatter_add", "contract", "contract_t",
           "gather_np", "scatter_add_np", "contract_np", "contract_t_np"]


def gather(u: jax.Array, shape: Sequence[int], p: Sequence[int],
           closed: Sequence[bool]) -> jax.Array:
    """Global dofs -> element-local dofs.

    ``u`` has shape ``(n_i * p_i)_i``; the result interleaves
    ``(n_i, l_i)_i``. For a closed direction, element e's locals are
    ``[u[e*p : (e+1)*p], u[((e+1) % n) * p]]`` — realized as a reshape
    plus a rolled copy of each element's first dof.
    """
    d = len(shape)
    for i in range(d):
        ax = 2 * i
        pre = u.shape[:ax]
        post = u.shape[ax + 1:]
        u = u.reshape(*pre, shape[i], p[i], *post)
        if closed[i]:
            first = jax.lax.slice_in_dim(u, 0, 1, axis=ax + 1)
            u = jnp.concatenate([u, jnp.roll(first, -1, axis=ax)],
                                axis=ax + 1)
    return u


def scatter_add(r: jax.Array, shape: Sequence[int], p: Sequence[int],
                closed: Sequence[bool]) -> jax.Array:
    """Adjoint of :func:`gather`: element-local contributions -> global sum.

    Exact transpose (verified by inner-product tests), so assembled
    operators built on gather/scatter_add stay Hermitian.
    """
    d = len(shape)
    for i in reversed(range(d)):
        ax = 2 * i
        if closed[i]:
            main = jax.lax.slice_in_dim(r, 0, p[i], axis=ax + 1)
            last = jax.lax.slice_in_dim(r, p[i], p[i] + 1, axis=ax + 1)
            last = jnp.roll(last, 1, axis=ax)
            idx = (slice(None),) * (ax + 1) + (0,)
            main = main.at[idx].add(jnp.squeeze(last, axis=ax + 1))
        else:
            main = r
        pre = main.shape[:ax]
        post = main.shape[ax + 2:]
        r = main.reshape(*pre, shape[i] * p[i], *post)
    return r


def contract(ue: jax.Array, tables: Sequence[jax.Array]) -> jax.Array:
    """Element dofs -> quadrature values: contract each local axis with
    ``tables[i]`` of shape ``(q_i, l_i)`` (sum factorization, App. B.4)."""
    d = len(tables)
    for i in range(d):
        ax = 2 * i + 1
        ue = jnp.moveaxis(jnp.tensordot(tables[i], ue, axes=((1,), (ax,))),
                          0, ax)
    return ue


def contract_t(vq: jax.Array, tables: Sequence[jax.Array]) -> jax.Array:
    """Transpose of :func:`contract`: quadrature -> element dofs."""
    d = len(tables)
    for i in range(d):
        ax = 2 * i + 1
        vq = jnp.moveaxis(jnp.tensordot(tables[i], vq, axes=((0,), (ax,))),
                          0, ax)
    return vq


# ---------------------------------------------------------------------------
# NumPy twins — for host-side precomputation (operator diagonals, oracle
# setup). jit-embedded constants are host arrays, so one-time setup math
# stays off-device entirely.
# ---------------------------------------------------------------------------
import numpy as _np  # noqa: E402


def gather_np(u, shape, p, closed):
    for i in range(len(shape)):
        ax = 2 * i
        u = u.reshape(*u.shape[:ax], shape[i], p[i], *u.shape[ax + 1:])
        if closed[i]:
            first = _np.take(u, [0], axis=ax + 1)
            u = _np.concatenate([u, _np.roll(first, -1, axis=ax)],
                                axis=ax + 1)
    return u


def scatter_add_np(r, shape, p, closed):
    for i in reversed(range(len(shape))):
        ax = 2 * i
        if closed[i]:
            main = _np.take(r, range(p[i]), axis=ax + 1).copy()
            last = _np.roll(_np.take(r, [p[i]], axis=ax + 1), 1, axis=ax)
            idx = (slice(None),) * (ax + 1) + (0,)
            main[idx] += _np.squeeze(last, axis=ax + 1)
        else:
            main = r
        r = main.reshape(*main.shape[:ax], shape[i] * p[i],
                         *main.shape[ax + 2:])
    return r


def contract_np(ue, tables):
    for i in range(len(tables)):
        ax = 2 * i + 1
        ue = _np.moveaxis(_np.tensordot(tables[i], ue, axes=((1,), (ax,))),
                          0, ax)
    return ue


def contract_t_np(vq, tables):
    for i in range(len(tables)):
        ax = 2 * i + 1
        vq = _np.moveaxis(_np.tensordot(tables[i], vq, axes=((0,), (ax,))),
                          0, ax)
    return vq


# ---------------------------------------------------------------------------
# Quasi-periodic (Bloch-phased) single-axis gather/scatter.
#
# For Bloch problems posed in the QUASI-PERIODIC formulation
# (u(x + a_i) = e^{i k·a_i} u(x); operator k-independent, k enters only
# through these wrap phases — the same realization as MFEM's
# Bloch-phased periodic dof identification, SURVEY.md §3.2), the
# element gather multiplies the wrapped copy (last element's shared
# node, which lives at x = a_i) by phase_i; the scatter-adjoint uses the
# conjugate. phase_i may be a traced complex scalar — one compiled
# program still serves every k.
# ---------------------------------------------------------------------------


def gather_axis(u, axis, n, p, phase=None):
    """Closed gather along one axis: size n*p -> (n, p+1) at ``axis``.
    ``phase`` (complex scalar or None) multiplies the wrapped entry."""
    shape = u.shape
    u = u.reshape(*shape[:axis], n, p, *shape[axis + 1:])
    first = jax.lax.slice_in_dim(u, 0, 1, axis=axis + 1)
    if phase is None:
        rolled = jnp.roll(first, -1, axis=axis)
    else:
        head = jax.lax.slice_in_dim(first, 1, n, axis=axis)
        tail = jax.lax.slice_in_dim(first, 0, 1, axis=axis) * phase
        rolled = jnp.concatenate([head, tail], axis=axis)
    return jnp.concatenate([u, rolled], axis=axis + 1)


def scatter_add_axis(r, axis, n, p, phase=None):
    """Adjoint of :func:`gather_axis` (conjugate phase on the wrap)."""
    main = jax.lax.slice_in_dim(r, 0, p, axis=axis + 1)
    last = jax.lax.slice_in_dim(r, p, p + 1, axis=axis + 1)
    if phase is None:
        last = jnp.roll(last, 1, axis=axis)
    else:
        head = jax.lax.slice_in_dim(last, n - 1, n, axis=axis) \
            * jnp.conj(phase)
        tail = jax.lax.slice_in_dim(last, 0, n - 1, axis=axis)
        last = jnp.concatenate([head, tail], axis=axis)
    idx = (slice(None),) * (axis + 1) + (0,)
    main = main.at[idx].add(jnp.squeeze(last, axis=axis + 1))
    shape = main.shape
    return main.reshape(*shape[:axis], n * p, *shape[axis + 2:])


def gather_axis_np(u, axis, n, p, phase=None):
    """NumPy twin of :func:`gather_axis` (host f64 paths)."""
    shape = u.shape
    u = u.reshape(*shape[:axis], n, p, *shape[axis + 1:])
    first = _np.take(u, [0], axis=axis + 1)
    rolled = _np.roll(first, -1, axis=axis)
    if phase is not None:
        sel = [slice(None)] * rolled.ndim
        sel[axis] = slice(n - 1, n)
        rolled = rolled.copy()
        rolled[tuple(sel)] = rolled[tuple(sel)] * phase
    return _np.concatenate([u, rolled], axis=axis + 1)


def scatter_add_axis_np(r, axis, n, p, phase=None):
    """NumPy twin of :func:`scatter_add_axis`."""
    main = _np.take(r, range(p), axis=axis + 1).copy()
    last = _np.roll(_np.take(r, [p], axis=axis + 1), 1, axis=axis)
    if phase is not None:
        sel = [slice(None)] * last.ndim
        sel[axis] = slice(0, 1)
        last[tuple(sel)] = last[tuple(sel)] * _np.conj(phase)
    idx = (slice(None),) * (axis + 1) + (0,)
    main[idx] += _np.squeeze(last, axis=axis + 1)
    shape = main.shape
    return main.reshape(*shape[:axis], n * p, *shape[axis + 2:])


def gather_qp(u, shape, p, closed, phases):
    """Quasi-periodic multi-axis gather: like :func:`gather` but closed
    axes wrap with their Bloch phase. ``phases``: length-d list (entries
    ignored for open axes)."""
    for i in range(len(shape)):
        ax = 2 * i
        if closed[i]:
            u = gather_axis(u, ax, shape[i], p[i], phases[i])
        else:
            pre = u.shape[:ax]
            post = u.shape[ax + 1:]
            u = u.reshape(*pre, shape[i], p[i], *post)
    return u


def scatter_add_qp(r, shape, p, closed, phases):
    for i in reversed(range(len(shape))):
        ax = 2 * i
        if closed[i]:
            r = scatter_add_axis(r, ax, shape[i], p[i], phases[i])
        else:
            pre = r.shape[:ax]
            post = r.shape[ax + 2:]
            r = r.reshape(*pre, shape[i] * p[i], *post)
    return r
