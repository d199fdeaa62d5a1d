"""Exact attenuation line integrals E(p, q) = int_seg sigma_t, vectorized.

The reference computes E by a data-dependent 9-case split plus recursive
bisection (KernelFactory.cpp:67-166 `lineIntegral`), then a per-cell Gauss
rule on each sub-segment (`integral_helper`, :174-190).  That control flow is
poison for XLA.  Here the same *exact* quadrature is recast branch-free:

  1. enumerate the (statically bounded) set of grid-line crossings of the
     segment as parameters t in (0, 1) -- padded with t = 1 so every pair
     has the same static count;
  2. sort the breakpoints; zero-length sub-segments contribute exactly 0;
  3. on each sub-segment, locate the cell from the midpoint and integrate
     the per-cell Legendre expansion of sigma_t with a deg-point Gauss rule
     (exact: the integrand restricted to a cell is a polynomial of degree
     <= 2(deg-1) in t).

Everything is a fixed-shape tensor program: vmap over point pairs, gathers
for the per-cell coefficients, fused elementwise polynomial evaluation.

`compat_global_basis` replicates a reference quirk: the per-square expansion
coefficients are computed against the basis at *local* [-1,1] coordinates
(KernelFactory.cpp:212-227) but the reference evaluates the basis at *global*
[0,1] coordinates (integral_helper :180-186, evaluate :198-205).  The default
(False) evaluates at local coordinates, which is the mathematically consistent
interpolation; True matches the reference bit-for-bit for oracle tests.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.geometry import Grid
from ..core.legendre import legendre_all

HIGHEST = jax.lax.Precision.HIGHEST


def make_sigma_eval(grid: Grid, compat_global_basis: bool = False):
    """Returns sigma_eval(coeffs, x, y) evaluating the per-square expansion.

    coeffs: (sz, sz, deg^2) normalized-Legendre coefficients (from
    `aniso_tpu.ops.fields.project`), x/y: arbitrary equal-shape arrays.
    """
    sz, deg = grid.sz, grid.deg
    norms = jnp.asarray(grid.norms)

    def sigma_eval(coeffs, x, y):
        i = jnp.clip(jnp.floor(x * sz).astype(jnp.int32), 0, sz - 1)
        j = jnp.clip(jnp.floor(y * sz).astype(jnp.int32), 0, sz - 1)
        if compat_global_basis:
            ex, ey = x, y
        else:
            ex = 2.0 * (x * sz - i) - 1.0
            ey = 2.0 * (y * sz - j) - 1.0
        px = legendre_all(deg, ex)  # (deg, ...)
        py = legendre_all(deg, ey)
        basis = (px[:, None] * py[None, :]).reshape((deg * deg,) + x.shape)
        basis = basis / norms.reshape((deg * deg,) + (1,) * x.ndim)
        c = coeffs.reshape(sz * sz, deg * deg)[i * sz + j]  # (..., deg^2)
        return jnp.einsum("q...,...q->...", basis, c, precision=HIGHEST)

    return sigma_eval


def _crossings(a0: jnp.ndarray, a1: jnp.ndarray, sz: int, kmax: int):
    """Parameters t of the segment's crossings with gridlines a = k/sz.

    a0, a1: scalars (one coordinate of the endpoints).  Returns (kmax,)
    array of t values in [0, 1] in ASCENDING order, padded with 1.0.
    Ascending order is arranged by walking the gridlines in the direction
    of travel, so downstream code can merge without sorting (a sort under
    a large vmapped batch is a compile-time sink).
    """
    lo = jnp.minimum(a0, a1)
    hi = jnp.maximum(a0, a1)
    i_lo = jnp.floor(lo * sz)
    i_hi = jnp.floor(hi * sz)
    ncross = jnp.clip((i_hi - i_lo).astype(jnp.int32), 0, kmax)
    m = jnp.arange(kmax, dtype=a0.dtype)
    denom = a1 - a0
    # walk gridlines in the direction of travel -> t ascending in m
    ks = jnp.where(denom >= 0.0, i_lo + 1.0 + m, i_hi - m)
    lines = ks / sz
    safe = jnp.where(denom == 0.0, 1.0, denom)
    t = (lines - a0) / safe
    valid = (jnp.arange(kmax) < ncross) & (denom != 0.0)
    return jnp.where(valid, jnp.clip(t, 0.0, 1.0), 1.0)


def _merge_breakpoints(tx: jnp.ndarray, ty: jnp.ndarray):
    """Stable merge of two ascending (kmax,) arrays plus {0, 1} endpoints.

    Returns the (2*kmax + 2,) ascending breakpoint array [0, merge(tx,ty), 1]
    built with rank computation + one-hot contractions -- no sort primitive
    (compile-friendly under heavy vmap).
    """
    k = tx.shape[0]
    n = 2 * k + 2
    # stable ranks into positions 1 .. 2k
    pos_tx = 1 + jnp.arange(k) + jnp.sum(ty[None, :] < tx[:, None], axis=1)
    pos_ty = 1 + jnp.arange(k) + jnp.sum(tx[None, :] <= ty[:, None], axis=1)
    slots = jnp.arange(n)
    oh_tx = (pos_tx[:, None] == slots[None, :]).astype(tx.dtype)
    oh_ty = (pos_ty[:, None] == slots[None, :]).astype(tx.dtype)
    # HIGHEST: an f32 product in reduced precision would round the
    # breakpoints it places (~1e-3), moving every sub-segment boundary
    ts = (jnp.matmul(tx, oh_tx, precision=HIGHEST)
          + jnp.matmul(ty, oh_ty, precision=HIGHEST))
    # slot 0 stays 0; last slot is the endpoint t = 1
    return ts.at[-1].set(1.0)


def make_line_integral(
    grid: Grid,
    max_cross: int,
    compat_global_basis: bool = False,
    n_pieces: int = 1,
):
    """Returns E(coeffs, p0x, p0y, p1x, p1y) for scalar endpoints (vmap it).

    max_cross: static bound on grid-line crossings *per axis* per piece.
    n_pieces: the segment is split into n_pieces equal parameter chunks
    accumulated with lax.scan -- E is additive along the segment, so a long
    segment (coarse-level M2L pairs spanning many cells) reuses the same
    small compiled body instead of inflating max_cross (XLA compile time
    scales with the static segment count; measured 222 s at max_cross=16
    vs seconds at 4).  Exactness is preserved for any split.

    Callers guarantee n_pieces * max_cross >= total crossings per axis,
    e.g. near-field neighbours: (1, 1); level-l FMM M2L: max_cross=4,
    n_pieces=ceil(5 * boxsize_in_cells / 4).
    """
    sz, deg = grid.sz, grid.deg
    gpts = jnp.asarray(grid.rule.points)    # (deg,)
    gwts = jnp.asarray(grid.rule.weights)
    norms = jnp.asarray(grid.norms)

    def piece_integral(coeffs_flat, x0, y0, x1, y1):
        tx = _crossings(x0, x1, sz, max_cross)
        ty = _crossings(y0, y1, sz, max_cross)
        ts = _merge_breakpoints(tx, ty)
        ta, tb = ts[:-1], ts[1:]            # (nseg,) sub-segments
        tm = 0.5 * (ta + tb)
        half = 0.5 * (tb - ta)
        tg = tm[:, None] + half[:, None] * gpts[None, :]   # (nseg, deg)
        xg = x0 + tg * (x1 - x0)
        yg = y0 + tg * (y1 - y0)
        # cell from the sub-segment midpoint (reference integral_helper:176)
        xm = x0 + tm * (x1 - x0)
        ym = y0 + tm * (y1 - y0)
        i = jnp.clip(jnp.floor(xm * sz).astype(jnp.int32), 0, sz - 1)
        j = jnp.clip(jnp.floor(ym * sz).astype(jnp.int32), 0, sz - 1)
        if compat_global_basis:
            ex, ey = xg, yg
        else:
            ex = 2.0 * (xg * sz - i[:, None]) - 1.0
            ey = 2.0 * (yg * sz - j[:, None]) - 1.0
        px = legendre_all(deg, ex)          # (deg, nseg, deg)
        py = legendre_all(deg, ey)
        basis = (px[:, None] * py[None, :]).reshape(deg * deg, *xg.shape)
        basis = basis / norms[:, None, None]
        c = coeffs_flat[i * sz + j]                          # (nseg, deg^2)
        vals = jnp.einsum("qsg,sq->sg", basis, c,
                          precision=HIGHEST)                 # (nseg, deg)
        seg = jnp.einsum("sg,g->s", vals, gwts,
                         precision=HIGHEST)                  # sum_g w_g f
        seg_len = jnp.sqrt((x1 - x0) ** 2 + (y1 - y0) ** 2) * (tb - ta)
        return jnp.sum(seg * seg_len) / 2.0

    def line_integral(coeffs, x0, y0, x1, y1):
        cf = coeffs.reshape(sz * sz, deg * deg)
        if n_pieces == 1:
            return piece_integral(cf, x0, y0, x1, y1)

        dxp = (x1 - x0) / n_pieces
        dyp = (y1 - y0) / n_pieces

        def body(acc, k):
            kf = k.astype(x0.dtype)
            ax = x0 + kf * dxp
            ay = y0 + kf * dyp
            acc = acc + piece_integral(cf, ax, ay, ax + dxp, ay + dyp)
            return acc, None

        acc, _ = jax.lax.scan(
            body, jnp.zeros((), dtype=x0.dtype), jnp.arange(n_pieces)
        )
        return acc

    return jax.jit(line_integral)


def line_integral_batch(grid: Grid, coeffs, p0, p1, max_cross: int,
                        compat_global_basis: bool = False, n_pieces: int = 1):
    """Batched E over pairs: p0, p1 of shape (..., 2) -> (...)."""
    li = make_line_integral(grid, max_cross, compat_global_basis, n_pieces)
    flat0 = p0.reshape(-1, 2)
    flat1 = p1.reshape(-1, 2)
    fn = jax.vmap(lambda a, b: li(coeffs, a[0], a[1], b[0], b[1]))
    out = fn(flat0, flat1)
    return out.reshape(p0.shape[:-1])
