"""Slow, scalar-loop implementation of the reference operator semantics.

This is an independent numpy re-derivation of the reference pipeline
(main.cpp:78-119: dense sums in place of the FMM, nearRemoval,
refineAddOnFast, singularAddFast) used as a small-grid oracle for the
vectorized implementation.  Deliberately written with per-pair loops that
follow the reference control flow, so an indexing bug in the tensorized code
cannot be replicated here.
"""

import numpy as np

from aniso_tpu.core.geometry import Grid
from aniso_tpu.core.legendre import legendre_all_np


def sigma_hat_factory(grid: Grid, coeffs, compat):
    sz, deg = grid.sz, grid.deg
    coeffs = np.asarray(coeffs).reshape(sz * sz, deg * deg)

    def sigma_hat(x, y):
        ci = min(max(int(np.floor(x * sz)), 0), sz - 1)
        cj = min(max(int(np.floor(y * sz)), 0), sz - 1)
        if compat:
            ex, ey = x, y
        else:
            ex = 2.0 * (x * sz - ci) - 1.0
            ey = 2.0 * (y * sz - cj) - 1.0
        px = legendre_all_np(deg, np.array(ex))
        py = legendre_all_np(deg, np.array(ey))
        b = (px[:, None] * py[None, :]).reshape(-1) / grid.norms
        return float(b @ coeffs[ci * sz + cj])

    return sigma_hat


def line_integral_factory(grid: Grid, coeffs, compat):
    """Reference lineIntegral semantics (KernelFactory.cpp:67-190)."""
    sz, deg = grid.sz, grid.deg
    pts, wts = grid.rule.points, grid.rule.weights
    coeffs = np.asarray(coeffs).reshape(sz * sz, deg * deg)

    def basis_at(x, y, ci, cj):
        if compat:
            ex, ey = x, y
        else:
            ex = 2.0 * (x * sz - ci) - 1.0
            ey = 2.0 * (y * sz - cj) - 1.0
        px = legendre_all_np(deg, np.array(ex))
        py = legendre_all_np(deg, np.array(ey))
        return (px[:, None] * py[None, :]).reshape(-1) / grid.norms

    def helper(x0, y0, x1, y1):
        ci = min(max(int(np.floor((x0 + x1) / 2 * sz)), 0), sz - 1)
        cj = min(max(int(np.floor((y0 + y1) / 2 * sz)), 0), sz - 1)
        ret = 0.0
        for i in range(deg):
            x = (x0 + x1) / 2 + (x0 - x1) / 2 * pts[i]
            y = (y0 + y1) / 2 + (y0 - y1) / 2 * pts[i]
            ret += float(basis_at(x, y, ci, cj) @ coeffs[ci * sz + cj]) * wts[i]
        return ret * np.hypot(x0 - x1, y0 - y1) / 2.0

    def rec(x0, y0, x1, y1):
        c0, c1 = int(np.floor(x0 * sz)), int(np.floor(x1 * sz))
        r0, r1 = int(np.floor(y0 * sz)), int(np.floor(y1 * sz))
        if abs(c0 - c1) <= 1 and abs(r0 - r1) <= 1:
            ts = [0.0, 1.0]
            if c0 != c1 and x1 != x0:
                ts.append((max(c0, c1) / sz - x0) / (x1 - x0))
            if r0 != r1 and y1 != y0:
                ts.append((max(r0, r1) / sz - y0) / (y1 - y0))
            ts = sorted(ts)
            return sum(
                helper(x0 + a * (x1 - x0), y0 + a * (y1 - y0),
                       x0 + b * (x1 - x0), y0 + b * (y1 - y0))
                for a, b in zip(ts[:-1], ts[1:])
            )
        xm, ym = (x0 + x1) / 2, (y0 + y1) / 2
        return rec(x0, y0, xm, ym) + rec(xm, ym, x1, y1)

    return rec


def apply_mapping_reference(grid: Grid, m, u, sigma_t_coeff, sing_rule,
                            compat=False):
    """Corrected mode-m matvec, scalar-loop dense version (main.cpp:78-119).

    u: (sz, sz, nq) raw charge.  Returns (sz, sz, nq).
    """
    from aniso_tpu.ops.duffy import duffy_tables

    sz, deg, nq, dx = grid.sz, grid.deg, grid.nq, grid.dx
    n = sz * sz * nq
    X = grid.nodes_x.reshape(-1)
    Y = grid.nodes_y.reshape(-1)
    W = grid.weights.reshape(-1)
    u = np.asarray(u).reshape(-1)
    li = line_integral_factory(grid, sigma_t_coeff, compat)
    sh = sigma_hat_factory(grid, sigma_t_coeff, compat)

    def realk(ax, ay, bx, by):
        r = np.hypot(ax - bx, ay - by)
        if r == 0.0:
            return 0.0
        return np.cos(m * np.arctan2(ay - by, ax - bx)) / r

    def smoothk(ax, ay, bx, by):
        r = np.hypot(ax - bx, ay - by)
        if r == 0.0:
            return sh(ax, ay) if m == 0 else 0.0
        E = li(ax, ay, bx, by)
        return (np.exp(-E) - 1.0) * np.cos(m * np.arctan2(ay - by, ax - bx)) / r

    wu = u * W
    out = np.zeros(n)

    # dense smooth + real all-pairs (in place of the two FMMs)
    for t in range(n):
        acc = 0.0
        for s in range(n):
            acc += (smoothk(X[s], Y[s], X[t], Y[t])
                    + realk(X[s], Y[s], X[t], Y[t])) * wu[s]
        out[t] = acc

    # nearRemoval (KernelFactory.cpp:445-478): subtract coarse 3x3 incl self
    for ti in range(sz):
        for tj in range(sz):
            for kt in range(nq):
                t = (ti * sz + tj) * nq + kt
                for di in (-1, 0, 1):
                    for dj in (-1, 0, 1):
                        si, sj = ti + di, tj + dj
                        if not (0 <= si < sz and 0 <= sj < sz):
                            continue
                        for ks in range(nq):
                            s = (si * sz + sj) * nq + ks
                            out[t] -= realk(X[s], Y[s], X[t], Y[t]) * wu[s]

    # refineAddOnFast (KernelFactory.cpp:662-709): 8 neighbours refined
    NM = grid.near_mapping
    for ti in range(sz):
        for tj in range(sz):
            for kt in range(nq):
                t = (ti * sz + tj) * nq + kt
                for di in (-1, 0, 1):
                    for dj in (-1, 0, 1):
                        if di == 0 and dj == 0:
                            continue
                        si, sj = ti + di, tj + dj
                        if not (0 <= si < sz and 0 <= sj < sz):
                            continue
                        old = np.array([
                            wu[(si * sz + sj) * nq + ks] / grid.sqrt_w2d[ks]
                            for ks in range(nq)
                        ])
                        new = NM @ old
                        for r in range(grid.refine_nq):
                            px = (0.5 + si) * dx + 0.5 * grid.refine_x[r] * dx
                            py = (0.5 + sj) * dx + 0.5 * grid.refine_y[r] * dx
                            out[t] += (realk(px, py, X[t], Y[t])
                                       * np.sqrt(grid.refine_w[r]) * new[r])

    # singularAddFast (KernelFactory.cpp:828-860): Duffy self square
    DX, DY, DW = duffy_tables(deg, sing_rule, grid.qx, grid.qy)
    nq_sing = DX.shape[1]
    for ti in range(sz):
        for tj in range(sz):
            # unscaled coefficients of u on this square
            uloc = np.array([u[(ti * sz + tj) * nq + k] for k in range(nq)])
            c = grid.proj @ uloc
            for kt in range(nq):
                t = (ti * sz + tj) * nq + kt
                for q in range(nq_sing):
                    px = (0.5 + ti) * dx + 0.5 * DX[kt, q] * dx
                    py = (0.5 + tj) * dx + 0.5 * DY[kt, q] * dx
                    w = DW[kt, q] * dx * dx / 4.0
                    if compat:
                        ex, ey = px, py
                    else:
                        ex, ey = DX[kt, q], DY[kt, q]
                    pxl = legendre_all_np(deg, np.array(ex))
                    pyl = legendre_all_np(deg, np.array(ey))
                    basis = (pxl[:, None] * pyl[None, :]).reshape(-1) / grid.norms
                    out[t] += (realk(px, py, X[t], Y[t]) * w) * float(basis @ c)

    return (out / (2.0 * np.pi)).reshape(sz, sz, nq)
