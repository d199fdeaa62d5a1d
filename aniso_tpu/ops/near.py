"""Translation-invariant near-field correction stencil.

The reference's near-field pipeline per corrected matvec is three passes over
every node (KernelFactory.cpp:445-478 `nearRemoval`, :662-709
`refineAddOnFast`, :828-860 `singularAddFast`) backed by per-node caches of
size O(N * 9 * 16 deg^2) and O(N * 8 singRule^2) (`nearInteractions`,
`singInteractions`) -- gigabytes at scale, filled by per-pair scalar kernel
evaluations (:550-609, :752-788).

On the uniform grid every one of those interactions is translation invariant:
the kernel cos(m theta)/r depends only on the offset between squares, and the
refined/Duffy quadrature geometry is identical in every square.  The three
passes therefore collapse into a single (3, 3, deg^2, deg^2) stencil applied
to the raw per-square charge:

  correction[t] = sum_off S_m[off] @ u[square + off]

with S_m = -coarse(3x3) + refined(8 neighbours) + duffy(self).  Building S_m
costs O(deg^4 * (9 + 8*16 deg^2 + 8 singRule^2)) -- microseconds -- and is
independent of grid size.  Application is a 3x3 "conv" with deg^2 channels:
one small convolution instead of gigabytes of cache traffic.

Note the exact composition (SURVEY.md section 7 hard part (e)): the coarse
removal *includes* the self square (reference :460 commented-out `continue`),
the refined add-on *excludes* it (:565/:677), and Duffy adds it back.

In `compat_global_basis` mode the Duffy term evaluates the Legendre basis at
global coordinates (reference KernelFactory.cpp:848-851), which breaks
translation invariance of that one term; a per-square Duffy matrix stack is
returned instead (still tiny).
"""

from __future__ import annotations

import numpy as np

from ..core.geometry import Grid
from ..core.legendre import basis2d_np
from .duffy import duffy_tables


def real_kernel_np(m: int, ax, ay, bx, by):
    """numpy twin of ops.kernels.real_kernel (cos(m theta)/r, 0 at r=0)."""
    dx = np.asarray(ax) - np.asarray(bx)
    dy = np.asarray(ay) - np.asarray(by)
    r = np.sqrt(dx * dx + dy * dy)
    safe = np.where(r == 0.0, 1.0, r)
    ang = np.arctan2(dy, dx)
    return np.where(r == 0.0, 0.0, np.cos(m * ang) / safe)


def build_coarse_removal(grid: Grid, m: int) -> np.ndarray:
    """(3,3,nq,nq): coarse 3x3 real-kernel blocks, acting on raw charge.

    Entry [di+1, dj+1, kt, ks] = real_m(src, tgt) * w2d[ks] * dx^2/4,
    matching nearRemoval's eval(source, target) * weights (the caller
    subtracts it).
    """
    nq, dx = grid.nq, grid.dx
    offs = np.array([-1, 0, 1])
    tx = 0.5 * dx + 0.5 * grid.qx * dx              # (nq,)
    ty = 0.5 * dx + 0.5 * grid.qy * dx
    sx = (0.5 + offs)[:, None] * dx + 0.5 * grid.qx[None, :] * dx   # (3, nq)
    sy = (0.5 + offs)[:, None] * dx + 0.5 * grid.qy[None, :] * dx
    k = real_kernel_np(
        m,
        sx[:, None, None, :],      # (3,1,1,nq) source x
        sy[None, :, None, :],      # (1,3,1,nq) source y
        tx[None, None, :, None],   # target x
        ty[None, None, :, None],
    )                              # (3,3,nq,nq) [di,dj,kt,ks]
    return k * (grid.w2d[None, None, None, :] * 0.25 * dx * dx)


def build_refined_addon(grid: Grid, m: int) -> np.ndarray:
    """(3,3,nq,nq): refined-quadrature neighbour blocks (self block zero).

    [off][kt,ks] = sum_r real_m(refined_src_r, tgt_kt) sqrt(rw_r)
                    * nearMapping[r,ks] * sqrt(w2d_ks) * dx^2/4
    (reference refineAddOnCache/Fast, KernelFactory.cpp:550-609/:662-709).
    """
    nq, dx = grid.nq, grid.dx
    offs = np.array([-1, 0, 1])
    tx = 0.5 * dx + 0.5 * grid.qx * dx
    ty = 0.5 * dx + 0.5 * grid.qy * dx
    rx = (0.5 + offs)[:, None] * dx + 0.5 * grid.refine_x[None, :] * dx  # (3,R)
    ry = (0.5 + offs)[:, None] * dx + 0.5 * grid.refine_y[None, :] * dx
    k = real_kernel_np(
        m,
        rx[:, None, None, :],
        ry[None, :, None, :],
        tx[None, None, :, None],
        ty[None, None, :, None],
    )                              # (3,3,nq,R) [di,dj,kt,r]
    k = k * np.sqrt(grid.refine_w)[None, None, None, :]
    # contract refined dim against nearMapping -> (3,3,nq,nq)
    out = np.einsum("abtr,rs->abts", k, grid.near_mapping)
    out = out * (grid.sqrt_w2d[None, None, None, :] * 0.25 * dx * dx)
    out[1, 1] = 0.0                # self square handled by Duffy
    return out


def build_duffy_matrix(
    grid: Grid, m: int, sing_rule: int, compat_global_basis: bool = False
):
    """Self-square singular block(s) acting on raw charge.

    Local (default) mode: returns (nq, nq), identical for every square.
    Compat mode: returns (sz, sz, nq, nq) because the reference evaluates the
    Legendre basis at global coordinates (KernelFactory.cpp:848-851).

    [kt, ks] = sum_q real_m(duffy_q(kt), tgt_kt) * W_q * dx^2/4
               * sum_nm Pt_nm(eval coords of q) * proj[nm, ks]
    """
    nq, dx, deg = grid.nq, grid.dx, grid.deg
    X, Y, W = duffy_tables(deg, sing_rule, grid.qx, grid.qy)   # (nq, Q) local
    tx = 0.5 * dx + 0.5 * grid.qx * dx
    ty = 0.5 * dx + 0.5 * grid.qy * dx
    gx = 0.5 * dx + 0.5 * X * dx       # global coords in square (0,0)
    gy = 0.5 * dx + 0.5 * Y * dx
    kern = real_kernel_np(m, gx, gy, tx[:, None], ty[:, None])  # (nq, Q)
    kw = kern * W * (0.25 * dx * dx)

    if not compat_global_basis:
        basis = basis2d_np(deg, X, Y) / grid.norms[:, None, None]  # (nq_b, nq, Q)
        # sum_q kw[kt, q] * basis[nm, kt, q] -> (kt, nm), then @ proj
        bk = np.einsum("tq,btq->tb", kw, basis)
        return bk @ grid.proj                                     # (nq, nq)

    # compat: basis at global coords, per square (i, j)
    sz = grid.sz
    out = np.empty((sz, sz, nq, nq))
    for i in range(sz):
        gxi = (0.5 + i) * dx + 0.5 * X * dx
        bx = (
            basis2d_np(deg, gxi, np.zeros_like(gxi))
        )  # only x-part varies with i; cheaper to do full per (i,j) below
        for j in range(sz):
            gyj = (0.5 + j) * dx + 0.5 * Y * dx
            basis = basis2d_np(deg, gxi, gyj) / grid.norms[:, None, None]
            bk = np.einsum("tq,btq->tb", kw, basis)
            out[i, j] = bk @ grid.proj
    return out


def build_near_stencil(
    grid: Grid,
    m: int,
    sing_rule: int,
    compat_global_basis: bool = False,
    include_removal: bool = True,
):
    """Full near correction: returns (stencil(3,3,nq,nq), duffy_or_None).

    include_removal=True (dense backend): stencil = -coarse + refined + duffy,
    cancelling the coarse 3x3 contribution contained in the all-pairs sum
    (reference composition, main.cpp:100-113).

    include_removal=False (FMM backend): the fast path never *adds* the
    real-kernel 3x3 coarse near field (its U-list is omitted -- the
    reference adds it in the FMM and subtracts it in nearRemoval, an exact
    wash), so the stencil is refined + duffy only.

    In local mode the Duffy block is folded into stencil[1,1] and the second
    return is None.  In compat mode the stencil excludes Duffy and the
    (sz,sz,nq,nq) per-square Duffy stack is returned separately.
    """
    s = build_refined_addon(grid, m)
    if include_removal:
        s = s - build_coarse_removal(grid, m)
    if not compat_global_basis:
        s[1, 1] += build_duffy_matrix(grid, m, sing_rule, False)
        return s, None
    duffy = build_duffy_matrix(grid, m, sing_rule, True)
    return s, duffy
