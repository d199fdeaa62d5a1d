"""Diffusion synthetic acceleration (DSA) preconditioner.

Reference semantics (aniso.m:66-119): with FEM matrices
Diff = S(D) + M(sigma_a) + E/2 and Diff2 = S(D) + M(sigma_t) + E/2 (so
Diff2 - Diff = M(sigma_s)), the preconditioner applies
z = Diff^-1 Diff2 h = h + Diff^-1 M(sigma_s) h: the classic DSA form
"identity plus a diffusion solve of the scattering residual", with 2D
Eddington diffusion coefficient D = 0.5/sigma_t (aniso.m:77) and Marshak
(Robin) boundary z/2 + D dz/dn = 0 from the E/2 edge term (aniso.m:89-90).

Design (SURVEY.md section 7 stage 5): the reference builds this
with an external FEM library (femm, an absent submodule) on a separate
triangle mesh and a sparse direct solve.  Here the diffusion operator lives
on the solver's own sz x sz grid of squares, cell-centered finite-volume
with harmonic-mean face coefficients — a 5-point stencil, which XLA fuses
into elementwise+shift work — and the solve is device-resident
Jacobi-preconditioned CG inside `lax.while_loop`, so the whole
preconditioned GMRES iteration stays under one jit with no host round trips.
DSA only needs to capture the smooth diffusion-limit error modes, so the
cell-centered restriction (quadrature-weighted square averages) and
constant-per-square prolongation preserve its effectiveness.

Multi-mode note: the diffusion limit approximates the angular *mean*; the
preconditioner corrects Fourier mode 0 and passes higher modes through
(the reference's prec indexes a single RTE field, aniso.m:111-119, i.e. is
only ever applied with N = 1).

Discretization awareness.  The diffusion
operator is continuum-consistent; on cells more than ~1.5 mean free
paths thick the discrete transport operator departs from its continuum
diffusion limit and the raw correction actively HURTS (measured 43->67
iterations at 8^2, sigma_t*dx = 2.5).  The guard is a cell-local damping
of the correction by the cell optical depth tau = sigma_t*dx:

    theta(tau) = 0                         for tau >= 1.6
               = 1 / (1 + e^{(tau-1.45)/0.07})  below

so thick cells degrade the preconditioner toward the identity (which
cannot hurt GMRES) while resolved cells keep the full DSA win.  The
cutoff was calibrated against the dense-backend oracle across
tau in {0.63 .. 2.52} at sigma_s = 20 (benchmarks/results_dsa.json and
tests/test_dsa.py): iterations(DSA) <= iterations(none) at EVERY tau,
with the resolved-regime wins intact (24->19 at tau 1.26, 22->13 at
0.84, 24->13 at 0.63).  The reference's FEM DSA (aniso.m:111-119) has
no such guard -- it inherits femm's discretization and the same
consistency caveat.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


def cell_average(grid, nodal: jnp.ndarray) -> jnp.ndarray:
    """Quadrature-weighted square means: (sz, sz, nq) -> (sz, sz)."""
    w = jnp.asarray(grid.w2d, dtype=nodal.dtype)
    return (nodal * w).sum(-1) / w.sum()


def _face_coeffs(D: jnp.ndarray, dx: float):
    """Harmonic-mean interior face coefficients + Robin boundary factors.

    Returns (Dx, Dy, robin) where Dx[i, j] couples cells (i, j) and
    (i+1, j), Dy couples (i, j)-(i, j+1), and robin[b] multiplies the cell
    value to give the Marshak outward flux z * 2D/(dx + 4D) per unit length.
    """
    Dx = 2.0 * D[:-1, :] * D[1:, :] / (D[:-1, :] + D[1:, :])
    Dy = 2.0 * D[:, :-1] * D[:, 1:] / (D[:, :-1] + D[:, 1:])
    robin = 2.0 * D / (dx + 4.0 * D)
    return Dx, Dy, robin


def make_diffusion_apply(D: jnp.ndarray, sigma_a: jnp.ndarray, dx: float):
    """A z = sigma_a z - div(D grad z), Robin z/2 + D dz/dn = 0, as a
    jittable 5-point stencil on (sz, sz) cell values."""
    Dx, Dy, robin = _face_coeffs(D, dx)
    inv_dx2 = 1.0 / (dx * dx)
    inv_dx = 1.0 / dx

    def apply(z: jnp.ndarray) -> jnp.ndarray:
        out = sigma_a * z
        # interior face fluxes (finite volume, divided by cell area)
        fx = Dx * (z[:-1, :] - z[1:, :]) * inv_dx2   # flux from i -> i+1
        out = out.at[:-1, :].add(fx)
        out = out.at[1:, :].add(-fx)
        fy = Dy * (z[:, :-1] - z[:, 1:]) * inv_dx2
        out = out.at[:, :-1].add(fy)
        out = out.at[:, 1:].add(-fy)
        # Marshak boundary outflux on the four sides
        out = out.at[0, :].add(robin[0, :] * z[0, :] * inv_dx)
        out = out.at[-1, :].add(robin[-1, :] * z[-1, :] * inv_dx)
        out = out.at[:, 0].add(robin[:, 0] * z[:, 0] * inv_dx)
        out = out.at[:, -1].add(robin[:, -1] * z[:, -1] * inv_dx)
        return out

    # Jacobi diagonal for preconditioning the CG
    diag = sigma_a + jnp.zeros_like(D)
    diag = diag.at[:-1, :].add(Dx * inv_dx2)
    diag = diag.at[1:, :].add(Dx * inv_dx2)
    diag = diag.at[:, :-1].add(Dy * inv_dx2)
    diag = diag.at[:, 1:].add(Dy * inv_dx2)
    diag = diag.at[0, :].add(robin[0, :] * inv_dx)
    diag = diag.at[-1, :].add(robin[-1, :] * inv_dx)
    diag = diag.at[:, 0].add(robin[:, 0] * inv_dx)
    diag = diag.at[:, -1].add(robin[:, -1] * inv_dx)
    return apply, diag


def pcg(apply, diag, b, *, tol: float = 1e-8, max_iter: int = 500):
    """Jacobi-preconditioned CG, device-resident (`lax.while_loop`)."""
    inv_diag = 1.0 / diag
    bnorm2 = jnp.sum(b * b)
    bnorm2 = jnp.where(bnorm2 == 0.0, 1.0, bnorm2)

    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = inv_diag * r0
    p0 = z0
    rz0 = jnp.sum(r0 * z0)

    def cond(st):
        k, _, r, _, _ = st
        return (k < max_iter) & (jnp.sum(r * r) > tol * tol * bnorm2)

    def body(st):
        k, x, r, p, rz = st
        ap = apply(p)
        alpha = rz / jnp.sum(p * ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = inv_diag * r
        rz_new = jnp.sum(r * z)
        p = z + (rz_new / rz) * p
        return (k + 1, x, r, p, rz_new)

    _, x, _, _, _ = lax.while_loop(cond, body, (0, x0, r0, p0, rz0))
    return x


class DsaPreconditioner:
    """Callable left preconditioner for TransportSolver.solve.

    h (N, sz, sz, nq) -> h with mode 0 replaced by h0 + prolong(z),
    where  (sigma_a - div D grad) z = sigma_s_bar * mean(h0).
    """

    def __init__(self, solver, *, tol: float = 1e-8, max_iter: int = 500,
                 damping: bool = True):
        grid = solver.grid
        if solver.sigma_s is None:
            raise RuntimeError("call set_coeff before building DSA")
        self.grid = grid
        sigma_s_bar = cell_average(grid, solver.sigma_s)
        sigma_t_bar = cell_average(grid, solver.sigma_t)
        sigma_a_bar = jnp.maximum(sigma_t_bar - sigma_s_bar, 1e-12)
        D = 0.5 / sigma_t_bar          # 2D Eddington (aniso.m:77)
        self.sigma_s_bar = sigma_s_bar
        self.apply_diff, self.diag = make_diffusion_apply(
            D, sigma_a_bar, grid.dx
        )
        # cell-local thick-cell damping theta(tau) (module docstring);
        # damping=False retains the raw continuum DSA for A/B studies
        if damping:
            tau = grid.dx * sigma_t_bar
            arg = jnp.clip((tau - 1.45) / 0.07, -50.0, 50.0)
            theta = 1.0 / (1.0 + jnp.exp(arg))
            self.theta = jnp.where(tau >= 1.6, 0.0, theta)
        else:
            self.theta = jnp.ones_like(sigma_t_bar)
        self.tol = tol
        self.max_iter = max_iter

    def __call__(self, h: jnp.ndarray) -> jnp.ndarray:
        grid = self.grid
        shape = h.shape
        multi = h.ndim == 4
        h0 = h[0] if multi else h
        hbar = cell_average(grid, h0)
        z = pcg(
            self.apply_diff, self.diag, self.sigma_s_bar * hbar,
            tol=self.tol, max_iter=self.max_iter,
        )
        h0_new = h0 + (self.theta * z)[:, :, None]
        if multi:
            return h.at[0].set(h0_new).reshape(shape)
        return h0_new.reshape(shape)
