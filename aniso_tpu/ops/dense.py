"""Dense (all-pairs) operator assembly -- the exact reference path.

This is the validation backbone (SURVEY.md section 7 stage 3): the FMM and
distributed paths are accelerations of exactly this operator.  The corrected
mode-m matvec is

  K_m u = (1/2pi) [ smooth_m all-pairs (w u)
                  + real_m  all-pairs (w u)
                  + NearStencil_m u ]

where NearStencil = -coarse(3x3) + refined(8) + duffy(self) (see ops.near).
The coarse 3x3 part of the all-pairs real sum cancels against the stencil's
removal term exactly as in the reference composition (main.cpp:78-119).

Matrices are assembled in row-chunks with vmapped kernel evaluation; the
smooth matrix embeds the attenuation E per pair (the expensive part, done
once per sigma_t like the reference's cache passes).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.geometry import Grid
from .attenuation import make_line_integral, make_sigma_eval
from .kernels import real_kernel, smooth_kernel_from_E


def build_dense_real(grid: Grid, m: int, dtype=jnp.float64) -> jnp.ndarray:
    """(n, n) matrix K[t, s] = real_m(s, t) * w_glob[s]  (geometry-only)."""
    pts = grid.flat_nodes()
    w = grid.weights.reshape(-1)
    ax = jnp.asarray(pts[:, 0], dtype=dtype)
    ay = jnp.asarray(pts[:, 1], dtype=dtype)
    k = real_kernel(m, ax[None, :], ay[None, :], ax[:, None], ay[:, None])
    return k * jnp.asarray(w, dtype=dtype)[None, :]


def build_dense_smooth(
    grid: Grid,
    m: int,
    coeffs: jnp.ndarray,
    compat_global_basis: bool = False,
    chunk: int = 256,
    dtype=jnp.float64,
    use_native: bool | None = None,
) -> jnp.ndarray:
    """(n, n) matrix K[t, s] = smooth_m(s, t) * w_glob[s].

    coeffs: sigma_t Legendre coefficients (sz, sz, deg^2).  The diagonal for
    m = 0 is sigma_hat(node) (reference KernelFactory.cpp:260).

    use_native: assemble on host with the OpenMP C++ engine
    (csrc/aniso_host.cpp) instead of vmapped JAX -- same quadrature, float64;
    default auto-detects.  The all-pairs E assembly is host-side precompute
    (the reference's cache-pass role), not device work.
    """
    if use_native is None:
        from .. import native
        use_native = native.available()
    if use_native:
        from .. import native
        rows = []
        n = grid.n_nodes
        row_chunk = max(chunk, 1024)
        for start in range(0, n, row_chunk):
            nrows = min(row_chunk, n - start)
            rows.append(native.smooth_rows(
                grid, np.asarray(coeffs, np.float64), m, start, nrows,
                compat_global_basis,
            ))
        return jnp.asarray(np.vstack(rows), dtype=dtype)

    pts = grid.flat_nodes()
    n = pts.shape[0]
    w = jnp.asarray(grid.weights.reshape(-1), dtype=dtype)
    ax = jnp.asarray(pts[:, 0], dtype=dtype)
    ay = jnp.asarray(pts[:, 1], dtype=dtype)
    # chop long segments into pieces so the compiled body stays small
    # (compile time scales with the static per-piece crossing bound)
    if grid.sz <= 8:
        li = make_line_integral(grid, grid.sz, compat_global_basis)
    else:
        n_pieces = -(-grid.sz // 6)
        li = make_line_integral(grid, 8, compat_global_basis, n_pieces=n_pieces)
    sig = make_sigma_eval(grid, compat_global_basis)
    diag_sigma = sig(coeffs, ax, ay) if m == 0 else None

    # E(t_row, s_col) for a block of rows at a time
    pair_E = jax.vmap(jax.vmap(li, in_axes=(None, None, None, 0, 0)),
                      in_axes=(None, 0, 0, None, None))

    @jax.jit
    def block(bx, by, bdiag):
        E = pair_E(coeffs, bx, by, ax, ay)           # (chunk, n)
        ds = bdiag[:, None] if m == 0 else None
        k = smooth_kernel_from_E(
            m, ax[None, :], ay[None, :], bx[:, None], by[:, None], E,
            diag_sigma=ds,
        )
        return k * w[None, :]

    rows = []
    for start in range(0, n, chunk):
        end = min(start + chunk, n)
        bd = diag_sigma[start:end] if m == 0 else jnp.zeros(end - start, dtype)
        rows.append(block(ax[start:end], ay[start:end], bd))
    return jnp.concatenate(rows, axis=0)


def build_dense_E(
    grid: Grid,
    coeffs: jnp.ndarray,
    dtype=jnp.float64,
    use_native: bool | None = None,
) -> np.ndarray:
    """All-pairs attenuation matrix E[t, s] (float64 numpy), computed ONCE.

    This is the mode-independent part of the smooth kernel; computing it
    once and applying per-mode factors elementwise removes the per-mode
    line-integral recomputation (the reference
    re-evaluates lineIntegral per kernel id, KernelFactory.cpp:240-267).
    """
    if use_native is None:
        from .. import native
        use_native = native.available()
    pts = grid.flat_nodes()
    n = pts.shape[0]
    if use_native:
        from .. import native
        coeffs_np = np.asarray(coeffs, np.float64)
        out = np.empty((n, n))
        chunk = max(1, (1 << 22) // n)
        for start in range(0, n, chunk):
            end = min(start + chunk, n)
            tgt = np.repeat(pts[start:end], n, axis=0)
            src = np.tile(pts, (end - start, 1))
            out[start:end] = native.attenuation_batch(
                grid, coeffs_np, src, tgt
            ).reshape(end - start, n)
        return out

    ax = jnp.asarray(pts[:, 0], dtype=dtype)
    ay = jnp.asarray(pts[:, 1], dtype=dtype)
    if grid.sz <= 8:
        li = make_line_integral(grid, grid.sz)
    else:
        li = make_line_integral(grid, 8, n_pieces=-(-grid.sz // 6))
    pair_E = jax.jit(
        jax.vmap(jax.vmap(li, in_axes=(None, None, None, 0, 0)),
                 in_axes=(None, 0, 0, None, None))
    )
    rows = []
    chunk = 256
    c = coeffs.astype(dtype)
    for start in range(0, n, chunk):
        end = min(start + chunk, n)
        rows.append(np.asarray(pair_E(c, ax[start:end], ay[start:end], ax, ay)))
    return np.vstack(rows).astype(np.float64)


def build_dense_smooth_all(
    grid: Grid,
    modes,
    coeffs: jnp.ndarray,
    sigma_nodes: jnp.ndarray,
    dtype=jnp.float64,
    use_native: bool | None = None,
) -> list:
    """Per-mode (n, n) smooth matrices K_m[t, s] = smooth_m(s, t) * w[s],
    sharing one all-pairs E (mode-independent).

    coeffs must already be in local-basis form (callers pass the
    compat-transformed coefficients under the global-basis quirk);
    sigma_nodes supplies the m = 0 diagonal (KernelFactory.cpp:260).
    """
    E = build_dense_E(grid, coeffs, dtype=dtype, use_native=use_native)
    pts = grid.flat_nodes()
    w = grid.weights.reshape(-1)
    d = pts[None, :, :] - pts[:, None, :]          # src - tgt, (n, n, 2)
    r = np.hypot(d[..., 0], d[..., 1])
    ang = np.arctan2(d[..., 1], d[..., 0])
    safe = np.where(r == 0.0, 1.0, r)
    base = np.expm1(-E) / safe
    sig = np.asarray(sigma_nodes, np.float64).reshape(-1)
    out = []
    for m in modes:
        k = base * np.cos(m * ang)
        if m == 0:
            np.fill_diagonal(k, sig)
        else:
            k[r == 0.0] = 0.0
        out.append(jnp.asarray(k * w[None, :], dtype=dtype))
    return out


def dense_apply(k_smooth, k_real, stencil, duffy, grid: Grid, u: jnp.ndarray):
    """Full corrected mode matvec on (sz, sz, nq) charge -> (sz, sz, nq).

    Mirrors main.cpp:78-119 / AnisoWrapper.cpp:92-136 composition.
    """
    from .stencil import apply_near_stencil, apply_per_square

    sz, nq = grid.sz, grid.nq
    # the dense matrices already include the source quadrature weight
    # (build_dense_*: k * w[None, :]), so they act on the *raw* charge --
    # equivalent to the reference applying the unweighted kernel to
    # scaledFunction = charge .* weights (main.cpp:86-89)
    uf = u.reshape(-1)
    prec = jax.lax.Precision.HIGHEST
    out = (
        jnp.einsum("ts,s->t", k_smooth, uf, precision=prec)
        + jnp.einsum("ts,s->t", k_real, uf, precision=prec)
    ).reshape(sz, sz, nq)
    out = out + apply_near_stencil(stencil, u)
    if duffy is not None:
        out = out + apply_per_square(duffy, u)
    return out / (2.0 * jnp.pi)
