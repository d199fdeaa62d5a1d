"""Legendre polynomial evaluation and the normalized 2D tensor basis.

Replaces the reference's use of `std::tr1::legendre` plus per-point scalar
loops (reference Geometry.cpp:129-154, KernelFactory.cpp:174-207) with
vectorized recurrences that XLA fuses into elementwise work.

The 2D basis on a square is B_{nk}(x, y) = P_n(x) P_k(y) with the flat index
nm = n * deg + k.  The "normalized" basis divides by the quadrature-measured
norm (reference Geometry.cpp:140-153); with an exact Gauss rule the norm is
analytically 2 / sqrt((2n+1)(2k+1)), and we compute it from the quadrature to
match reference semantics bit-for-bit at float64.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def legendre_all_np(deg: int, x: np.ndarray) -> np.ndarray:
    """P_0..P_{deg-1} at x (numpy, float64). Returns shape (deg,) + x.shape."""
    x = np.asarray(x, dtype=np.float64)
    out = np.empty((deg,) + x.shape, dtype=np.float64)
    out[0] = 1.0
    if deg > 1:
        out[1] = x
    for n in range(2, deg):
        out[n] = ((2 * n - 1) * x * out[n - 1] - (n - 1) * out[n - 2]) / n
    return out


def legendre_all(deg: int, x: jnp.ndarray) -> jnp.ndarray:
    """P_0..P_{deg-1} at x (jax). Returns shape (deg,) + x.shape.

    deg is static and small so the recurrence unrolls into a short chain of
    fused multiply-adds under jit.
    """
    outs = [jnp.ones_like(x)]
    if deg > 1:
        outs.append(x)
    for n in range(2, deg):
        outs.append(((2 * n - 1) * x * outs[n - 1] - (n - 1) * outs[n - 2]) / n)
    return jnp.stack(outs)


def basis2d(deg: int, x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Unnormalized 2D tensor basis, shape (deg*deg,) + broadcast(x, y).shape.

    Flat ordering nm = n * deg + k with P_n along x, P_k along y
    (reference Geometry.cpp:131-137).
    """
    px = legendre_all(deg, x)  # (deg, ...)
    py = legendre_all(deg, y)
    b = px[:, None] * py[None, :]  # (deg, deg, ...)
    return b.reshape((deg * deg,) + b.shape[2:])


def basis2d_np(deg: int, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    px = legendre_all_np(deg, np.asarray(x))
    py = legendre_all_np(deg, np.asarray(y))
    b = px[:, None] * py[None, :]
    return b.reshape((deg * deg,) + b.shape[2:])


def basis_norms_np(deg: int, qx: np.ndarray, qy: np.ndarray, w2d: np.ndarray) -> np.ndarray:
    """Quadrature-measured norms of the 2D basis rows.

    Matches reference Geometry.cpp:140-147: norm_nm = sqrt(sum_I B_nm(I)^2 w_I).
    Analytically equal to 2/sqrt((2n+1)(2k+1)) for an exact rule.
    """
    b = basis2d_np(deg, qx, qy)  # (deg^2, nq)
    return np.sqrt(np.sum(b * b * w2d[None, :], axis=1))
