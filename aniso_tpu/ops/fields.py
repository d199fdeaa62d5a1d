"""Per-square Legendre projection of nodal fields (jax).

Reference KernelFactory::interpolation (KernelFactory.cpp:212-227, :988-1005):
coeff_square = interpolate @ (sqrt(w2d) * values_square).  Here it is one
batched einsum over all squares at once.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.geometry import Grid


def project(grid: Grid, values: jnp.ndarray) -> jnp.ndarray:
    """Nodal values (sz, sz, deg^2) -> normalized-Legendre coeffs (sz, sz, deg^2)."""
    proj = jnp.asarray(grid.proj, dtype=values.dtype)
    return jnp.einsum("bq,ijq->ijb", proj, values,
                      precision=jax.lax.Precision.HIGHEST)


def evaluate_at_nodes_np(grid: Grid, coeffs) -> "np.ndarray":
    """Host (numpy) twin of evaluate_at_nodes for the *local* basis:
    sigma_hat at the grid's own nodes from local-basis coefficients.

    set_coeff runs the whole sigma pipeline on the host in f64; under the
    global-basis quirk callers pass the compat-transformed coefficients
    (ops.compat), which is equivalent.
    """
    import numpy as np
    from ..core.legendre import basis2d_np

    bt = basis2d_np(grid.deg, grid.qx, grid.qy) / grid.norms[:, None]
    return np.einsum("bq,ijb->ijq", bt, np.asarray(coeffs))


def evaluate_at_nodes(grid: Grid, coeffs: jnp.ndarray,
                      compat_global_basis: bool = False) -> jnp.ndarray:
    """sigma_hat at the grid's own nodes, (sz, sz, deg^2).

    Used for the m=0 smooth-kernel diagonal (reference `evaluate`,
    KernelFactory.cpp:193-207).
    """
    from .attenuation import make_sigma_eval

    ev = make_sigma_eval(grid, compat_global_basis)
    x = jnp.asarray(grid.nodes_x, dtype=coeffs.dtype)
    y = jnp.asarray(grid.nodes_y, dtype=coeffs.dtype)
    return ev(coeffs, x, y)
