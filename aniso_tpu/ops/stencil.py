"""Application of the 3x3 near-field stencil as a channelled convolution.

out[x, y, kt] = sum_{a, b, ks} stencil[a, b, kt, ks] * u[x-1+a, y-1+b, ks]

with zero boundary (squares outside the domain contribute nothing, matching
the reference's boundary guards, KernelFactory.cpp:462-463).  XLA compiles
this conv; it replaces the reference's three near-field passes and
their gigabyte caches.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def apply_near_stencil(stencil: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
    """stencil: (3, 3, nq, nq) [a, b, kt, ks]; u: (sz, sz, nq) -> (sz, sz, nq)."""
    inp = u.transpose(2, 0, 1)[None]                 # (1, nq, sz, sz)
    ker = stencil.transpose(2, 3, 0, 1)              # (kt, ks, 3, 3)
    out = lax.conv_general_dilated(
        inp,
        ker,
        window_strides=(1, 1),
        padding=((1, 1), (1, 1)),
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        preferred_element_type=u.dtype,
        precision=lax.Precision.HIGHEST,
    )
    return out[0].transpose(1, 2, 0)


def apply_per_square(mats: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
    """Per-square (sz, sz, nq, nq) block-diagonal application (compat Duffy)."""
    return jnp.einsum("ijts,ijs->ijt", mats, u,
                      precision=lax.Precision.HIGHEST)


def patches_3x3(u_pad: jnp.ndarray) -> jnp.ndarray:
    """(X+2, Y+2, q) pre-padded field -> (q, 3, 3, X, Y) neighbour windows,
    out[k, a, b, i, j] = u_pad[i + a, j + b, k]: nine static slices, exact
    data movement with no arithmetic (so no precision to pin)."""
    X, Y = u_pad.shape[0] - 2, u_pad.shape[1] - 2
    win = jnp.stack([
        jnp.stack([u_pad[a:a + X, b:b + Y] for b in range(3)])
        for a in range(3)
    ])                                               # (3, 3, X, Y, q)
    return jnp.moveaxis(win, -1, 0)
