"""Explicit shard_map + ppermute halo exchange for the near field.

The GSPMD path (parallel.api) already lowers the 3x3 near-field stencil to
collective-permute halos chosen by XLA (gated by tests/test_collectives).
This module is the hand-scheduled variant from SURVEY section 7 stage 6:
the one-square boundary ring is exchanged explicitly with
`jax.lax.ppermute` inside `shard_map`, which (a) pins the communication
pattern independent of compiler heuristics, and (b) is the substrate for
overlapping the exchange with interior compute across cards.

The reference's analogue is simply OpenMP threads sharing one address
space (KernelFactory.cpp:446-448): the halo IS the new work.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.stencil import patches_3x3

try:  # jax >= 0.8
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map


def halo_exchange_1(u: jnp.ndarray, axis_name: str, size: int, dim: int):
    """Extend the local block by one slab on each side along `dim`, filled
    from the +-1 neighbours on mesh axis `axis_name` (zeros at the global
    boundary -- identical to the zero padding of the global 3x3 stencil).
    """
    lo_slab = lax.slice_in_dim(u, u.shape[dim] - 1, u.shape[dim], axis=dim)
    hi_slab = lax.slice_in_dim(u, 0, 1, axis=dim)
    fwd = [(i, i + 1) for i in range(size - 1)]
    bwd = [(i + 1, i) for i in range(size - 1)]
    # devices with no source in the permutation receive zeros
    from_prev = lax.ppermute(lo_slab, axis_name, fwd)
    from_next = lax.ppermute(hi_slab, axis_name, bwd)
    return jnp.concatenate([from_prev, u, from_next], axis=dim)


def make_near_apply_shardmap(mesh: Mesh, mode: int, has_duffy: bool):
    """Build the shard_map near-field matvec for one mode.

    Returns f(near_E, near_cosrw, near_static, sigma_w, duffy_or_None, u, z)
    with the same semantics as fmm.apply._near_apply, inputs sharded as by
    parallel.api.shard_pytree and u sharded P("x", "y").  z is the
    loop-variant zero anchor (fmm.apply._loop_variant_zero): shard_map
    bodies inline into the surrounding jitted program, so without it LICM
    would hoist expm1(-near_E) out of a GMRES while-loop and materialize a
    second full-size copy of the cache.
    """
    mx, my = mesh.shape["x"], mesh.shape["y"]
    HP = lax.Precision.HIGHEST

    def local(near_E, ncos, nstat, sigma_w, duffy, u, z):
        ue = halo_exchange_1(u, "x", mx, 0)
        ue = halo_exchange_1(ue, "y", my, 1)
        block = (
            jnp.expm1(-(near_E + z)) * ncos[..., None, None]
            + nstat[..., None, None]
        )
        out = jnp.einsum(
            "abtsij,sabij->ijt", block, patches_3x3(ue), precision=HP
        )
        if mode == 0:
            out = out + sigma_w * u
        if duffy is not None:
            out = out + jnp.einsum("tsij,ijs->ijt", duffy, u, precision=HP)
        return out

    duffy_spec = P(None, None, "x", "y") if has_duffy else None
    f = shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(None, None, None, None, "x", "y"),   # near_E
            P(), P(),                              # cosrw, static stencil
            P("x", "y"),                           # sigma_w
            duffy_spec,                            # duffy (or None)
            P("x", "y"),                           # u
            P(),                                   # loop-variant zero
        ),
        out_specs=P("x", "y"),
    )
    if not has_duffy:
        return lambda nE, nc, ns, sw, _d, u, z=0.0: f(nE, nc, ns, sw, None,
                                                      u, z)
    return f


def make_fine_translate_shardmap(mesh: Mesh):
    """Hand-scheduled M2L at one fine DENSE level: the parity-plane V-list
    halo exchange as explicit `ppermute`s inside shard_map, then the same
    fused exp(-E) * cos/r multiply-reduce as fmm.apply._m2l_translate on
    the local blocks.

    This pins the M2L communication pattern (4 parity planes x 2 axes x 2
    directions of one-box slabs -- the designed O(halo) traffic) completely
    independent of GSPMD heuristics, and is the staging ground for
    overlapping the exchange with interior compute across cards (issue the
    ppermutes, translate the interior boxes, then the halo-dependent ring).

    Returns f(E4_tuple, cosr_l, M_l, z) -> T (m, m, r) sharded P("x","y"):
      E4_tuple: 4 per-class dense (m2, m2, r, 27r) blocks sharded
        P("x", "y", None, None) (fmm.smooth.build_m2l_E_fine);
      cosr_l: (4, r*27*r) replicated; M_l: (m, m, r) sharded P("x","y").

    The local interleave of the 4 class blocks reproduces exactly the
    local shard of the global interleave: global T[2X+px, 2Y+py] =
    out_c[X, Y] and both sides block-partition contiguously.
    """
    from ..fmm.apply import parity_shift_table_np

    mx, my = mesh.shape["x"], mesh.shape["y"]
    HP = lax.Precision.HIGHEST
    tab = parity_shift_table_np()

    def local(E4s, cosr, Ml, z):
        lmx, lmy, r = Ml.shape
        l2x, l2y = lmx // 2, lmy // 2
        ob = cosr.shape[-1] // r             # 27r
        P4 = Ml.reshape(l2x, 2, l2y, 2, r)
        shifted = [[None] * 2 for _ in range(2)]
        for gx in (0, 1):
            for gy in (0, 1):
                ext = halo_exchange_1(P4[:, gx, :, gy], "x", mx, 0)
                ext = halo_exchange_1(ext, "y", my, 1)
                shifted[gx][gy] = [
                    [ext[a : a + l2x, b : b + l2y] for b in range(3)]
                    for a in range(3)
                ]
        outs = []
        for c in range(4):
            gsel = jnp.stack(
                [
                    shifted[tab[c, o, 0]][tab[c, o, 1]][tab[c, o, 2]][
                        tab[c, o, 3]
                    ]
                    for o in range(27)
                ],
                axis=2,
            ).reshape(l2x, l2y, 27 * r)
            op = jnp.exp(-(E4s[c] + z)) * cosr[c].reshape(r, ob) \
                * gsel[:, :, None, :]
            outs.append(jnp.sum(op, axis=-1))
        return (
            jnp.stack(outs)
            .reshape(2, 2, l2x, l2y, r)
            .transpose(2, 0, 3, 1, 4)
            .reshape(2 * l2x, 2 * l2y, r)
        )

    E_spec = P("x", "y", None, None)
    return shard_map(
        local,
        mesh=mesh,
        in_specs=((E_spec,) * 4, P(), P("x", "y", None), P()),
        out_specs=P("x", "y", None),
    )
