"""SPMD domain decomposition over a mesh of GPUs.

The reference's only parallelism is shared-memory OpenMP loops
(KernelFactory.cpp:214-216 etc., SURVEY.md section 2).  The counterpart
here is spatial domain decomposition of the (sz, sz, nq) grid of squares
over a 2D jax.sharding.Mesh (square as possible: the cards of one host
are joined all to all over NVLink, so the mesh follows the domain
decomposition rather than a physical torus):

  * fields and per-square caches are sharded P("x", "y", None);
  * the 3x3 near-field stencil (a conv) gets its one-square halo exchange
    inserted by XLA GSPMD (NCCL collective-permutes over NVLink);
  * FMM level arrays stay sharded while boxes-per-axis >= mesh-axis size
    and are replicated at the (tiny) coarse levels;
  * GMRES dot products / norms on sharded operands become psums.

Everything is driven through jit + NamedSharding (GSPMD) rather than a
hand-rolled NCCL schedule: XLA chooses and schedules the collectives.
The shard_map variants (parallel.halo) are an optimization layer on top,
not a correctness requirement.
"""

from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """A 2D ("x", "y") mesh as square as possible over the given devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    a = int(math.isqrt(n))
    while n % a:
        a -= 1
    return Mesh(np.array(devices).reshape(a, n // a), ("x", "y"))


def field_spec() -> P:
    return P("x", "y")


def shard_field(mesh: Mesh, arr) -> jax.Array:
    """Place an (sz, sz, ...) per-square array sharded over the mesh."""
    return jax.device_put(arr, NamedSharding(mesh, P("x", "y")))


def replicate(mesh: Mesh, arr) -> jax.Array:
    return jax.device_put(arr, NamedSharding(mesh, P()))


def _divisible(shape, mesh: Mesh, d0: int, d1: int) -> bool:
    return (
        len(shape) > d1
        and shape[d0] % mesh.shape["x"] == 0
        and shape[d1] % mesh.shape["y"] == 0
        and shape[d0] >= mesh.shape["x"]
        and shape[d1] >= mesh.shape["y"]
    )


def shard_pytree(mesh: Mesh, tree):
    """Place a solver cache / mode-static pytree: per-square / per-box
    arrays sharded over their spatial dims where divisible, small static
    operators replicated.  The spatial dims sit at different positions per
    tensor family (fmm.smooth):

      m2l_E levels  (4, m2, m2, P)            -> spatial dims 1, 2
      fine per-class blocks (m2, m2, r, 27r)  -> spatial dims 0, 1
      near_E        (3, 3, nq, nq, sz, sz)    -> spatial dims 4, 5
      duffy         (nq, nq, sz, sz)          -> spatial dims 2, 3
      fields etc.   (sz, sz, ...)             -> spatial dims 0, 1
    """

    def place(path, x):
        x = jnp.asarray(x)
        # structural dispatch on exact pytree keys (not path-substring
        # matching): the ROOT dict key names
        # the tensor family, the LEAF key distinguishes the factored-level
        # members ('patch' sharded, 'W' replicated)
        keys = tuple(str(getattr(p, "key", p)) for p in path)
        root = keys[0] if keys else ""
        leaf = keys[-1] if keys else ""
        if root == "m2l_E":
            # per-class dense block of a fine level (TUPLE member, leaf
            # "[c]"): (m2, m2, r, 27r) -> spatial dims 0, 1
            # (fmm.smooth.build_m2l_E_fine)
            if leaf.startswith("["):
                if _divisible(x.shape, mesh, 0, 1):
                    spec = P("x", "y", *([None] * (x.ndim - 2)))
                    return jax.device_put(x, NamedSharding(mesh, spec))
                return replicate(mesh, x)
            # stacked dense level (4, m2, m2, P) or factored 'patch'
            # (4, m2, m2, Q) -- spatial dims 1, 2
            sharded_member = (
                x.ndim == 4 and leaf != "W" and not leaf.startswith("[")
            )
            if sharded_member and _divisible(x.shape, mesh, 1, 2):
                return jax.device_put(
                    x, NamedSharding(mesh, P(None, "x", "y"))
                )
            # 'W' factors (4, Q, P) and coarse levels too small to split
            return replicate(mesh, x)
        if root == "near_E":
            if x.ndim == 6 and _divisible(x.shape, mesh, 4, 5):
                return jax.device_put(
                    x,
                    NamedSharding(mesh, P(None, None, None, None, "x", "y")),
                )
            return replicate(mesh, x)
        if root == "duffy":
            if x.ndim == 4 and _divisible(x.shape, mesh, 2, 3):
                return jax.device_put(
                    x, NamedSharding(mesh, P(None, None, "x", "y"))
                )
            return replicate(mesh, x)
        if _divisible(x.shape, mesh, 0, 1):
            return shard_field(mesh, x)
        return replicate(mesh, x)

    return jax.tree_util.tree_map_with_path(place, tree)


# kept name for round-1 callers
shard_mode_data = shard_pytree


def sharded_solver(solver, mesh: Mesh, halo: str = "gspmd"):
    """Wrap a TransportSolver (fmm backend) for mesh execution.

    Returns (apply_fn, caches, mode_statics) where apply_fn(caches, ms, u)
    is the jitted corrected mode-m matvec (m = the python index of ms in
    mode_statics) with sharded in/out.

    halo='gspmd' (default, production): XLA GSPMD chooses and schedules
    every collective; the O(halo) traffic is gated by
    tests/test_collectives.py.  halo='shardmap': the near-field 3x3 halo
    AND the fine-level M2L parity-plane exchange run as explicit
    `ppermute`s inside shard_map (parallel.halo) -- the communication
    pattern is pinned independent of compiler heuristics, as the staging
    ground for compute/communication overlap across cards.  Levels or
    tensors the hand path cannot take (factored/virtual levels, coarse
    replicated levels, non-divisible shapes) fall back to GSPMD per
    level, so both modes are always correct.
    """
    from ..fmm.apply import fmm_apply_mode

    leaf = solver._tcfg.leaf_level
    static = {k: replicate(mesh, v) for k, v in solver._fmm_static.items()}
    caches = shard_pytree(mesh, solver._caches)
    mode_statics = [shard_pytree(mesh, ms) for ms in solver._mode_statics]
    fspec = NamedSharding(mesh, P("x", "y"))
    # transient-cap chunking applies per SHARD under the mesh: chunking a
    # sharded axis with dynamic_slice would make GSPMD all-gather the
    # operand (fmm.apply._row_chunk)
    n_shards = int(mesh.devices.size)

    import functools

    translate_fn = near_fn = None
    if halo == "shardmap":
        from .halo import (
            make_fine_translate_shardmap, make_near_apply_shardmap,
        )

        mx, my = mesh.shape["x"], mesh.shape["y"]
        fine_translate = make_fine_translate_shardmap(mesh)
        near_fns = [
            make_near_apply_shardmap(mesh, m, ms.get("duffy") is not None)
            for m, ms in enumerate(solver._mode_statics)
        ]

        def translate_fn(level, E_l, cosr_l, M_l, z):
            # hand path takes fine DENSE per-class levels whose box plane
            # divides the mesh; everything else falls back to GSPMD
            if not isinstance(E_l, tuple):
                return None             # factored / offsets forms
            m2 = E_l[0].shape[0]
            m = M_l.shape[0]
            if m % (2 * mx) or M_l.shape[1] % (2 * my) or m2 % mx:
                return None
            if E_l[0].ndim != 4 or E_l[0].shape[1] % my:
                return None
            return fine_translate(E_l, cosr_l, M_l, z)

        def near_fn(cch, ms, mode, u, z):
            if "near_E" not in cch:
                return None              # virtual near: GSPMD path
            sz = u.shape[0]
            if sz % mx or u.shape[1] % my:
                return None
            return near_fns[mode](
                cch["near_E"], ms["near_cosrw"], ms["near_static"],
                cch["sigma_w"], ms.get("duffy"), u, z,
            )
    elif halo != "gspmd":
        raise ValueError(f"unknown halo mode {halo!r}")

    @functools.partial(jax.jit, static_argnums=(2,))
    def apply_fn(cch, ms, mode, u):
        out = fmm_apply_mode(leaf, static, cch, ms, mode, u,
                             n_shards=n_shards, translate_fn=translate_fn,
                             near_fn=near_fn)
        return jax.lax.with_sharding_constraint(out, fspec)

    return apply_fn, caches, mode_statics
