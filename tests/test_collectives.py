"""Collective-traffic gates for the SPMD matvec.

The domain-decomposed corrected matvec must scale by exchanging halos,
not by gathering the volume: GSPMD should lower the 3x3 near-field conv
and the parity-plane M2L gathers to `collective-permute` of O(halo)
bytes over the mesh, with no `all-gather` of field-sized operands.
These tests compile the real sharded program on the virtual device mesh
and assert on the HLO it actually emits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aniso_tpu import SolverConfig
from aniso_tpu.solver.operator import TransportSolver
from aniso_tpu.parallel.api import make_mesh, shard_field, sharded_solver
from aniso_tpu.parallel.inspect import collective_stats, compiled_collective_stats


def test_collective_stats_parser():
    hlo = """
  %ag = f32[8,16]{1,0} all-gather(f32[1,16]{1,0} %p), replica_groups={}
  %cp = f32[2,16]{1,0} collective-permute(f32[2,16]{1,0} %q)
  %cp2 = f32[2,16]{1,0} collective-permute-start(f32[2,16]{1,0} %q)
  %cp3 = f32[2,16]{1,0} collective-permute-done(f32[2,16]{1,0} %cp2)
  %ar = f32[] all-reduce(f32[] %r), to_apply=%sum
"""
    st = collective_stats(hlo)
    assert st.counts == {"all-gather": 1, "collective-permute": 2,
                         "all-reduce": 1}
    assert st.bytes["all-gather"] == 8 * 16 * 4
    assert st.bytes["collective-permute"] == 2 * (2 * 16 * 4)


@pytest.fixture(scope="module")
def sharded_matvec():
    import aniso_tpu.fmm.smooth as smooth

    cfg = SolverConfig(
        domain_size=32, quad_rule=2, kernel_size=1, g=0.9,
        sing_rule=4, np_cheb=3, dtype="float32",
    )
    s = TransportSolver(cfg, backend="fmm")
    g = s.grid
    sig = 8 * 0.5 * (1 - np.cos(2 * np.pi * g.nodes_x))
    # sharded build: evicted levels take the factored form (the
    # per-offset form would re-gather the field and break the O(halo)
    # gates)
    saved = smooth._UNSHARDED_BUILD
    smooth._UNSHARDED_BUILD = False
    try:
        s.set_coeff(sig, sig + 0.2)
    finally:
        smooth._UNSHARDED_BUILD = saved
    mesh = make_mesh()
    apply_fn, caches, mode_statics = sharded_solver(s, mesh)
    u = shard_field(mesh, jnp.asarray(np.random.default_rng(0).random((32, 32, 4)), jnp.float32))
    compiled = apply_fn.lower(caches, mode_statics[0], 0, u).compile()
    return s, mesh, compiled


def test_sharded_matvec_moves_halo_not_volume(sharded_matvec):
    s, mesh, compiled = sharded_matvec
    if mesh.devices.size < 2:
        pytest.skip("needs a multi-device mesh")
    st = compiled_collective_stats(compiled)
    field_bytes = s.grid.n_nodes * 4
    # no volume all-gather: every spatial exchange must be a permute.
    # (scalar control traffic -- the loop-variance anchor broadcast,
    # fmm.apply._loop_variant_zero -- is allowed up to 16 KB)
    assert st.bytes.get("all-gather", 0) <= 16 * 1024, st
    assert st.counts.get("collective-permute", 0) > 0, st
    # O(halo) gate: total permuted bytes well under one volume per device
    # (a volume-moving design would transfer >= n_dev * field_bytes;
    # measured on 8 virtual devices: ~55 KB vs 32^2*4*4 = 16 KB field,
    # i.e. ~3.4 fields summed across the whole FMM hierarchy + caches)
    n_dev = mesh.devices.size
    assert st.total_bytes() < n_dev * field_bytes, (
        st, n_dev * field_bytes,
    )


@pytest.fixture(scope="module")
def factored_solver():
    """A solver whose FINE levels are all forced to the factored
    representation (the 512^2/1024^2 regime), via the same dense-cap
    override the driver dry run uses (__graft_entry__.py)."""
    import aniso_tpu.fmm.smooth as smooth

    cfg = SolverConfig(
        domain_size=32, quad_rule=2, kernel_size=1, g=0.9,
        sing_rule=4, np_cheb=3, dtype="float32",
    )
    saved = smooth._DENSE_E_LEVEL_CAP_BYTES
    saved_xy = smooth._UNSHARDED_BUILD
    smooth._DENSE_E_LEVEL_CAP_BYTES = 256 * 1024
    # sharded build: factored fallback (the per-offset form is a
    # single-device representation)
    smooth._UNSHARDED_BUILD = False
    try:
        s = TransportSolver(cfg, backend="fmm")
        g = s.grid
        sig = 8 * 0.5 * (1 - np.cos(2 * np.pi * g.nodes_x))
        s.set_coeff(sig, sig + 0.2)
    finally:
        smooth._DENSE_E_LEVEL_CAP_BYTES = saved
        smooth._UNSHARDED_BUILD = saved_xy
    reprs = [isinstance(v, dict) for v in s._caches["m2l_E"].values()]
    assert any(reprs), "cap override failed to force a factored level"
    return s


def _gate_no_volume_gather(s, mesh, compiled):
    """The O(halo) gate: no volume all-gathers (scalar control traffic
    from the loop-variance anchor is allowed), halo-sized permutes."""
    st = compiled_collective_stats(compiled)
    field_bytes = s.grid.n_nodes * 4
    assert st.bytes.get("all-gather", 0) <= 16 * 1024, st
    assert st.counts.get("collective-permute", 0) > 0, st
    assert st.total_bytes() < mesh.devices.size * field_bytes, (
        st, mesh.devices.size * field_bytes,
    )


def test_sharded_factored_matvec_is_o_halo(factored_solver):
    """The factored/stored-patch translate path (the sharded fallback for
    levels that do not fit) must move O(halo), not re-gather the patch
    or near cache: a strided-window patch conv or sharded-axis
    dynamic_slice chunking would both lower to volume all-gathers."""
    s = factored_solver
    mesh = make_mesh()
    if mesh.devices.size < 2:
        pytest.skip("needs a multi-device mesh")
    apply_fn, caches, mode_statics = sharded_solver(s, mesh)
    u = shard_field(mesh, jnp.asarray(
        np.random.default_rng(0).random((32, 32, 4)), jnp.float32))
    compiled = apply_fn.lower(caches, mode_statics[0], 0, u).compile()
    _gate_no_volume_gather(s, mesh, compiled)
    # and the program must still be the right operator
    out = np.asarray(compiled(caches, mode_statics[0], u))
    ref = np.asarray(s.apply_mode(0, u))
    assert np.linalg.norm(out - ref) / np.linalg.norm(ref) < 1e-6


def test_sharded_virtual_patch_matvec_is_o_halo(factored_solver):
    """Same gate for the VIRTUAL representation (patches re-formed from
    the sharded coefficient field inside the matvec -- the f64-twin /
    memory-constrained form): fmm.smooth.patch_for_level must assemble
    patches from halo-2 box-plane slices, not a strided window conv."""
    s = factored_solver
    mesh = make_mesh()
    if mesh.devices.size < 2:
        pytest.skip("needs a multi-device mesh")
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from aniso_tpu.fmm.apply import fmm_apply_mode

    # strip stored patches -> the in-matvec re-forming path (_level_E)
    virt = dict(s._caches)
    virt["m2l_E"] = {
        lv: ({"W": v["W"]} if isinstance(v, dict) else v)
        for lv, v in s._caches["m2l_E"].items()
    }
    virt["coeffs"] = s.sigma_t_coeff.astype(jnp.float32)

    apply_ref = fmm_apply_mode  # single-device reference on same caches
    u_np = np.random.default_rng(0).random((32, 32, 4)).astype(np.float32)
    leaf = s._tcfg.leaf_level
    ref = np.asarray(jax.jit(
        lambda c, m, u: apply_ref(leaf, s._fmm_static, c, m, 0, u)
    )(virt, s._mode_statics[0], u_np))

    from aniso_tpu.parallel.api import shard_pytree, replicate
    caches = shard_pytree(mesh, virt)
    ms0 = shard_pytree(mesh, s._mode_statics[0])
    static = {k: replicate(mesh, v) for k, v in s._fmm_static.items()}
    fspec = NamedSharding(mesh, P("x", "y"))
    n_shards = int(mesh.devices.size)

    @jax.jit
    def apply_fn(cch, ms, u):
        out = fmm_apply_mode(leaf, static, cch, ms, 0, u,
                             n_shards=n_shards)
        return jax.lax.with_sharding_constraint(out, fspec)

    u = shard_field(mesh, jnp.asarray(u_np))
    compiled = apply_fn.lower(caches, ms0, u).compile()
    st = compiled_collective_stats(compiled)
    # the hard gate: no volume all-gathers (round-3 code re-gathered the
    # whole coefficient field per factored level: 62 all-gathers,
    # 2.75 GB/shard at 1024^2); every patch-assembly exchange must be a
    # permute -- scalar control traffic allowed
    assert st.bytes.get("all-gather", 0) <= 16 * 1024, st
    assert st.counts.get("collective-permute", 0) > 0, st
    # byte bound: at this tiny 32^2 grid the halo-2 box-plane assembly
    # (7-cell window vs 16-cell shards) legitimately moves ~12 field
    # equivalents; the broken path moved ~800x the halo.  The bound is
    # loose here because halo/volume ~ 1 at sz=32 -- it shrinks as
    # O(1/sz) at production sizes
    field_bytes = s.grid.n_nodes * 4
    assert st.total_bytes() < 4 * mesh.devices.size * field_bytes, st
    out = np.asarray(compiled(caches, ms0, u))
    assert np.linalg.norm(out - ref) / np.linalg.norm(ref) < 1e-6


def test_sharded_gmres_moves_halo_not_volume(sharded_matvec):
    """The SOLVE-level collectives: a GMRES that flattens the sharded
    field (reshape(-1) merges the sharded dims) re-gathers volume-sized
    operands in every basis update (144 all-gathers x 8.6 MB/shard per
    256^2 sharded solve).  The natural-shape GMRES must emit only
    scalar/control all-gathers; CGS2
    reductions become all-reduces of (m+1,) scalars."""
    import jax
    from aniso_tpu.solver.gmres import gmres

    s, mesh, _ = sharded_matvec
    if mesh.devices.size < 2:
        pytest.skip("needs a multi-device mesh")
    apply_fn, caches, ms = sharded_solver(s, mesh)
    rng = np.random.default_rng(3)
    u = shard_field(
        mesh, jnp.asarray(rng.random((32, 32, 4)), jnp.float32)
    )
    sig = shard_field(mesh, s.sigma_s)

    @jax.jit
    def solve_step(cch, m0, sg, b):
        def mv(v):
            return v - apply_fn(cch, m0, 0, sg * v)

        res = gmres(mv, b, restart=6, max_iter=6, tol=1e-12)
        return res.x, res.residual

    compiled = solve_step.lower(caches, ms[0], sig, u).compile()
    st = compiled_collective_stats(compiled)
    # the hard gate: no volume all-gathers anywhere in a FULL gmres
    # program (matvecs + basis updates + reductions + x update)
    assert st.bytes.get("all-gather", 0) <= 16 * 1024, st
    assert st.counts.get("all-reduce", 0) > 0, st
    x, r = compiled(caches, ms[0], sig, u)
    assert np.isfinite(float(r))
    assert x.shape == u.shape
