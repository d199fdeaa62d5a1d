"""The wired hand-scheduled halo path (sharded_solver halo='shardmap').

parallel.halo's shard_map + ppermute near-field
exchange and the fine-level M2L parity-plane exchange, wired into
`sharded_solver(..., halo='shardmap')`, must (a) produce the same
corrected matvec as the production GSPMD path, and (b) move O(halo)
bytes with the communication pattern pinned by the code, not by GSPMD
heuristics (no volume all-gathers).  This is the staging ground for
compute/communication overlap across cards (SURVEY section 7 stage 6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aniso_tpu import SolverConfig
from aniso_tpu.solver.operator import TransportSolver
from aniso_tpu.parallel.api import make_mesh, shard_field, sharded_solver
from aniso_tpu.parallel.inspect import compiled_collective_stats


def _build_solver():
    import aniso_tpu.fmm.smooth as smooth

    cfg = SolverConfig(
        domain_size=32, quad_rule=2, kernel_size=1, g=0.9,
        sing_rule=4, np_cheb=3, dtype="float32",
    )
    saved_xy = smooth._UNSHARDED_BUILD
    # sharded build: evicted levels take the GSPMD-safe factored form
    smooth._UNSHARDED_BUILD = False
    try:
        s = TransportSolver(cfg, backend="fmm")
        g = s.grid
        sig = 8 * 0.5 * (1 - np.cos(2 * np.pi * g.nodes_x))
        s.set_coeff(sig, sig + 0.2)
    finally:
        smooth._UNSHARDED_BUILD = saved_xy
    return s


@pytest.fixture(scope="module")
def wired(request):
    s = _build_solver()
    mesh = make_mesh()
    if mesh.devices.size < 2:
        pytest.skip("needs a multi-device mesh")
    u_np = np.random.default_rng(0).random((32, 32, 4)).astype(np.float32)
    apply_g, caches_g, ms_g = sharded_solver(s, mesh)
    apply_h, caches_h, ms_h = sharded_solver(s, mesh, halo="shardmap")
    u = shard_field(mesh, jnp.asarray(u_np))
    ref = np.asarray(apply_g(caches_g, ms_g[0], 0, u))
    compiled = apply_h.lower(caches_h, ms_h[0], 0, u).compile()
    out = np.asarray(compiled(caches_h, ms_h[0], u))
    return s, mesh, compiled, ref, out


def test_shardmap_halo_matches_gspmd(wired):
    s, mesh, compiled, ref, out = wired
    assert np.linalg.norm(out - ref) / np.linalg.norm(ref) < 1e-6


def test_shardmap_halo_is_o_halo_and_pinned(wired):
    s, mesh, compiled, ref, out = wired
    st = compiled_collective_stats(compiled)
    field_bytes = s.grid.n_nodes * 4
    # pattern is pinned: the shard_map sections emit explicit permutes
    # (near: 2 axes x 2 directions; M2L: 4 parity planes x 2 axes x 2
    # directions per fine level)
    assert st.counts.get("collective-permute", 0) >= 8, st
    # no volume all-gather anywhere in the program (scalar control
    # traffic from the loop-variance anchor allowed)
    assert st.bytes.get("all-gather", 0) <= 16 * 1024, st
    assert st.total_bytes() < mesh.devices.size * field_bytes, (
        st, mesh.devices.size * field_bytes,
    )
