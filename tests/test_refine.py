"""Mixed-precision iterative refinement (solver/refine.py).

The reference solves in f64 to 1e-12 (main.cpp:141); the fast path here is
f32 with a ~1e-6 true-residual floor.  These tests check on CPU (where
f32 is genuine f32 and f64 genuine f64) that the refined solve drives the
TRUE f64 residual below tolerances no plain f32 solve can reach.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from aniso_tpu import SolverConfig
from aniso_tpu.solver.operator import TransportSolver


def _problem(sz=16, N=2, g=0.5):
    cfg = SolverConfig(
        domain_size=sz, quad_rule=3, kernel_size=N, g=g, sing_rule=8,
        np_cheb=4, dtype="float32", refine=True, tol=1e-11,
        restart=60, max_iter=300,
    )
    s = TransportSolver(cfg, backend="fmm")
    grid = s.grid
    sig_s = 8 * 0.5 * (1 - np.cos(2 * np.pi * grid.nodes_x))
    s.set_coeff(sig_s, sig_s + 0.2)
    q = np.exp(
        -25 * ((grid.nodes_x - 0.5) ** 2 + (grid.nodes_y - 0.5) ** 2)
    )
    charge = np.stack([q] + [0 * q] * (N - 1))
    return s, charge


def test_refined_solve_reaches_f64_accuracy():
    s, charge = _problem()
    res = s.solve(charge)
    assert res.converged
    # independent check: recompute the true residual from scratch in f64
    b = s._rhs64(jnp.asarray(charge, jnp.float64))
    r = b - s._forward64(res.x)
    rel = float(jnp.linalg.norm(r)) / float(jnp.linalg.norm(b))
    assert rel < 1e-11, rel
    # must have actually used the mixed path: >=2 inner solves, f64 result
    assert res.refinements >= 2
    assert res.x.dtype == jnp.float64
    # monotone contraction by ~the f32 floor per round
    assert res.history[1] < 1e-4 * res.history[0]


def test_refined_matches_full_f64_solution():
    s, charge = _problem(sz=8, N=1, g=0.95)
    res = s.solve(charge)
    cfg64 = SolverConfig(
        domain_size=8, quad_rule=3, kernel_size=1, g=0.95, sing_rule=8,
        np_cheb=4, dtype="float64", tol=1e-11, restart=60, max_iter=300,
    )
    s64 = TransportSolver(cfg64, backend="fmm")
    grid = s64.grid
    sig_s = 8 * 0.5 * (1 - np.cos(2 * np.pi * grid.nodes_x))
    s64.set_coeff(sig_s, sig_s + 0.2)
    ref = s64.solve(jnp.asarray(charge, jnp.float64))
    diff = float(jnp.max(jnp.abs(res.x - ref.x)))
    scale = float(jnp.max(jnp.abs(ref.x)))
    assert diff / scale < 1e-9, diff / scale


def test_refine_requires_f32():
    with pytest.raises(ValueError):
        SolverConfig(dtype="float64", refine=True).validate()


def test_cfg_loader_parses_refine(tmp_path):
    p = tmp_path / "data.cfg"
    p.write_text("domainSize = 8\ndtype = float32\nRefine = 1\n")
    from aniso_tpu.core.config import load_cfg

    cfg = load_cfg(str(p))
    assert cfg.refine and cfg.dtype == "float32"


def test_device_twin_matches_host_twin_oracle(monkeypatch):
    """refine_twin='device' (f64 caches via device builders, 'virtual'
    representation: near-field E and factored-level patches re-formed
    from the coefficient field inside the matvec) must agree with the
    round-2 numpy/BLAS host twin to f64 roundoff: same residual history,
    same solution, and the two f64 operators agree on a random vector.
    The cap override forces factored fine levels so the virtual patch
    path is exercised."""
    import aniso_tpu.fmm.smooth as S

    monkeypatch.setattr(S, "_DENSE_E_LEVEL_CAP_BYTES", 0)
    results = {}
    ops = {}
    for twin in ("device", "host"):
        cfg = SolverConfig(
            domain_size=16, quad_rule=3, kernel_size=2, g=0.5, sing_rule=8,
            np_cheb=4, dtype="float32", refine=True, refine_twin=twin,
            tol=1e-11, restart=60, max_iter=300,
        )
        s = TransportSolver(cfg, backend="fmm")
        grid = s.grid
        sig_s = 8 * 0.5 * (1 - np.cos(2 * np.pi * grid.nodes_x))
        s.set_coeff(sig_s, sig_s + 0.2)
        q = np.exp(
            -25 * ((grid.nodes_x - 0.5) ** 2 + (grid.nodes_y - 0.5) ** 2)
        )
        charge = np.stack([q, 0 * q])
        results[twin] = s.solve(charge)
        rng = np.random.default_rng(3)
        v = jnp.asarray(
            rng.standard_normal((2,) + grid.nodes_x.shape), jnp.float64
        )
        ops[twin] = np.asarray(s._forward64(v))
    np.testing.assert_allclose(ops["device"], ops["host"],
                               rtol=1e-12, atol=1e-13)
    for twin, res in results.items():
        assert res.converged and res.residual < 1e-11, (twin, res.residual)
    dx = np.abs(
        np.asarray(results["device"].x) - np.asarray(results["host"].x)
    ).max()
    assert dx < 1e-9, dx


def test_virtual_near_chunked_matches_unchunked(monkeypatch):
    """Forcing the chunked virtual near path (tiny temp cap) must
    reproduce the stored-near_E operator exactly."""
    import aniso_tpu.fmm.apply as A
    import aniso_tpu.fmm.smooth as S

    monkeypatch.setattr(S, "_DENSE_E_LEVEL_CAP_BYTES", 0)
    cfg = SolverConfig(
        domain_size=16, quad_rule=3, kernel_size=1, g=0.5, sing_rule=8,
        np_cheb=4, dtype="float32", refine=True, tol=1e-9,
    )
    s = TransportSolver(cfg, backend="fmm")
    grid = s.grid
    sig = 8 * 0.5 * (1 - np.cos(2 * np.pi * grid.nodes_x))
    s.set_coeff(sig, sig + 0.2)
    rng = np.random.default_rng(11)
    v = jnp.asarray(
        rng.standard_normal((1,) + grid.nodes_x.shape), jnp.float64
    )
    ref = np.asarray(s._forward64(v))
    monkeypatch.setattr(A, "_NEAR_VIRTUAL_CHUNK_CAP_BYTES", 1)
    s._make_fmm_jits()     # retrace with chunking forced
    out = np.asarray(s._forward64(v))
    np.testing.assert_allclose(out, ref, rtol=1e-13, atol=1e-14)


def test_stored_near_chunked_matches_unchunked(monkeypatch):
    """The chunked STORED-near_E branch (dynamic_slice of caches['near_E']
    along axis 4) -- the branch the production f32 512^2 solve takes, since
    its 765 MB near cache exceeds the temp cap -- must reproduce the
    unchunked stored-E operator exactly."""
    import aniso_tpu.fmm.apply as A

    cfg = SolverConfig(
        domain_size=16, quad_rule=3, kernel_size=1, g=0.5, sing_rule=8,
        np_cheb=4, dtype="float32",
    )
    s = TransportSolver(cfg, backend="fmm")
    grid = s.grid
    sig = 8 * 0.5 * (1 - np.cos(2 * np.pi * grid.nodes_x))
    s.set_coeff(sig, sig + 0.2)
    assert "near_E" in s._caches          # stored (non-virtual) form
    rng = np.random.default_rng(7)
    v = jnp.asarray(rng.standard_normal(grid.nodes_x.shape), jnp.float32)
    ref = np.asarray(s.apply_mode(0, v))
    monkeypatch.setattr(A, "_NEAR_VIRTUAL_CHUNK_CAP_BYTES", 1)
    s._make_fmm_jits()     # retrace with row streaming forced
    out = np.asarray(s.apply_mode(0, v))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-8)
