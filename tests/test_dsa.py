"""DSA preconditioner: diffusion operator correctness + GMRES acceleration."""

import numpy as np
import jax.numpy as jnp
import pytest

from aniso_tpu.core.config import SolverConfig
from aniso_tpu.core.geometry import make_grid
from aniso_tpu.solver.dsa import (
    DsaPreconditioner, cell_average, make_diffusion_apply, pcg,
)
from aniso_tpu.solver.operator import TransportSolver


def test_cell_average_constant():
    g = make_grid(4, 3)
    vals = jnp.full((4, 4, 9), 2.5)
    np.testing.assert_allclose(np.asarray(cell_average(g, vals)), 2.5)


def test_diffusion_operator_spd_and_constant_mode():
    """A applied to a constant: interior terms vanish, only Robin boundary
    and absorption remain; and x^T A x > 0 for random x (SPD)."""
    sz, dx = 8, 1.0 / 8
    rng = np.random.default_rng(0)
    D = jnp.asarray(0.5 / (1.0 + rng.random((sz, sz))))
    sig_a = jnp.asarray(0.1 + rng.random((sz, sz)))
    apply, diag = make_diffusion_apply(D, sig_a, dx)

    z = jnp.ones((sz, sz))
    out = np.asarray(apply(z))
    interior = out[1:-1, 1:-1] - np.asarray(sig_a)[1:-1, 1:-1]
    np.testing.assert_allclose(interior, 0.0, atol=1e-12)
    assert np.all(out >= np.asarray(sig_a) - 1e-12)

    for _ in range(3):
        x = jnp.asarray(rng.standard_normal((sz, sz)))
        assert float(jnp.sum(x * apply(x))) > 0.0
    # diag really is diag(A)
    e = jnp.zeros((sz, sz)).at[3, 5].set(1.0)
    assert float(apply(e)[3, 5]) == pytest.approx(float(diag[3, 5]))


def test_pcg_solves():
    sz, dx = 8, 1.0 / 8
    rng = np.random.default_rng(1)
    D = jnp.asarray(0.5 / (1.0 + rng.random((sz, sz))))
    sig_a = jnp.asarray(0.1 + rng.random((sz, sz)))
    apply, diag = make_diffusion_apply(D, sig_a, dx)
    b = jnp.asarray(rng.standard_normal((sz, sz)))
    x = pcg(apply, diag, b, tol=1e-12, max_iter=2000)
    r = np.asarray(b - apply(x))
    assert np.linalg.norm(r) < 1e-10 * np.linalg.norm(np.asarray(b))


def _iters(sz, precond_on, damping=True):
    """Scattering-dominated (sigma_s=20, sigma_a=0.2); sigma_t*dx spans
    the resolved (~1.3 at 16^2) through thick (~2.5 at 8^2) regimes."""
    cfg = SolverConfig(
        domain_size=sz, quad_rule=2, kernel_size=1, g=0.0,
        sing_rule=6, dtype="float64", tol=1e-10, restart=200, max_iter=200,
    )
    solver = TransportSolver(cfg, backend="dense")
    g = solver.grid
    sigma_s = np.full_like(g.nodes_x, 20.0)
    solver.set_coeff(sigma_s, sigma_s + 0.2)
    charge = np.exp(-25 * ((g.nodes_x - 0.5) ** 2 + (g.nodes_y - 0.5) ** 2))
    pre = DsaPreconditioner(solver, damping=damping) if precond_on else None
    res = solver.solve(jnp.asarray(charge)[None], precond=pre)
    assert bool(res.converged)
    return int(res.iterations), res


def test_dsa_accelerates_scattering_dominated():
    it_plain, res_plain = _iters(16, False)
    it_dsa, res_dsa = _iters(16, True)
    # same solution either way
    np.testing.assert_allclose(
        np.asarray(res_dsa.x), np.asarray(res_plain.x), rtol=1e-6, atol=1e-8
    )
    assert it_dsa < it_plain, (it_dsa, it_plain)


def test_dsa_never_hurts_in_thick_cell_regime():
    """On optically thick cells the raw
    continuum-consistent correction actively hurts (measured 43->67 at
    sigma_t*dx = 2.5); the cell-local tau-damping must make
    iterations(DSA) <= iterations(none) across the thick regime while
    keeping the resolved-regime acceleration."""
    for sz in (8, 12):                       # tau = 2.52, 1.68
        it_plain, res_plain = _iters(sz, False)
        it_damped, res_damped = _iters(sz, True, damping=True)
        np.testing.assert_allclose(
            np.asarray(res_damped.x), np.asarray(res_plain.x),
            rtol=1e-6, atol=1e-8,
        )
        assert it_damped <= it_plain, (sz, it_damped, it_plain)
    # the raw (undamped) correction really does hurt at tau=2.5 -- the
    # guard is load-bearing, not vacuous
    it_plain, _ = _iters(8, False)
    it_raw, _ = _iters(8, True, damping=False)
    assert it_raw > it_plain, (it_raw, it_plain)
    # and damping keeps the resolved-regime win (tau ~ 1.26)
    it_plain16, _ = _iters(16, False)
    it_damped16, _ = _iters(16, True, damping=True)
    assert it_damped16 < it_plain16, (it_damped16, it_plain16)


def test_dsa_accelerates_fmm_backend():
    """DSA exercised with the FMM backend.

    Measured study (benchmarks/results_dsa.json, CPU f64): sigma_s=20
    iso: 24->12 iters at 32^2, 22->9 at 64^2; sigma_s=50: 59->26;
    multi-mode g=0.9: 34->23.  Gate the cheapest case here.
    """
    cfg = SolverConfig(
        domain_size=32, quad_rule=2, kernel_size=1, g=0.0,
        sing_rule=6, np_cheb=4, dtype="float64", tol=1e-10,
        restart=200, max_iter=300,
    )
    solver = TransportSolver(cfg, backend="fmm")
    g = solver.grid
    sigma_s = np.full_like(g.nodes_x, 20.0)
    solver.set_coeff(sigma_s, sigma_s + 0.2)
    charge = np.exp(-25 * ((g.nodes_x - 0.5) ** 2 + (g.nodes_y - 0.5) ** 2))
    res_plain = solver.solve(jnp.asarray(charge)[None])
    res_dsa = solver.solve(
        jnp.asarray(charge)[None], precond=DsaPreconditioner(solver)
    )
    assert bool(res_plain.converged) and bool(res_dsa.converged)
    np.testing.assert_allclose(
        np.asarray(res_dsa.x), np.asarray(res_plain.x), rtol=1e-6, atol=1e-8
    )
    assert int(res_dsa.iterations) <= int(res_plain.iterations) - 8, (
        int(res_dsa.iterations), int(res_plain.iterations),
    )
