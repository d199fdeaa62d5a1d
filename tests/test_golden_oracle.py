"""Golden tests against the reference C++ binary's output.

benchmarks/oracle_16/ holds result.csv / points.csv produced by the
reference CLI (built via benchmarks/ref_build/build.sh) on the 16x16
variant of its default problem (main.cpp:29-46, data.cfg with
domainSize=16).  The comparison permutes nodes by coordinate: the
reference's Gauss table orders points centre-first (Quadrature.cpp),
ours ascending.

Expected agreement is bounded by the *reference's own* FMM truncation
(np=4 rank-16 black-box FMM: ~1e-4 on the 1/r kernel, ~1e-3 on the
attenuated kernel, amplified by the near-critical solve): measured
~4e-3 relative Linf.  Our dense path is exact, so tighter agreement is
impossible without reproducing the reference's approximation error.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from aniso_tpu.core.config import SolverConfig
from aniso_tpu.solver.operator import TransportSolver

ORACLE = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "oracle_16")

pytestmark = pytest.mark.skipif(
    not os.path.exists(os.path.join(ORACLE, "result.csv")),
    reason="oracle artifacts not present",
)


def _node_permutation(grid, pts):
    mine = np.stack([grid.nodes_x.reshape(-1), grid.nodes_y.reshape(-1)], -1)
    order_m = np.lexsort((mine[:, 1], mine[:, 0]))
    order_r = np.lexsort((pts[:, 1], pts[:, 0]))
    assert np.allclose(mine[order_m], pts[order_r], atol=1e-12)
    perm = np.empty(len(pts), dtype=int)
    perm[order_m] = order_r
    return perm


ORACLE64 = os.path.join(
    os.path.dirname(__file__), "..", "benchmarks", "oracle_64"
)


@pytest.mark.skipif(
    not os.path.exists(os.path.join(ORACLE64, "result.csv")),
    reason="64^2 oracle artifacts not present",
)
def test_fmm_solution_matches_reference_cli_64():
    """FMM backend + compat_global_basis at the reference CLI's default
    problem (data.cfg: 64^2, deg 3, g=0.95, singRule 8, np 4) vs the
    committed reference output benchmarks/oracle_64/result.csv.

    Tolerance justification: both solvers run a rank-16 (np=4) black-box
    Chebyshev FMM on the same kernel, each contributing ~1e-4 relative
    truncation (our FMM-vs-dense error at 64^2-like configs is measured
    at ~1e-3 by test_fmm_matches_dense with deg=2, and the convergence
    test shows it shrinks with np); the reference's own truncation is
    independent and of the same order.  Measured agreement: 2.2e-4
    relative Linf; the gate is 1e-3.
    """
    ref = np.loadtxt(os.path.join(ORACLE64, "result.csv"))
    pts = np.loadtxt(os.path.join(ORACLE64, "points.csv"))

    cfg = SolverConfig(domain_size=64, quad_rule=3, kernel_size=1, g=0.95,
                       sing_rule=8, np_cheb=4, tol=1e-10, restart=80,
                       max_iter=400, compat_global_basis=True,
                       dtype="float64")
    s = TransportSolver(cfg, backend="fmm")
    g = s.grid
    perm = _node_permutation(g, pts)
    sig_s = 16 * 0.5 * (1 - np.cos(2 * np.pi * g.nodes_x))
    s.set_coeff(sig_s, sig_s + 0.2)
    q = np.exp(-25 * ((g.nodes_x - 0.5) ** 2 + (g.nodes_y - 0.5) ** 2))
    res = s.solve(q)
    assert bool(res.converged)
    x = np.asarray(res.x).reshape(-1)
    rel = np.abs(x - ref[perm]).max() / np.abs(ref).max()
    assert rel < 1e-3, rel


def test_solution_matches_reference_cli():
    ref = np.loadtxt(os.path.join(ORACLE, "result.csv"))
    pts = np.loadtxt(os.path.join(ORACLE, "points.csv"))

    cfg = SolverConfig(domain_size=16, quad_rule=3, kernel_size=1, g=0.95,
                       sing_rule=8, tol=1e-12, restart=80, max_iter=400,
                       compat_global_basis=True)
    s = TransportSolver(cfg, backend="dense")
    g = s.grid
    perm = _node_permutation(g, pts)
    sig_s = 16 * 0.5 * (1 - np.cos(2 * np.pi * g.nodes_x))
    s.set_coeff(sig_s, sig_s + 0.2)
    q = np.exp(-25 * ((g.nodes_x - 0.5) ** 2 + (g.nodes_y - 0.5) ** 2))
    res = s.solve(q)
    assert bool(res.converged)
    x = np.asarray(res.x).reshape(-1)
    rel = np.abs(x - ref[perm]).max() / np.abs(ref).max()
    assert rel < 1e-2, rel
    # solutions are on the same physical scale
    assert np.isclose(x.max(), ref.max(), rtol=2e-2)


ORACLE128 = os.path.join(
    os.path.dirname(__file__), "..", "benchmarks", "oracle_128"
)


@pytest.mark.skipif(
    not os.path.exists(os.path.join(ORACLE128, "result.csv")),
    reason="128^2 oracle artifacts not present",
)
def test_fmm_solution_matches_reference_cli_128():
    """FMM backend at BASELINE config-2 scale (128^2, deg 3, HG g=0.5,
    singRule 8, np 4) vs the committed reference CLI output
    benchmarks/oracle_128/result.csv.

    Same tolerance rationale as the 64^2 gate: both solvers run rank-16
    black-box FMMs contributing ~1e-4 truncation each.
    """
    ref = np.loadtxt(os.path.join(ORACLE128, "result.csv"))
    pts = np.loadtxt(os.path.join(ORACLE128, "points.csv"))

    cfg = SolverConfig(domain_size=128, quad_rule=3, kernel_size=1, g=0.5,
                       sing_rule=8, np_cheb=4, tol=1e-10, restart=80,
                       max_iter=400, compat_global_basis=True,
                       dtype="float64")
    s = TransportSolver(cfg, backend="fmm")
    g = s.grid
    perm = _node_permutation(g, pts)
    sig_s = 16 * 0.5 * (1 - np.cos(2 * np.pi * g.nodes_x))
    s.set_coeff(sig_s, sig_s + 0.2)
    q = np.exp(-25 * ((g.nodes_x - 0.5) ** 2 + (g.nodes_y - 0.5) ** 2))
    res = s.solve(q)
    assert bool(res.converged)
    x = np.asarray(res.x).reshape(-1)
    rel = np.abs(x - ref[perm]).max() / np.abs(ref).max()
    assert rel < 1e-3, rel
