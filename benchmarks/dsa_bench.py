#!/usr/bin/env python
"""DSA preconditioner effectiveness on benchmark-style configs: plain vs
DSA-preconditioned GMRES iteration counts and wall
times with the FMM backend, across optical thicknesses tau = sigma_t*dx.

Regenerates benchmarks/results_dsa.json.  Runs on the CPU backend in f64
(preconditioner effectiveness is precision/hardware independent; CPU
keeps the sweep cheap and exact).

Usage: python benchmarks/dsa_bench.py [--cases default]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np

RESULTS = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "results_dsa.json"
)

CASES = [
    # (sz, sigma_s, g, modes): spans thin -> thick cells and isotropic ->
    # forward-peaked scattering (the regime DSA targets is high albedo)
    (32, 20.0, 0.0, 1),
    (64, 20.0, 0.0, 1),
    (64, 50.0, 0.0, 1),
    (64, 20.0, 0.9, 3),
]


def run_case(sz, sigma_s_val, g_aniso, modes):
    import jax.numpy as jnp
    from aniso_tpu import SolverConfig
    from aniso_tpu.solver.operator import TransportSolver
    from aniso_tpu.solver.dsa import DsaPreconditioner

    cfg = SolverConfig(
        domain_size=sz, quad_rule=2, kernel_size=modes, g=g_aniso,
        sing_rule=8, np_cheb=4, dtype="float64",
        tol=1e-8, restart=80, max_iter=200,
    )
    solver = TransportSolver(cfg, backend="fmm")
    grid = solver.grid
    sig_s = np.full(grid.nodes_x.shape, sigma_s_val)
    sig_t = sig_s + 0.2
    solver.set_coeff(sig_s, sig_t)

    q = np.zeros((modes,) + grid.nodes_x.shape)
    q[0] = np.exp(-25 * ((grid.nodes_x - 0.5) ** 2
                         + (grid.nodes_y - 0.5) ** 2))

    t0 = time.time()
    res_plain = solver.solve(jnp.asarray(q))
    jax.block_until_ready(res_plain.x)
    wall_plain = time.time() - t0

    precond = DsaPreconditioner(solver)
    t0 = time.time()
    res_dsa = solver.solve(jnp.asarray(q), precond=precond)
    jax.block_until_ready(res_dsa.x)
    wall_dsa = time.time() - t0

    return {
        "sz": sz, "sigma_s": sigma_s_val, "g": g_aniso, "modes": modes,
        "tau_cell": round(float(sig_t.max()) / sz, 3),
        "iters_plain": int(res_plain.iterations),
        "conv_plain": bool(res_plain.converged),
        "wall_plain_s": round(wall_plain, 1),
        "iters_dsa": int(res_dsa.iterations),
        "conv_dsa": bool(res_dsa.converged),
        "wall_dsa_s": round(wall_dsa, 1),
    }


def main():
    argparse.ArgumentParser().parse_args()
    out = []
    for case in CASES:
        rec = run_case(*case)
        print(json.dumps(rec), flush=True)
        out.append(rec)
    with open(RESULTS, "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
