#!/usr/bin/env python
"""Headline benchmark: corrected-matvec throughput on one device.

Runs the flagship FMM transport operator on the reference CLI's default
problem (main.cpp:29-46: 64x64 squares, deg 3 => 36,864 nodes, g=0.95,
heterogeneous sigma) and prints ONE JSON line:

  {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ...,
   "device": {"platform": ..., "kind": ..., "count": ...}}

vs_baseline is the ratio to the measured reference C++/OpenMP CPU matvec
throughput (benchmarks/baseline_ref.json, produced from
benchmarks/oracle_64/run.log: 0.938 s per corrected matvec).

The matvec is timed amortized (applies chained in one lax.scan program,
as a jitted GMRES sees them): the median over repeats of two chain
lengths, differenced (benchmarks/timing.py).  A full device-resident GMRES
solve is also run; its detail goes to stderr.
"""

import functools
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


def main():
    from aniso_tpu import SolverConfig
    from aniso_tpu.fmm import apply as A
    from aniso_tpu.solver.operator import TransportSolver
    from aniso_tpu.utils.compile_cache import setup_compile_cache
    from aniso_tpu.utils.roofline import device_peaks, roofline_summary

    setup_compile_cache()
    dev = jax.devices()[0]
    sz, deg = 64, 3
    cfg = SolverConfig(
        domain_size=sz, quad_rule=deg, kernel_size=1, g=0.95,
        sing_rule=8, np_cheb=4, dtype="float32",
        tol=1e-7, restart=80, max_iter=400,
    )
    solver = TransportSolver(cfg, backend="fmm")
    g = solver.grid
    sigma_s = 16 * 0.5 * (1 - np.cos(2 * np.pi * g.nodes_x))
    t0 = time.perf_counter()
    solver.set_coeff(sigma_s, sigma_s + 0.2)
    setup_s = time.perf_counter() - t0

    q = np.exp(-25 * ((g.nodes_x - 0.5) ** 2 + (g.nodes_y - 0.5) ** 2))
    u = jnp.asarray(q, dtype=jnp.float32)
    caches = solver._caches
    ms = solver._mode_statics[0]
    leaf = solver._tcfg.leaf_level
    static = solver._fmm_static

    K = 50

    @functools.partial(jax.jit, static_argnums=(1,))
    def chain(u, k):
        def body(v, _):
            return A.fmm_apply_mode(leaf, static, caches, ms, 0, v), None
        return jnp.sum(jax.lax.scan(body, u, None, length=k)[0])

    chain(u, K).block_until_ready()        # compile both chain lengths
    chain(u, 5 * K).block_until_ready()

    def timed(k, rep):
        urep = (u + jnp.float32(1e-6 * (rep + 1))).block_until_ready()
        t0 = time.perf_counter()
        chain(urep, k).block_until_ready()
        return time.perf_counter() - t0

    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "benchmarks"))
    from timing import amortized_apply_time

    per, timing_detail = amortized_apply_time(timed, K, reps=7)
    gps = g.n_nodes / per

    # full device-resident GMRES solve (reference main.cpp:141 flow);
    # the f32 floor is ~1e-7 relative residual, so tol is set there (the
    # reference solves the same problem to 1e-12 in f64)
    t0 = time.perf_counter()
    res = solver.solve(q)
    jax.block_until_ready(res.x)
    solve_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = solver.solve(q)
    jax.block_until_ready(res.x)
    solve_warm_s = time.perf_counter() - t0

    baseline_path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        "benchmarks", "baseline_ref.json",
    )
    with open(baseline_path) as f:
        ref = json.load(f)
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    print(json.dumps({
        "metric": "fmm_corrected_matvec_throughput_64x64_deg3",
        "value": gps,
        "unit": "grid-points/s/device",
        "vs_baseline": gps / ref["matvec_grid_points_per_s"],
        "device": device,
    }))
    detail = {
        "device": device,
        "setup_set_coeff_s": setup_s,
        "matvec_ms": per * 1e3,
        "roofline": roofline_summary(
            solver, per, device_peaks(dev.device_kind)),
        "timing": timing_detail,
        "nodes": g.n_nodes,
        "solve_wall_s_cold": solve_s,
        "solve_wall_s_warm": solve_warm_s,
        "solve_iterations": int(res.iterations),
        "solve_residual": float(res.residual),
        "solve_tol": cfg.tol,
        "ref_solve_wall_s": ref.get("solve_wall_seconds"),
    }
    print(f"# {json.dumps(detail)}", file=sys.stderr)


if __name__ == "__main__":
    main()
