#!/usr/bin/env python
"""Scale series over the BASELINE.json configs.

Per size: set_coeff wall, amortized corrected-matvec ms (chained scan, as a
jitted GMRES sees it), refined GMRES solve wall + TRUE f64 residual, and the
E-cache footprint. Results append to benchmarks/results_scale.json after
every size so partial runs persist.

Usage: python benchmarks/scale_series.py --sizes 64 128 256 --modes 1 --g 0.5
"""

import argparse
import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax

# x64 on unconditionally: the device coarse-E builder runs its exact f64
# quadrature on the device (fmm.smooth.build_m2l_E_coarse_device) for the
# f32 rows too; the solve path stays f32 (cfg.dtype)
jax.config.update("jax_enable_x64", True)

import numpy as np

RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results_scale.json")


def run_one(sz, n_modes, g, tol, refine, np_cheb, matvec_reps, restart=80):
    import jax.numpy as jnp
    from aniso_tpu import SolverConfig
    from aniso_tpu.solver.operator import TransportSolver
    from aniso_tpu.fmm import apply as A
    from aniso_tpu.fmm.smooth import m2l_cache_bytes
    from aniso_tpu.utils.roofline import device_peaks, roofline_summary

    cfg = SolverConfig(
        domain_size=sz, quad_rule=3, kernel_size=n_modes, g=g,
        sing_rule=8, np_cheb=np_cheb, dtype="float32", refine=refine,
        tol=tol, restart=restart, max_iter=400,
    )
    t0 = time.time()
    solver = TransportSolver(cfg, backend="fmm")
    init_s = time.time() - t0
    grid = solver.grid
    # heterogeneous sigma (reference main.cpp:42-46 closures)
    sig_s = 16 * 0.5 * (1 - np.cos(2 * np.pi * grid.nodes_x))
    t0 = time.time()
    solver.set_coeff(sig_s, sig_s + 0.2)
    setup_s = time.time() - t0
    cold_phases = getattr(solver, "set_coeff_phases", None)
    # steady state: the first call pays one-time XLA compiles and
    # static-table uploads; a second call with fresh sigma
    # measures what repeated coefficient updates actually cost
    try:
        t0 = time.time()
        solver.set_coeff(sig_s * 1.01, sig_s * 1.01 + 0.2)
        setup_warm_s = time.time() - t0
    except Exception as e:  # record, keep the size's other metrics
        setup_warm_s = None
        print(f"warm set_coeff failed: {type(e).__name__}", flush=True)
        solver.set_coeff(sig_s, sig_s + 0.2)

    q = np.exp(-25 * ((grid.nodes_x - 0.5) ** 2 + (grid.nodes_y - 0.5) ** 2))
    charge = np.stack([q] + [0 * q] * (n_modes - 1))

    # amortized single-mode corrected matvec: two chain lengths K and 5K
    # are timed to completion and differenced, cancelling the fixed
    # dispatch/transfer latency of one call.
    u = jnp.asarray(q, dtype=jnp.float32)
    caches, ms0 = solver._caches, solver._mode_statics[0]
    leaf, static = solver._tcfg.leaf_level, solver._fmm_static
    K = matvec_reps

    @functools.partial(jax.jit, static_argnums=(4,))
    def chain(c, m, s, v, k):
        def body(w, _):
            return A.fmm_apply_mode(leaf, s, c, m, 0, w), None
        out = jax.lax.scan(body, v, None, length=k)[0]
        return jnp.sum(out)

    t0 = time.time()
    chain(caches, ms0, static, u, K).block_until_ready()
    matvec_compile_s = time.time() - t0
    chain(caches, ms0, static, u, 5 * K).block_until_ready()

    def timed(k, rep):
        urep = (u + jnp.float32(1e-6 * (rep + 1))).block_until_ready()
        t0 = time.perf_counter()
        chain(caches, ms0, static, urep, k).block_until_ready()
        return time.perf_counter() - t0

    from timing import amortized_apply_time
    matvec_s, timing_detail = amortized_apply_time(timed, K)

    t0 = time.time()
    res = solver.solve(charge)
    jax.block_until_ready(res.x)
    solve_cold_s = time.time() - t0
    t0 = time.time()
    res = solver.solve(charge)
    jax.block_until_ready(res.x)
    solve_warm_s = time.time() - t0

    cache_mb = (
        m2l_cache_bytes(caches["m2l_E"])
        + caches["near_E"].size * caches["near_E"].dtype.itemsize
    ) / 1e6
    dev = jax.devices()[0]
    rec = {
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "sz": sz, "modes": n_modes, "g": g, "np_cheb": np_cheb,
        "nodes": grid.n_nodes, "refine": refine, "tol": tol,
        "init_s": round(init_s, 2), "set_coeff_s": round(setup_s, 2),
        "set_coeff_warm_s": (
            None if setup_warm_s is None else round(setup_warm_s, 2)
        ),
        "set_coeff_phases_cold": cold_phases,
        "matvec_ms": round(matvec_s * 1e3, 3),
        "matvec_compile_s": round(matvec_compile_s, 1),
        "grid_points_per_s": round(grid.n_nodes / matvec_s, 0),
        "solve_cold_s": round(solve_cold_s, 2),
        "solve_warm_s": round(solve_warm_s, 2),
        "iters": int(res.iterations),
        "residual": float(res.residual),
        "refinements": int(getattr(res, "refinements", 0)),
        "history": [float(h) for h in getattr(res, "history", [])],
        "solve_phases": getattr(res, "phases", None),
        "e_cache_mb_f32": round(cache_mb, 1),
        "set_coeff_phases": getattr(solver, "set_coeff_phases", None),
        "roofline": roofline_summary(
            solver, matvec_s, device_peaks(dev.device_kind)),
        "level_repr": {
            int(lv): ("per-offset" if isinstance(v, dict) and "Wo" in v
                      else "factored" if isinstance(v, dict) else "dense")
            for lv, v in caches["m2l_E"].items()
        },
        "refine_twin": cfg.refine_twin if refine else None,
        "timing": timing_detail,
    }
    return rec


def main():
    from aniso_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="+", default=[64, 128, 256])
    ap.add_argument("--modes", type=int, default=1)
    ap.add_argument("--g", type=float, default=0.5)
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--np-cheb", type=int, default=4)
    ap.add_argument("--no-refine", action="store_true")
    ap.add_argument("--matvec-reps", type=int, default=50)
    ap.add_argument("--restart", type=int, default=80,
                    help="GMRES restart (the Krylov basis is a "
                         "(restart+1) x n temp inside the solve program; "
                         "40 suffices at <=30-iteration configs and "
                         "halves it)")
    ap.add_argument("--tag", type=str, default="")
    args = ap.parse_args()

    all_results = []
    if os.path.exists(RESULTS):
        with open(RESULTS) as f:
            all_results = json.load(f)
    for sz in args.sizes:
        print(f"=== sz={sz} modes={args.modes} g={args.g} ===", flush=True)
        try:
            rec = run_one(
                sz, args.modes, args.g, args.tol, not args.no_refine,
                args.np_cheb, args.matvec_reps, args.restart,
            )
            # release the previous size's device buffers before the next
            # (solver caches die with run_one's frame; force collection)
            import gc

            gc.collect()
        except Exception as e:  # record the failure, keep going
            rec = {
                "sz": sz, "modes": args.modes, "g": args.g,
                "error": f"{type(e).__name__}: {e}",
            }
        rec["tag"] = args.tag
        print(json.dumps(rec), flush=True)
        all_results = [
            r for r in all_results
            if not (r.get("sz") == sz and r.get("modes") == args.modes
                    and r.get("tag") == args.tag)
        ] + [rec]
        with open(RESULTS, "w") as f:
            json.dump(all_results, f, indent=1)


if __name__ == "__main__":
    main()
