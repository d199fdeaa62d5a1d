#!/usr/bin/env python
"""Multi-mode coupling at scale.

Proves the mode-independent-cache claim where it matters: set_coeff cost
and cache footprint must be ~flat in the mode count N (the reference
caches a full per-mode FMM operator, AnisoWrapper.cpp:72-90), while the
multi-mode forward (aniso.m:139-156) rides ONE compiled program whose
cost scales with the N x D mode-pair translates, sharing the up sweep
and V-list gathers.

Per (sz, N): warm set_coeff seconds, E-cache MB, amortized forward()
wall (chained scan, as the jitted GMRES sees it), and the derived
per-mode-pair translate throughput.  Appends to results_multimode.json.

Usage: python benchmarks/multimode_scale.py --sz 256 --modes 1 3 5
"""

import argparse
import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax

jax.config.update("jax_enable_x64", True)

import numpy as np

RESULTS = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "results_multimode.json"
)


def run_one(sz, N, g, deg, reps):
    import jax.numpy as jnp
    from aniso_tpu import SolverConfig
    from aniso_tpu.solver.operator import TransportSolver
    from aniso_tpu.fmm.smooth import m2l_cache_bytes

    cfg = SolverConfig(
        domain_size=sz, quad_rule=deg, kernel_size=N, g=g,
        sing_rule=8, np_cheb=4, dtype="float32", tol=1e-7,
        restart=40, max_iter=400,
    )
    sz, g, deg = cfg.domain_size, cfg.g, cfg.quad_rule
    solver = TransportSolver(cfg, backend="fmm")
    grid = solver.grid
    sig_s = 20 * 0.5 * (1 - np.cos(2 * np.pi * grid.nodes_x))
    t0 = time.time()
    solver.set_coeff(sig_s, sig_s + 0.2)
    cold_s = time.time() - t0
    cold_phases = getattr(solver, "set_coeff_phases", None)
    t0 = time.time()
    solver.set_coeff(sig_s * 1.01, sig_s * 1.01 + 0.2)
    warm_s = time.time() - t0
    warm_phases = getattr(solver, "set_coeff_phases", None)
    # a second warm rep separates a one-time per-process effect (e.g. a
    # compile the N=1 run paid earlier in the same process) from a real
    # N-dependence
    t0 = time.time()
    solver.set_coeff(sig_s * 1.02, sig_s * 1.02 + 0.2)
    warm2_s = time.time() - t0
    warm2_phases = getattr(solver, "set_coeff_phases", None)

    q = np.exp(-25 * ((grid.nodes_x - 0.5) ** 2 + (grid.nodes_y - 0.5) ** 2))
    u = jnp.asarray(
        np.stack([q] + [0.1 * q] * (N - 1)), dtype=jnp.float32
    )

    st = solver._fmm_static
    caches = solver._caches
    mss = solver._mode_statics
    C = solver._C_fwd
    sig = solver.sigma_s
    fwd = solver._forward_impl_jit
    K = reps

    @functools.partial(jax.jit, static_argnums=(5,))
    def chain(st_, c_, ms_, C_, s_, k, v):
        def body(w, _):
            return fwd(st_, c_, ms_, C_, s_, w), None
        return jnp.sum(jax.lax.scan(body, v, None, length=k)[0])

    t0 = time.time()
    chain(st, caches, mss, C, sig, K, u).block_until_ready()
    compile_s = time.time() - t0
    chain(st, caches, mss, C, sig, 5 * K, u).block_until_ready()

    def timed(k, rep):
        ur = (u + jnp.float32(1e-6 * (rep + 1))).block_until_ready()
        t0 = time.perf_counter()
        chain(st, caches, mss, C, sig, k, ur).block_until_ready()
        return time.perf_counter() - t0

    from timing import amortized_apply_time

    per, timing_detail = amortized_apply_time(timed, K, reps=5)

    cache_mb = (
        m2l_cache_bytes(caches["m2l_E"])
        + caches["near_E"].size * caches["near_E"].dtype.itemsize
    ) / 1e6
    D = 2 * N - 1
    pairs = N * D          # translate count per forward
    dev = jax.devices()[0]
    return {
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "sz": sz, "modes": N, "g": g, "deg": deg, "nodes": grid.n_nodes,
        "set_coeff_cold_s": round(cold_s, 2),
        "set_coeff_warm_s": round(warm_s, 2),
        "set_coeff_warm2_s": round(warm2_s, 2),
        "set_coeff_phases_cold": cold_phases,
        "set_coeff_phases_warm": warm_phases,
        "set_coeff_phases_warm2": warm2_phases,
        "e_cache_mb": round(cache_mb, 1),
        "level_repr": {
            int(lv): ("per-offset" if isinstance(v, dict) and "Wo" in v
                      else "factored" if isinstance(v, dict) else "dense")
            for lv, v in caches["m2l_E"].items()
        },
        "forward_ms": per * 1e3,
        "timing": timing_detail,
        "forward_compile_s": round(compile_s, 1),
        "mode_pair_translates": pairs,
        "ms_per_mode_pair": round(per * 1e3 / pairs, 3),
        "mode_node_throughput_per_s": round(N * grid.n_nodes / per, 0),
    }


def main():
    from aniso_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--sz", type=int, default=256)
    ap.add_argument("--deg", type=int, default=3)
    ap.add_argument("--g", type=float, default=0.8)
    ap.add_argument("--modes", type=int, nargs="+", default=[1, 3, 5])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--tag", type=str, default="")
    args = ap.parse_args()

    all_recs = []
    if os.path.exists(RESULTS):
        with open(RESULTS) as f:
            all_recs = json.load(f)
    for N in args.modes:
        try:
            rec = run_one(args.sz, N, args.g, args.deg, args.reps)
            import gc

            gc.collect()
        except Exception as e:
            rec = {"sz": args.sz, "modes": N,
                   "error": f"{type(e).__name__}: {e}"}
        rec["tag"] = args.tag
        print(json.dumps(rec), flush=True)
        key = (args.sz, N, args.deg)
        all_recs = [
            r for r in all_recs
            if (r.get("sz"), r.get("modes"), r.get("deg")) != key
        ] + [rec]
        with open(RESULTS, "w") as f:
            json.dump(all_recs, f, indent=1)


if __name__ == "__main__":
    main()
