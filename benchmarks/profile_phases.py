#!/usr/bin/env python
"""Per-phase timing of the corrected FMM matvec.

Times (jitted separately, caches passed as ARGS -- never captured as
constants, which would bake GBs into the programs):
up sweep, down sweep (M2L+L2L+L2T), near field, the full fused apply, and
a K-chained scan (the amortized cost a jitted GMRES actually pays).

Appends a JSON record per size to benchmarks/results_phases.json.

Usage: python benchmarks/profile_phases.py --sizes 64 128 [--reps 10]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax
import jax.numpy as jnp
import numpy as np

RESULTS = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "results_phases.json"
)


def timeit(fn, u, *args, reps=10, vary=None):
    """Median wall time of fn over `reps` calls, each timed to completion.
    vary: index of the arg (in u, *args) perturbed per rep to defeat any
    caching of pure executions."""
    jax.block_until_ready(fn(u, *args))
    ts = []
    for r in range(reps):
        uu = u + jnp.zeros_like(u) if vary is None else u + u.dtype.type(
            1e-6 * (r + 1))
        uu.block_until_ready()
        t0 = time.perf_counter()
        jax.block_until_ready(fn(uu, *args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def run_one(sz, deg, reps, K):
    from aniso_tpu import SolverConfig
    from aniso_tpu.solver.operator import TransportSolver
    from aniso_tpu.fmm import apply as A
    from aniso_tpu.fmm.smooth import m2l_cache_bytes

    cfg = SolverConfig(domain_size=sz, quad_rule=deg, kernel_size=1, g=0.95,
                       sing_rule=8, np_cheb=4, dtype="float32")
    solver = TransportSolver(cfg, backend="fmm")
    g = solver.grid
    sig_s = 16 * 0.5 * (1 - np.cos(2 * np.pi * g.nodes_x))
    solver.set_coeff(sig_s, sig_s + 0.2)
    u = jnp.asarray(
        np.exp(-25 * ((g.nodes_x - 0.5) ** 2 + (g.nodes_y - 0.5) ** 2)),
        dtype=jnp.float32,
    )
    static = solver._fmm_static
    caches = solver._caches
    ms = solver._mode_statics[0]
    leaf = solver._tcfg.leaf_level

    upf = jax.jit(lambda u, st: A._up_pass(st, leaf, u))
    M = {k: jax.block_until_ready(v) for k, v in upf(u, static).items()}
    t_up = timeit(upf, u, static, reps=reps, vary=0)

    down = jax.jit(
        lambda u, st, c, ms: jnp.einsum(
            "kc,ijc->ijk", st["l2t"],
            A._down_pass(st, leaf, A._up_pass(st, leaf, u), c["m2l_E"],
                         ms["m2l_cosr"], coeffs=c.get("coeffs")),
        )
    )
    t_updown = timeit(down, u, static, caches, ms, reps=reps, vary=0)
    # t_down is a DIFFERENCE of two measurements; implausible when
    # negative or below streaming the M2L cache once at ~1 TB/s
    t_down = t_updown - t_up
    down_floor_s = m2l_cache_bytes(caches["m2l_E"]) / 1e12
    down_valid = t_down >= down_floor_s
    if not down_valid:
        print(f"WARNING: implausible differenced down-pass timing "
              f"{t_down*1e3:.3f} ms (< M2L stream floor "
              f"{down_floor_s*1e3:.3f} ms); recording as invalid",
              flush=True)

    near = jax.jit(lambda u, c, ms: A._near_apply(c, ms, 0, u))
    t_near = timeit(near, u, caches, ms, reps=reps, vary=0)

    full = jax.jit(
        lambda u, st, c, ms: A.fmm_apply_mode(leaf, st, c, ms, 0, u)
    )
    t_full = timeit(full, u, static, caches, ms, reps=reps, vary=0)

    import functools

    @functools.partial(jax.jit, static_argnums=(4,))
    def chain(st, c, ms, u, k):
        def body(v, _):
            return A.fmm_apply_mode(leaf, st, c, ms, 0, v), None
        v, _ = jax.lax.scan(body, u, None, length=k)
        return v

    t_chain = timeit(lambda v: chain(static, caches, ms, v, K), u,
                     reps=reps, vary=0) / K
    # plausibility gate: a chained apply cannot be faster than streaming
    # its caches once at ~1 TB/s
    floor_s = (m2l_cache_bytes(caches["m2l_E"])
               + int(np.prod(caches["near_E"].shape)) * 4) / 1e12
    implausible = t_chain < floor_s
    if implausible:
        print(f"WARNING: implausible chained timing {t_chain*1e3:.3f} ms "
              f"(< cache-stream floor {floor_s*1e3:.3f} ms); recording as "
              "invalid", flush=True)

    m2l_bytes = m2l_cache_bytes(caches["m2l_E"])
    near_bytes = int(np.prod(caches["near_E"].shape)) * 4
    dev = jax.devices()[0]
    rec = {
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "sz": sz, "deg": deg, "nodes": g.n_nodes, "reps": reps, "K": K,
        "up_ms": round(t_up * 1e3, 3),
        "down_ms": round(t_down * 1e3, 3),
        "down_ms_valid": bool(down_valid),
        "near_ms": round(t_near * 1e3, 3),
        "full_single_dispatch_ms": round(t_full * 1e3, 3),
        "chained_ms_per_apply": round(t_chain * 1e3, 3),
        "timing_valid": not implausible,
        "phase_timing_note": (
            "up/down/near/full are separate-dispatch timings, which "
            "include one dispatch each; chained_ms_per_apply does not"
        ),
        "m2l_cache_mb": round(m2l_bytes / 1e6, 1),
        "near_cache_mb": round(near_bytes / 1e6, 1),
        "cache_bw_gbps": round((m2l_bytes + near_bytes) / t_chain / 1e9, 1),
        "nodes_per_s": round(g.n_nodes / t_chain, 0),
    }
    return rec


def main():
    from aniso_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="+", default=[64])
    ap.add_argument("--deg", type=int, default=3)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--chain", type=int, default=50)
    args = ap.parse_args()

    all_recs = []
    if os.path.exists(RESULTS):
        with open(RESULTS) as f:
            all_recs = json.load(f)
    for sz in args.sizes:
        rec = run_one(sz, args.deg, args.reps, args.chain)
        print(json.dumps(rec), flush=True)
        # dedup on every varied parameter, not just sz
        key = (sz, args.deg, args.chain)
        all_recs = [
            r for r in all_recs
            if (r.get("sz"), r.get("deg"), r.get("K")) != key
        ] + [rec]
        with open(RESULTS, "w") as f:
            json.dump(all_recs, f, indent=1)


if __name__ == "__main__":
    main()
