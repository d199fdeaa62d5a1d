#!/usr/bin/env python
"""Config 5 in shape: the 1024^2 domain-decomposed matvec + GMRES on an
8-virtual-device mesh.

This runs the FULL 1024^2 sharded pipeline -- cache build, sharded corrected matvec,
correctness vs the single-device matvec, per-device cache footprint,
per-program collective traffic, and a few GMRES iterations -- on a CPU
mesh (JAX_PLATFORMS=cpu + xla_force_host_platform_device_count).  Wall
times on 2 real cores time-slicing 8 virtual devices measure
OVERSUBSCRIPTION, not the design, and are recorded only as provenance;
the design claims are the correctness + footprint + traffic columns.

Usage: python benchmarks/virtual_1024.py [--sz 1024] [--iters 5]
"""

import argparse
import json
import os
# sharded benchmarks: evicted fine levels take the GSPMD-safe factored
# form (fmm.smooth.unsharded_build)
os.environ.setdefault("ANISO_UNSHARDED", "0")
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_DEV = 8
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + f" --xla_force_host_platform_device_count={N_DEV}"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
from aniso_tpu.utils.compile_cache import setup_compile_cache  # noqa: E402

setup_compile_cache()

import jax.numpy as jnp
import numpy as np

RESULTS = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "results_1024_virtual.json"
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sz", type=int, default=1024)
    ap.add_argument("--deg", type=int, default=3)
    ap.add_argument("--np-cheb", type=int, default=4)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--g", type=float, default=0.5)
    args = ap.parse_args()

    from aniso_tpu import SolverConfig
    from aniso_tpu.solver.operator import TransportSolver
    from aniso_tpu.parallel.api import make_mesh, sharded_solver, shard_field
    from aniso_tpu.parallel.inspect import compiled_collective_stats
    from aniso_tpu.fmm.smooth import m2l_cache_bytes

    cfg = SolverConfig(
        domain_size=args.sz, quad_rule=args.deg, kernel_size=1, g=args.g,
        sing_rule=8, np_cheb=args.np_cheb, dtype="float32",
        restart=args.iters, max_iter=args.iters, tol=1e-12,
    )
    t0 = time.time()
    solver = TransportSolver(cfg, backend="fmm")
    grid = solver.grid
    sig_s = 16 * 0.5 * (1 - np.cos(2 * np.pi * grid.nodes_x))
    solver.set_coeff(sig_s, sig_s + 0.2)
    set_coeff_s = time.time() - t0
    print(f"set_coeff {set_coeff_s:.0f} s", flush=True)

    reprs = {
        int(lv): ("factored" if isinstance(v, dict) else "dense")
        for lv, v in solver._caches["m2l_E"].items()
    }
    q = np.exp(
        -25 * ((grid.nodes_x - 0.5) ** 2 + (grid.nodes_y - 0.5) ** 2)
    ).astype(np.float32)
    u = jnp.asarray(q)

    # single-device reference matvec (same host, unsharded)
    t0 = time.time()
    ref = np.asarray(solver.apply_mode(0, u))
    print(f"single-device matvec compile+run {time.time()-t0:.0f} s",
          flush=True)

    mesh = make_mesh(N_DEV)
    apply_fn, caches, mode_statics = sharded_solver(solver, mesh)
    u_sh = shard_field(mesh, u)
    sigma_sh = shard_field(mesh, solver.sigma_s)

    # per-device footprint of the sharded caches
    per_dev = {}
    for leaf in jax.tree_util.tree_leaves((caches, mode_statics)):
        for sh in leaf.addressable_shards:
            d = str(sh.device)
            per_dev[d] = per_dev.get(d, 0) + int(
                np.prod(sh.data.shape)) * sh.data.dtype.itemsize
    per_dev_mb = {d: round(b / 1e6, 1) for d, b in sorted(per_dev.items())}

    t0 = time.time()
    out = jax.block_until_ready(apply_fn(caches, mode_statics[0], 0, u_sh))
    t_compile = time.time() - t0
    t0 = time.time()
    out = jax.block_until_ready(apply_fn(caches, mode_statics[0], 0, u_sh))
    t_warm = time.time() - t0
    rel = float(np.linalg.norm(np.asarray(out) - ref)
                / np.linalg.norm(ref))
    print(f"sharded matvec: compile {t_compile:.0f} s, warm {t_warm:.2f} s, "
          f"rel-vs-single {rel:.2e}", flush=True)

    # collective traffic of the compiled sharded matvec (the persistent
    # compile cache makes this second compile of the same program cheap)
    lowered = apply_fn.lower(caches, mode_statics[0], 0, u_sh)
    stats = compiled_collective_stats(lowered.compile())

    rec = {
        "config": "BASELINE config 5 (shape validation on a virtual mesh)",
        "sz": args.sz, "deg": args.deg, "np_cheb": args.np_cheb,
        "g": args.g, "nodes": grid.n_nodes,
        "mesh": {ax: int(n) for ax, n in mesh.shape.items()},
        "backend": "cpu-virtual (8 devices on 2 cores; wall times measure "
                   "oversubscription, not the design)",
        "level_repr": reprs,
        "set_coeff_s": round(set_coeff_s, 1),
        "e_cache_mb_total": round(
            (m2l_cache_bytes(solver._caches["m2l_E"])
             + solver._caches["near_E"].size
             * solver._caches["near_E"].dtype.itemsize) / 1e6, 1),
        "per_device_cache_mb": per_dev_mb,
        "sharded_matvec_rel_vs_single_device": rel,
        "sharded_matvec_compile_s": round(t_compile, 1),
        "sharded_matvec_warm_s": round(t_warm, 2),
        "collective_counts": dict(stats.counts),
        "collective_bytes_per_shard": dict(stats.bytes),
    }
    with open(RESULTS, "w") as f:      # partial record survives a crash
        json.dump(rec, f, indent=1)

    # a few sharded GMRES iterations on the full forward operator
    from aniso_tpu.solver.gmres import gmres

    # caches ride as jit ARGUMENTS (closure capture would bake GBs of
    # constants into the program)
    @jax.jit
    def solve_step(cch, ms0, sig, u0):
        def matvec(v):
            return v - apply_fn(cch, ms0, 0, sig * v)
        b = apply_fn(cch, ms0, 0, u0)
        return gmres(matvec, b, restart=args.iters, max_iter=args.iters,
                     tol=1e-12)

    t0 = time.time()
    res = solve_step(caches, mode_statics[0], sigma_sh, u_sh)
    jax.block_until_ready(res.x)
    t_gmres = time.time() - t0
    print(f"{int(res.iterations)} sharded GMRES iterations in {t_gmres:.0f} s"
          f" (compile incl.), residual estimate {float(res.residual):.3e}",
          flush=True)

    rec.update({
        "gmres_iterations": int(res.iterations),
        "gmres_residual_estimate": float(res.residual),
        "gmres_wall_s_incl_compile": round(t_gmres, 1),
    })
    with open(RESULTS, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec, indent=1))


if __name__ == "__main__":
    main()
