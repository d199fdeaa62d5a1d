#!/usr/bin/env python
"""Converged sharded solves on the virtual device mesh.

Runs the FULL f32 GMRES solve to tol under an 8-virtual-device GSPMD
mesh at a multi-level (dense + factored) cache configuration -- the
dense cap override forces the factored leaf exactly as the 512^2+
production regime -- and records iterations, the residual estimate, a
sharded true-residual evaluation, equality against the single-device
solve, and the compiled program's collective traffic.  Wall times on 8
virtual devices time-slicing 2 host cores measure oversubscription and
are recorded only as provenance.

Usage: python benchmarks/sharded_solve.py --sizes 256 [512]
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
    flags = (
        flags + f" --xla_force_host_platform_device_count={N_DEV}"
    ).strip()
if "collective_call_terminate" not in flags:
    # 8 virtual devices time-slice 2 host cores: at 1024^2 a shard can
    # lag far more than the 40 s default behind a collective-permute
    # rendezvous, and XLA's CPU runtime then ABORTS the process
    # (rendezvous.cc "Termination timeout ... exceeded", measured on the
    # first 1024^2 converged-solve attempt).  These are liveness
    # watchdogs, not correctness gates; on the oversubscribed host they
    # must sit above the worst-case shard skew.
    flags += (
        " --xla_cpu_collective_call_warn_stuck_timeout_seconds=600"
        " --xla_cpu_collective_call_terminate_timeout_seconds=14400"
        " --xla_cpu_collective_timeout_seconds=14400"
    )
os.environ["XLA_FLAGS"] = flags

import jax

jax.config.update("jax_platforms", "cpu")
from aniso_tpu.utils.compile_cache import setup_compile_cache  # noqa: E402

setup_compile_cache()

import jax.numpy as jnp
import numpy as np

RESULTS = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "results_sharded_solve.json"
)


def run_one(sz, tol, restart, force_factored_leaf=True, with_ref=True):
    from aniso_tpu import SolverConfig
    from aniso_tpu.solver.operator import TransportSolver
    from aniso_tpu.solver.gmres import gmres
    from aniso_tpu.parallel.api import make_mesh, sharded_solver, shard_field
    from aniso_tpu.parallel.inspect import compiled_collective_stats
    import aniso_tpu.fmm.smooth as smooth

    cfg = SolverConfig(
        domain_size=sz, quad_rule=3, kernel_size=1, g=0.5,
        sing_rule=8, np_cheb=4, dtype="float32",
        restart=restart, max_iter=400, tol=tol,
    )
    saved = smooth._DENSE_E_LEVEL_CAP_BYTES
    if force_factored_leaf:
        # leaf factored, everything else dense: the mixed representation
        # of a sharded build whose leaf does not fit
        smooth._DENSE_E_LEVEL_CAP_BYTES = \
            smooth.fine_dense_level_bytes(
                (1 << (sz.bit_length() - 2)), cfg.np_cheb, 4) // 4 - 1
    try:
        t0 = time.time()
        solver = TransportSolver(cfg, backend="fmm")
        grid = solver.grid
        sig_s = 16 * 0.5 * (1 - np.cos(2 * np.pi * grid.nodes_x))
        solver.set_coeff(sig_s, sig_s + 0.2)
        set_coeff_s = time.time() - t0
    finally:
        smooth._DENSE_E_LEVEL_CAP_BYTES = saved
    reprs = {
        int(lv): ("factored" if isinstance(v, dict) else "dense")
        for lv, v in solver._caches["m2l_E"].items()
    }
    q = np.exp(
        -25 * ((grid.nodes_x - 0.5) ** 2 + (grid.nodes_y - 0.5) ** 2)
    ).astype(np.float32)

    mesh = make_mesh(N_DEV)
    apply_fn, caches, mode_statics = sharded_solver(solver, mesh)
    u = shard_field(mesh, jnp.asarray(q))
    sig_sh = shard_field(mesh, solver.sigma_s)

    @jax.jit
    def solve_full(cch, ms0, sig, u0):
        def matvec(v):
            return v - apply_fn(cch, ms0, 0, sig * v)
        b = apply_fn(cch, ms0, 0, u0)
        res = gmres(matvec, b, restart=restart, max_iter=400, tol=tol)
        # sharded true residual of the returned iterate
        r = b - matvec(res.x)
        true_rel = jnp.linalg.norm(r) / jnp.linalg.norm(b)
        return res, true_rel

    t0 = time.time()
    res, true_rel = solve_full(caches, mode_statics[0], sig_sh, u)
    jax.block_until_ready(res.x)
    wall = time.time() - t0

    # single-device reference solve (same caches, unsharded).  --no-ref
    # skips it at 1024^2, where a second full CPU solve would double an
    # hours-long oversubscribed run; matvec parity at that size is a
    # separate committed artifact (results_1024_virtual.json)
    x_diff = ref_iters = None
    if with_ref:
        ref = solver.solve(q)
        x_diff = float(
            np.linalg.norm(np.asarray(res.x) - np.asarray(ref.x))
            / np.linalg.norm(np.asarray(ref.x))
        )
        ref_iters = int(ref.iterations)

    stats = compiled_collective_stats(
        solve_full.lower(caches, mode_statics[0], sig_sh, u).compile()
    )
    ag_bytes = stats.bytes.get("all-gather", 0)
    return {
        "config": "converged sharded solve (virtual mesh; walls measure "
                  "2-core oversubscription, not the design)",
        "sz": sz, "nodes": grid.n_nodes, "tol": tol, "restart": restart,
        "mesh_devices": N_DEV,
        "level_repr": reprs,
        "set_coeff_s": round(set_coeff_s, 1),
        "iterations": int(res.iterations),
        "residual_estimate": float(res.residual),
        "sharded_true_rel_residual_f32": float(true_rel),
        "converged": bool(res.converged),
        "x_rel_diff_vs_single_device": x_diff,
        "single_device_iterations": ref_iters,
        "collective_counts": dict(stats.counts),
        "collective_bytes_per_shard": dict(stats.bytes),
        "all_gather_bytes": int(ag_bytes),
        "solve_wall_s_provenance_only": round(wall, 1),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="+", default=[256])
    ap.add_argument("--tol", type=float, default=1e-7)
    ap.add_argument("--restart", type=int, default=40)
    ap.add_argument("--no-ref", action="store_true")
    args = ap.parse_args()

    all_recs = []
    if os.path.exists(RESULTS):
        with open(RESULTS) as f:
            all_recs = json.load(f)
    for sz in args.sizes:
        try:
            rec = run_one(sz, args.tol, args.restart,
                          with_ref=not args.no_ref)
        except Exception as e:
            rec = {"sz": sz, "error": f"{type(e).__name__}: {e}"}
        print(json.dumps(rec), flush=True)
        all_recs = [r for r in all_recs if r.get("sz") != sz] + [rec]
        with open(RESULTS, "w") as f:
            json.dump(all_recs, f, indent=1)


if __name__ == "__main__":
    main()
