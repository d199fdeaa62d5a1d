#!/usr/bin/env python
"""Scaling-efficiency harness over a virtual device mesh.

Runs the GSPMD domain-decomposed corrected matvec on 1/2/4/8 devices,
reports per-device wall time, weak/strong efficiency, and the collective
traffic each mesh size actually emits (bytes + op counts from compiled
HLO).  On the CPU the devices are virtual shards; on a host with several
GPUs the same harness measures NVLink scaling -- the numbers to quote
from a CPU run are the collective-byte counts (exact, hardware-
independent) and the structure of the scaling curve.

Usage: XLA_FLAGS=--xla_force_host_platform_device_count=8 \
       JAX_PLATFORMS=cpu python benchmarks/scaling_virtual.py --sz 64
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

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import jax.numpy as jnp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sz", type=int, default=64)
    ap.add_argument("--deg", type=int, default=2)
    ap.add_argument("--np-cheb", type=int, default=4)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    from aniso_tpu import SolverConfig
    from aniso_tpu.solver.operator import TransportSolver
    from aniso_tpu.parallel.api import make_mesh, shard_field, sharded_solver
    from aniso_tpu.parallel.inspect import compiled_collective_stats

    cfg = SolverConfig(
        domain_size=args.sz, quad_rule=args.deg, kernel_size=1, g=0.9,
        sing_rule=4, np_cheb=args.np_cheb, dtype="float32",
    )
    s = TransportSolver(cfg, backend="fmm")
    g = s.grid
    sig = 8 * 0.5 * (1 - np.cos(2 * np.pi * g.nodes_x))
    s.set_coeff(sig, sig + 0.2)
    u_host = np.random.default_rng(0).random(g.nodes_x.shape + (g.nq,))[..., 0:g.nq]
    u_host = np.random.default_rng(0).random((g.sz, g.sz, g.nq)).astype(np.float32)

    n_avail = len(jax.devices())
    rows = []
    t1 = None
    for n in [1, 2, 4, 8, 16]:
        if n > n_avail:
            break
        mesh = make_mesh(n)
        apply_fn, caches, mode_statics = sharded_solver(s, mesh)
        u = shard_field(mesh, jnp.asarray(u_host))
        compiled = apply_fn.lower(caches, mode_statics[0], 0, u).compile()
        st = compiled_collective_stats(compiled)

        K = args.reps
        out = apply_fn(caches, mode_statics[0], 0, u)
        out.block_until_ready()
        t0 = time.perf_counter()
        for _ in range(K):
            out = apply_fn(caches, mode_statics[0], 0, out)
        out.block_until_ready()
        dt = (time.perf_counter() - t0) / K
        if t1 is None:
            t1 = dt
        rows.append({
            "devices": n,
            "matvec_ms": round(dt * 1e3, 3),
            "strong_scaling_eff": round(t1 / (dt * n), 3),
            "collective_counts": dict(st.counts),
            "collective_bytes": dict(st.bytes),
            "collective_bytes_total": st.total_bytes(),
        })
        print(json.dumps(rows[-1]), flush=True)

    out_path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "results_scaling.json"
    )
    with open(out_path, "w") as f:
        json.dump({
            "sz": args.sz, "deg": args.deg, "np_cheb": args.np_cheb,
            "platform": "virtual-cpu-mesh",
            "note": "N virtual devices time-slice this host's 2 real "
                    "cores: the wall-time/efficiency columns measure "
                    "OVERSUBSCRIPTION, not the design, and must not be "
                    "read as scaling results.  Only the collective "
                    "counts/bytes columns are meaningful here; real "
                    "scaling needs several GPUs (BASELINE config 5).",
            "field_bytes": g.n_nodes * 4,
            "rows": rows,
        }, f, indent=1)
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
