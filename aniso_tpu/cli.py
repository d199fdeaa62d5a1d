"""Command-line front end (role of the reference CLI, main.cpp:7-149).

`aniso-tpu run data.cfg` reproduces the reference binary's end-to-end flow:
config banner, solver build, the same default coefficient/source fields
(main.cpp:29-46), phase-timed setup, warm start from result.csv
(main.cpp:138-140), GMRES solve, and points.csv/result.csv output
(main.cpp:143-146) — all on the JAX solver.

Extra subcommands the reference lacks:
  `aniso-tpu info`        — device/mesh report
  `aniso-tpu checkpoint`  — inspect a solver checkpoint
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _banner(cfg) -> str:
    # role of config::print (utility/config.cpp:46-53)
    lines = ["========= aniso-tpu configuration ========="]
    for k, v in cfg.to_dict().items():
        lines.append(f"  {k:<22} = {v}")
    lines.append("=" * 43)
    return "\n".join(lines)


def default_fields(grid):
    """The reference CLI's built-in fields (main.cpp:29-46)."""
    x, y = grid.nodes_x, grid.nodes_y
    charge = np.exp(-25.0 * ((x - 0.5) ** 2 + (y - 0.5) ** 2))
    sigma_s = 16.0 * 0.5 * (1.0 - np.cos(2.0 * np.pi * x))
    sigma_t = sigma_s + 0.2
    return charge, sigma_s, sigma_t


def cmd_run(args) -> int:
    import jax
    import jax.numpy as jnp
    from .core.config import load_cfg
    from .solver.operator import TransportSolver
    from .utils.profiler import Profiler
    from .utils.io import (
        write_result_csv, write_points_csv, load_result_csv,
        save_checkpoint,
    )
    from .utils.logging import log

    if args.distributed:
        # must run before any other jax use so every host sees the global
        # device set (SURVEY section 7 stage 6)
        from .parallel.distributed import init as dist_init
        dist_init(args.coordinator, args.num_processes, args.process_id)
    from .utils.compile_cache import setup_compile_cache

    setup_compile_cache()

    cfg = load_cfg(args.config)
    if args.dtype:
        cfg.dtype = args.dtype
    if args.refine:
        cfg.dtype = "float32"
        cfg.refine = True
        jax.config.update("jax_enable_x64", True)
    if args.tol is not None:
        cfg.tol = args.tol
    if args.max_iter is not None:
        cfg.max_iter = args.max_iter
    if jax.process_index() == 0:
        print(_banner(cfg))

    timer = Profiler()
    backend = args.backend
    timer.tic("build solver")
    solver = TransportSolver(cfg, backend=backend)
    timer.toc()
    grid = solver.grid

    charge, sigma_s, sigma_t = default_fields(grid)

    # interpolation + singular precompute + kernel caches (main.cpp:48-76)
    timer.tic("set coefficients (caches)")
    solver.set_coeff(sigma_s, sigma_t)
    timer.toc()

    x0 = None
    warm = load_result_csv(args.result, n=grid.n_nodes)
    if warm is not None:
        log.info(f"warm start from {args.result}")
        N = cfg.kernel_size
        # result.csv is the mode-0 solution (main.cpp:138-140); higher
        # modes start from zero (tiling mode 0 into them would be a
        # strictly worse initial guess than zero)
        x0 = (
            jnp.zeros((N,) + grid.nodes_x.shape, dtype=solver.dtype)
            .at[0]
            .set(
                jnp.asarray(warm, dtype=solver.dtype).reshape(
                    grid.nodes_x.shape
                )
            )
        )

    N = cfg.kernel_size
    q = np.zeros((N,) + grid.nodes_x.shape)
    q[0] = charge  # isotropic source: only mode 0 charged (demo.m:23-30)

    precond = None
    if cfg.precdn.upper() == "DSA":
        from .solver.dsa import DsaPreconditioner
        timer.tic("build DSA preconditioner")
        precond = DsaPreconditioner(solver)
        timer.toc()

    timer.tic("GMRES solve")
    res = solver.solve(jnp.asarray(q), x0=x0, precond=precond)
    jax.block_until_ready(res.x)
    timer.toc()

    ok = bool(res.converged)
    print(
        f"GMRES {'CONVERGED' if ok else 'NOT CONVERGED'}: "
        f"relres={float(res.residual):.3e} iters={int(res.iterations)}"
    )

    if cfg.io:
        x_mode0 = np.asarray(res.x).reshape((N, -1))[0]
        write_points_csv(grid.nodes_x, grid.nodes_y, args.points)
        write_result_csv(x_mode0, args.result)
        print(f"wrote {args.points}, {args.result}")
    if args.checkpoint:
        save_checkpoint(
            args.checkpoint, x=np.asarray(res.x), config=cfg.to_dict(),
            sigma_s=sigma_s, sigma_t=sigma_t,
            residual=float(res.residual), iterations=int(res.iterations),
        )
        print(f"wrote checkpoint {args.checkpoint}")

    print(timer.report())
    return 0 if ok else 1


def cmd_info(args) -> int:
    import jax
    devs = jax.devices()
    info = {
        "backend": jax.default_backend(),
        "device_count": len(devs),
        "devices": [str(d) for d in devs],
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
    }
    print(json.dumps(info, indent=2))
    return 0


def cmd_checkpoint(args) -> int:
    from .utils.io import load_checkpoint
    ck = load_checkpoint(args.path)
    if ck is None:
        print(f"no checkpoint at {args.path}", file=sys.stderr)
        return 1
    meta = {
        k: (list(v.shape) if hasattr(v, "shape") else v)
        for k, v in ck.items()
    }
    print(json.dumps(meta, indent=2, default=str))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="aniso-tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    run = sub.add_parser("run", help="end-to-end solve from a data.cfg")
    run.add_argument("config", help="reference-format data.cfg path")
    run.add_argument("--backend", default="fmm", choices=["fmm", "dense"])
    run.add_argument("--dtype", default=None, choices=["float32", "float64"])
    run.add_argument("--tol", type=float, default=None)
    run.add_argument("--max-iter", type=int, default=None)
    run.add_argument("--points", default="points.csv")
    run.add_argument("--result", default="result.csv")
    run.add_argument("--checkpoint", default=None)
    run.add_argument(
        "--refine", action="store_true",
        help="mixed-precision refinement: f32 inner GMRES + f64 residuals",
    )
    run.add_argument(
        "--distributed", action="store_true",
        help="initialize jax.distributed (one process per GPU host)",
    )
    run.add_argument("--coordinator", default=None,
                     help="coordinator host:port (multi-host)")
    run.add_argument("--num-processes", type=int, default=None)
    run.add_argument("--process-id", type=int, default=None)
    run.set_defaults(fn=cmd_run)

    info = sub.add_parser("info", help="JAX device/mesh report")
    info.set_defaults(fn=cmd_info)

    ck = sub.add_parser("checkpoint", help="inspect a checkpoint file")
    ck.add_argument("path")
    ck.set_defaults(fn=cmd_checkpoint)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
