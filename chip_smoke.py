#!/usr/bin/env python
"""Smoke test of the transport solver's main path on one NVIDIA GPU.

    python chip_smoke.py                # phases P1-P5 on one card
    python chip_smoke.py --four-cards   # the sharded 512^2 solve on four

Every phase runs in this one process, at the widths users run, with the
compiled GPU programs:

  P1  reference parity: 128^2 deg 3 g=0.5 f64 FMM solve against the
      reference binary's own output (benchmarks/oracle_128), and 16^2 on
      the dense backend against benchmarks/oracle_16;
  P2  the CLI (`aniso_tpu.cli.main(["run", ...])`) on the reference's
      data.cfg at 64^2, refined f32 and native f64, which must agree;
  P3  512^2 deg 3 g=0.5 heterogeneous sigma, f32 with f64 refinement to
      a true residual of 1e-8, plus the f32-vs-f64 operator gap;
  P4  the demo.m problem (128^2 deg 1 N=5 g=0.8): coupled multi-mode
      forward f32 vs f64, then a refined solve to 1e-8;
  P5  64^2 with the DSA preconditioner, no more iterations than without.

A failed gate raises, so the script exits non-zero with a traceback.  It
also exits non-zero, before any phase, when JAX finds no GPU or the
aniso_tpu package beside it is missing.  The last line of its output is
one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# f32-vs-f64 corrected-operator gap, relative L2 over a random input.  On
# the CPU (true f32 arithmetic) the gap measures 2.2e-7 at 32^2 deg 3 and
# 3.0e-7 at 32^2 deg 1 N=5: it is the f32 rounding of E, exp(-E) and the
# sums.  An f32 contraction run in TF32 (10-bit mantissa) anywhere on the
# path shows ~1e-3.  The gate sits well between the two.
OPERATOR_GAP_GATE = 1e-5

# sharded vs single-card solution, relative L2.  Both are f32 solves to
# 1e-7 that differ only in reduction order; benchmarks/sharded_solve.py
# recorded 7.9e-8 at 512^2 on an 8-device virtual mesh.
SHARDED_GATE = 1e-5


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(*parts) -> None:
    print(*parts, flush=True)


def run_phase(name: str, fn) -> None:
    t0 = time.perf_counter()
    fn()
    say(f"[{name}] done in {time.perf_counter() - t0:.2f} s")
    gc.collect()


def rel_linf(x, ref) -> float:
    return float(np.abs(x - ref).max() / np.abs(ref).max())


def rel_l2(x, ref) -> float:
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


def default_sigma(grid):
    """The reference CLI's heterogeneous coefficients (main.cpp:42-46)."""
    sig_s = 16 * 0.5 * (1 - np.cos(2 * np.pi * grid.nodes_x))
    return sig_s, sig_s + 0.2


def gaussian(grid):
    return np.exp(-25 * ((grid.nodes_x - 0.5) ** 2
                         + (grid.nodes_y - 0.5) ** 2))


def oracle_error(solver, oracle_dir: str) -> float:
    """Relative Linf of the solve against a reference binary's result.csv
    (nodes matched by coordinate, as tests/test_golden_oracle.py does)."""
    ref = np.loadtxt(os.path.join(oracle_dir, "result.csv"))
    pts = np.loadtxt(os.path.join(oracle_dir, "points.csv"))
    g = solver.grid
    solver.set_coeff(*default_sigma(g))
    res = solver.solve(gaussian(g))
    check(bool(res.converged), f"{oracle_dir}: solve did not converge")
    mine = np.stack([g.nodes_x.reshape(-1), g.nodes_y.reshape(-1)], -1)
    order_m = np.lexsort((mine[:, 1], mine[:, 0]))
    order_r = np.lexsort((pts[:, 1], pts[:, 0]))
    check(np.allclose(mine[order_m], pts[order_r], atol=1e-12),
          f"{oracle_dir}: node sets differ")
    perm = np.empty(len(pts), dtype=int)
    perm[order_m] = order_r
    x = np.asarray(res.x).reshape(-1)
    say(f"  iterations {int(res.iterations)} residual "
        f"{float(res.residual):.3e}")
    return rel_linf(x, ref[perm])


def phase_p1():
    from aniso_tpu import SolverConfig
    from aniso_tpu.solver.operator import TransportSolver

    cfg = SolverConfig(domain_size=128, quad_rule=3, kernel_size=1, g=0.5,
                       sing_rule=8, np_cheb=4, tol=1e-10, restart=80,
                       max_iter=400, compat_global_basis=True,
                       dtype="float64")
    err = oracle_error(TransportSolver(cfg, backend="fmm"),
                       os.path.join(HERE, "benchmarks", "oracle_128"))
    say(f"  128^2 fmm f64 vs oracle_128: rel Linf {err:.3e} (gate 1e-3)")
    check(err < 1e-3, f"128^2 oracle error {err:.3e}")

    cfg = SolverConfig(domain_size=16, quad_rule=3, kernel_size=1, g=0.95,
                       sing_rule=8, tol=1e-12, restart=80, max_iter=400,
                       compat_global_basis=True, dtype="float64")
    err = oracle_error(TransportSolver(cfg, backend="dense"),
                       os.path.join(HERE, "benchmarks", "oracle_16"))
    say(f"  16^2 dense f64 vs oracle_16: rel Linf {err:.3e} (gate 1e-2)")
    check(err < 1e-2, f"16^2 oracle error {err:.3e}")


def phase_p2():
    from aniso_tpu.cli import main as cli_main

    cfg_path = os.path.join(HERE, "benchmarks", "oracle_64", "data.cfg")
    results = {}
    with tempfile.TemporaryDirectory() as out:
        for tag, extra in (("refine", ["--refine"]),
                           ("f64", ["--dtype", "float64"])):
            result = os.path.join(out, f"result_{tag}.csv")
            t0 = time.perf_counter()
            rc = cli_main(["run", cfg_path, "--tol", "1e-10", *extra,
                           "--points", os.path.join(out, "points.csv"),
                           "--result", result])
            say(f"  cli --{tag}: exit {rc} in "
                f"{time.perf_counter() - t0:.2f} s")
            check(rc == 0, f"cli run ({tag}) did not converge")
            results[tag] = np.loadtxt(result)
    err = rel_linf(results["refine"], results["f64"])
    say(f"  refined vs native f64 mode 0: rel Linf {err:.3e} (gate 1e-6)")
    check(err < 1e-6, f"refined vs f64 CLI results differ by {err:.3e}")


def operator_gap(solver, seed: int) -> float:
    """Relative L2 gap of the f32 forward operator against its f64 twin
    on one random input."""
    import jax.numpy as jnp

    shape = (solver.cfg.kernel_size,) + solver.grid.nodes_x.shape
    v = np.random.default_rng(seed).standard_normal(shape)
    f32 = np.asarray(solver.forward(jnp.asarray(v, jnp.float32)), np.float64)
    f64 = np.asarray(solver._forward64(jnp.asarray(v, jnp.float64)))
    return rel_l2(f32, f64)


def level_reprs(solver) -> dict:
    return {
        int(lv): ("per-offset" if isinstance(v, dict) and "Wo" in v
                  else "factored" if isinstance(v, dict) else "dense")
        for lv, v in solver._caches["m2l_E"].items()
    }


def gmres_memory_analysis(solver) -> dict:
    """compiled.memory_analysis() of the inner GMRES program at the
    solver's shapes (compiled ahead; the persistent cache then serves
    the solve's own compilation)."""
    import jax.numpy as jnp

    shape = (solver.cfg.kernel_size,) + solver.grid.nodes_x.shape
    b = jnp.zeros(shape, solver.dtype)
    compiled = solver._gmres_jit.lower(
        solver._fmm_static, solver._caches, solver._mode_statics,
        solver._C_fwd, solver.sigma_s, b, b, 1e-6,
    ).compile()
    ma = compiled.memory_analysis()
    return {k: getattr(ma, k) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "alias_size_in_bytes",
        "generated_code_size_in_bytes",
    )}


def refined_solve_report(solver, charge, tol: float) -> None:
    res = solver.solve(charge)
    say(f"  refined solve: converged {res.converged} true residual "
        f"{res.residual:.3e} inner iterations {res.iterations} "
        f"refinements {res.refinements}")
    say(f"  residual history {[f'{h:.3e}' for h in res.history]}")
    say(f"  solve phases {json.dumps(res.phases)}")
    check(bool(res.converged) and res.residual <= tol,
          f"refined solve reached {res.residual:.3e}, needs {tol:.0e}")


def phase_p3():
    import jax
    from aniso_tpu import SolverConfig, native
    from aniso_tpu.solver.operator import TransportSolver

    path = "native-openmp" if native.available() else "jax-chunked"
    say(f"  coarse host levels path: {path}")
    check(path == "native-openmp", "native host engine did not build")
    cfg = SolverConfig(domain_size=512, quad_rule=3, kernel_size=1, g=0.5,
                       sing_rule=8, np_cheb=4, dtype="float32", refine=True,
                       tol=1e-8, restart=80, max_iter=400)
    solver = TransportSolver(cfg, backend="fmm")
    g = solver.grid
    t0 = time.perf_counter()
    solver.set_coeff(*default_sigma(g))
    say(f"  set_coeff {time.perf_counter() - t0:.2f} s, phases "
        f"{json.dumps(solver.set_coeff_phases)}")
    say(f"  level representations {json.dumps(level_reprs(solver))}")
    say(f"  cache bytes {json.dumps(solver.cache_report())}")
    say(f"  inner GMRES memory_analysis "
        f"{json.dumps(gmres_memory_analysis(solver))}")
    refined_solve_report(solver, gaussian(g), cfg.tol)
    gap = operator_gap(solver, seed=0)
    say(f"  f32 vs f64 operator: rel L2 {gap:.3e} "
        f"(gate {OPERATOR_GAP_GATE:.0e})")
    check(gap < OPERATOR_GAP_GATE, f"512^2 operator gap {gap:.3e}")
    stats = jax.devices()[0].memory_stats() or {}
    say(f"  device peak_bytes_in_use {stats.get('peak_bytes_in_use')} "
        f"bytes_limit {stats.get('bytes_limit')}")


def phase_p4():
    from aniso_tpu import SolverConfig
    from aniso_tpu.solver.operator import TransportSolver

    # examples/demo.py defaults: aniso.m:24 Aniso(128, 1, 5, 0.8, 10, 4)
    N = 5
    cfg = SolverConfig(domain_size=128, quad_rule=1, kernel_size=N, g=0.8,
                       sing_rule=10, np_cheb=4, dtype="float32",
                       refine=True, tol=1e-8, restart=80, max_iter=400)
    solver = TransportSolver(cfg, backend="fmm")
    g = solver.grid
    sig_s = np.full_like(g.nodes_x, 20.0)
    solver.set_coeff(sig_s, sig_s + 0.2)
    gap = operator_gap(solver, seed=1)
    say(f"  N=5 coupled forward f32 vs f64: rel L2 {gap:.3e} "
        f"(gate {OPERATOR_GAP_GATE:.0e})")
    check(gap < OPERATOR_GAP_GATE, f"multi-mode operator gap {gap:.3e}")
    q = np.zeros((N,) + g.nodes_x.shape)
    q[0] = gaussian(g)
    refined_solve_report(solver, q, cfg.tol)


def phase_p5():
    from aniso_tpu import SolverConfig
    from aniso_tpu.solver.dsa import DsaPreconditioner
    from aniso_tpu.solver.operator import TransportSolver

    # benchmarks/results_dsa.json case: scattering-dominated, tau ~ 0.3
    cfg = SolverConfig(domain_size=64, quad_rule=2, kernel_size=1, g=0.0,
                       sing_rule=8, np_cheb=4, dtype="float32", tol=1e-6,
                       restart=80, max_iter=200)
    solver = TransportSolver(cfg, backend="fmm")
    g = solver.grid
    sig_s = np.full_like(g.nodes_x, 20.0)
    solver.set_coeff(sig_s, sig_s + 0.2)
    q = gaussian(g)
    plain = solver.solve(q)
    dsa = solver.solve(q, precond=DsaPreconditioner(solver))
    say(f"  iterations: plain {int(plain.iterations)} "
        f"(converged {bool(plain.converged)}), DSA {int(dsa.iterations)} "
        f"(converged {bool(dsa.converged)})")
    check(bool(plain.converged) and bool(dsa.converged),
          "64^2 solve did not converge")
    check(int(dsa.iterations) <= int(plain.iterations),
          "DSA took more iterations than the plain solve")


def phase_four_cards():
    import jax
    import jax.numpy as jnp
    from aniso_tpu import SolverConfig
    from aniso_tpu.parallel.api import make_mesh, shard_field, sharded_solver
    from aniso_tpu.solver.gmres import gmres
    from aniso_tpu.solver.operator import TransportSolver

    check(len(jax.devices()) >= 4, f"needs 4 GPUs, found {len(jax.devices())}")
    mesh = make_mesh(4)
    say(f"  mesh {dict(mesh.shape)}")
    devices = set(mesh.devices.flat)
    # the GMRES of P3 (restart 80), so the single-card program is the one
    # a one-card run has already compiled
    tol, restart = 1e-7, 80
    cfg = SolverConfig(domain_size=512, quad_rule=3, kernel_size=1, g=0.5,
                       sing_rule=8, np_cheb=4, dtype="float32", tol=tol,
                       restart=restart, max_iter=400)
    solver = TransportSolver(cfg, backend="fmm")
    g = solver.grid
    solver.set_coeff(*default_sigma(g))
    say(f"  level representations {json.dumps(level_reprs(solver))}")
    q = gaussian(g).astype(np.float32)

    t0 = time.perf_counter()
    single = solver.solve(q)
    x_ref = np.asarray(single.x).reshape(q.shape)
    say(f"  one card: iterations {int(single.iterations)} residual "
        f"{float(single.residual):.3e} in {time.perf_counter() - t0:.2f} s")
    check(bool(single.converged), "single-card solve did not converge")

    for halo in ("gspmd", "shardmap"):
        apply_fn, caches, mode_statics = sharded_solver(solver, mesh,
                                                        halo=halo)
        u = shard_field(mesh, jnp.asarray(q))
        sig = shard_field(mesh, solver.sigma_s)
        leaves = jax.tree_util.tree_leaves((caches, mode_statics, u, sig))
        off = [x.shape for x in leaves if x.sharding.device_set != devices]
        check(not off, f"{halo}: arrays not on all four cards: {off}")
        split = [x for x in leaves if not x.sharding.is_fully_replicated]
        per_card = sum(s.data.nbytes for x in split
                       for s in x.addressable_shards) / 4
        say(f"  {halo}: {len(leaves)} arrays on all 4 cards, {len(split)} "
            f"split, {per_card / 1e9:.2f} GB of split data per card")

        @jax.jit
        def solve(cch, ms0, sig, u0):
            def matvec(v):
                return v - apply_fn(cch, ms0, 0, sig * v)

            return gmres(matvec, apply_fn(cch, ms0, 0, u0), restart=restart,
                         max_iter=cfg.max_iter, tol=tol)

        t0 = time.perf_counter()
        res = jax.block_until_ready(solve(caches, mode_statics[0], sig, u))
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = jax.block_until_ready(solve(caches, mode_statics[0], sig, u))
        warm = time.perf_counter() - t0
        check(res.x.sharding.device_set == devices,
              f"{halo}: solution not spread over the mesh")
        diff = rel_l2(np.asarray(res.x), x_ref)
        say(f"  {halo}: iterations {int(res.iterations)} residual "
            f"{float(res.residual):.3e} cold {cold:.2f} s warm {warm:.2f} s; "
            f"vs one card rel L2 {diff:.3e} (gate {SHARDED_GATE:.0e})")
        check(bool(res.converged), f"{halo}: sharded solve did not converge")
        check(diff < SHARDED_GATE, f"{halo}: sharded vs single {diff:.3e}")
        del apply_fn, caches, mode_statics, res
        gc.collect()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded 512^2 solve on a 2x2 mesh "
                         "of four GPUs against one card")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        import aniso_tpu
    except ImportError:
        print("chip_smoke: the aniso_tpu package is not beside this script",
              file=sys.stderr)
        return 1
    if os.path.dirname(os.path.dirname(os.path.abspath(
            aniso_tpu.__file__))) != HERE:
        print("chip_smoke: aniso_tpu was imported from outside this "
              "checkout", file=sys.stderr)
        return 1
    jax.config.update("jax_enable_x64", True)
    from aniso_tpu.utils.compile_cache import setup_compile_cache

    say(f"compile cache: {setup_compile_cache()}")
    say(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}")

    if args.four_cards:
        run_phase("four-cards", phase_four_cards)
    else:
        for name, fn in (("P1", phase_p1), ("P2", phase_p2),
                         ("P3", phase_p3), ("P4", phase_p4),
                         ("P5", phase_p5)):
            run_phase(name, fn)
    say(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
