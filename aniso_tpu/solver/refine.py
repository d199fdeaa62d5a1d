"""Mixed-precision iterative refinement: f32 inner GMRES, f64 residuals.

The reference solves everything in f64 to 1e-12 (bbfmm/utils.h:68,
main.cpp:141).  Classical Wilkinson refinement gets f64 accuracy from an
f32 fast path: f64 is needed only to *evaluate residuals*, one corrected
matvec per round, while the Krylov iteration stays in f32, whose E caches
take half the device memory and bandwidth of f64.  Whether this beats a
native f64 solve (`dtype="float64"`) is measured per configuration
(ROADMAP D4).  Compiled, one f64 residual matvec of the 512^2 refined
solve took 0.045 s beside 0.157 s for its 17-iteration f32 inner solve
(NVIDIA H100 80GB HBM3 at 400 W; chip_smoke.py P3 prints the phases).

    x_0 = 0
    repeat:  r_k = b - A x_k           (f64 operator, f64 caches)
             solve A d = r_k / |r_k|   (f32 GMRES to its ~1e-6 floor)
             x_{k+1} = x_k + |r_k| d   (f64 update)

Each round contracts the true residual by the inner solve's achievable
relative residual (~2e-6 at f32), so two rounds reach ~1e-12 -- the
reference's own target -- and the loop self-terminates on stall at the
f64 operator's floor.

Requires `jax.config.update("jax_enable_x64", True)` and a solver built
with `SolverConfig(refine=True, dtype="float32")`: set_coeff then builds
the attenuation caches once in f64 and casts (correct rounding) to f32
for the fast path.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.logging import log


class RefinedResult(NamedTuple):
    x: jnp.ndarray
    residual: float            # true f64 relative residual |b - A x| / |b|
    iterations: int            # total inner (f32) matvec count
    converged: bool
    refinements: int           # number of inner solves performed
    history: Tuple[float, ...]  # true relative residual before each round
    phases: Optional[dict] = None  # wall-clock breakdown (rhs64 / f64
    #   residual matvecs / inner f32 solves / f64 updates), host-timed
    #   with every step forced to completion


def refined_solve(
    solver,
    charge,
    x0=None,
    precond=None,
    max_refine: int = 10,
    inner_tol: Optional[float] = None,
) -> RefinedResult:
    """Solve (I - K sigma_s) x = K q to cfg.tol using refinement.

    `solver` is a TransportSolver with cfg.refine=True (fmm backend);
    the inner f32 solve reuses solver.forward / the preconditioner, the
    outer residual uses the f64 twin operator (solver._forward64).
    """
    import time as _time

    cfg = solver.cfg
    tol = cfg.tol
    if inner_tol is None:
        # f32 Givens-estimate floor is ~5e-7; the achieved *true* inner
        # residual is then ~2e-6, which is the per-round contraction
        inner_tol = max(tol, 1e-6)
    phases = {"rhs64_s": 0.0, "forward64_s": [], "inner_s": [],
              "inner_iters": [], "update_s": 0.0}

    N = cfg.kernel_size
    shape = (N,) + solver.grid.nodes_x.shape
    # the f64 state (b, x, r) lives with the f64 twin operator: on the
    # device itself for refine_twin='device' (no host round-trips at all
    # -- the normalized residual is a dtype cast on the device), or on the
    # host CPU backend for refine_twin='host' (only the normalized f32
    # residual crosses per round, and the correction comes back)
    twin_dev = solver._twin_device
    acc = jax.devices()[0]
    q = jax.device_put(
        np.asarray(charge, np.float64).reshape(shape), twin_dev
    )
    t0 = _time.perf_counter()
    b = solver._rhs64(q)
    bnorm = float(jnp.linalg.norm(b))
    phases["rhs64_s"] = round(_time.perf_counter() - t0, 3)
    if bnorm == 0.0:
        return RefinedResult(jnp.zeros(shape, jnp.float64), 0.0, 0, True, 0, ())

    x = (
        jax.device_put(jnp.zeros(shape, jnp.float64), twin_dev)
        if x0 is None
        else jax.device_put(
            np.asarray(x0, np.float64).reshape(shape), twin_dev
        )
    )
    total_inner = 0
    history = []
    rel = 1.0
    for k in range(max_refine):
        # starting from zero, r = b exactly: skip one f64 matvec
        t0 = _time.perf_counter()
        r = b if (x0 is None and k == 0) else b - solver._forward64(x)
        rnorm = float(jnp.linalg.norm(r))
        phases["forward64_s"].append(round(_time.perf_counter() - t0, 3))
        rel = rnorm / bnorm
        history.append(rel)
        if rel <= tol:
            log.info(f"refine: converged at round {k}, true resid {rel:.3e}")
            return RefinedResult(x, rel, total_inner, True, k,
                                 tuple(history), phases)
        if k > 0 and rel > 0.25 * history[-2]:
            # stalled at the floor of the f64 operator / f32 contraction;
            # more rounds cannot help
            log.warning(
                f"refine: stalled at {rel:.3e} (round {k}); stopping"
            )
            return RefinedResult(x, rel, total_inner, False, k,
                                 tuple(history), phases)
        t0 = _time.perf_counter()
        r32 = (r / rnorm).astype(jnp.float32)
        if twin_dev is not acc:
            r32 = jax.device_put(np.asarray(r32), acc)
        res = solver.inner_gmres(r32, inner_tol, precond=precond)
        jax.block_until_ready(res.x)
        phases["inner_s"].append(round(_time.perf_counter() - t0, 3))
        phases["inner_iters"].append(int(res.iterations))
        total_inner += int(res.iterations)
        t0 = _time.perf_counter()
        d = res.x.astype(jnp.float64)
        if twin_dev is not acc:
            d = jax.device_put(np.asarray(d), twin_dev)
        x = jax.block_until_ready(x + rnorm * d)
        phases["update_s"] = round(
            phases["update_s"] + _time.perf_counter() - t0, 3
        )
    t0 = _time.perf_counter()
    r = b - solver._forward64(x)
    rel = float(jnp.linalg.norm(r)) / bnorm
    phases["forward64_s"].append(round(_time.perf_counter() - t0, 3))
    history.append(rel)
    return RefinedResult(
        x, rel, total_inner, rel <= tol, max_refine, tuple(history), phases
    )
