"""The corrected transport operator and the end-to-end solver facade.

Composition per corrected mode-m matvec (reference main.cpp:78-119,
AnisoWrapper.cpp:92-136):

  K_m u = (1/2pi) [ smooth_m(w u) + real_m(w u) + NearStencil_m u ]

Forward operators:
  single mode (main.cpp:125-136):   A x = x - K_0(sigma_s x)
  multi mode  (aniso.m:139-156):    (A u)_i = u_i - sum_j chi_|j| K_|i-j|(sigma_s u_|j|)
  rhs         (aniso.m:121-137):    rhs_i = sum_j K_|i-j|(q_|j|)

Backends: 'dense' materializes the all-pairs matrices (exact; for validation
and small grids), 'fmm' uses the implicit-quadtree Chebyshev fast path.

set_coeff builds *mode-independent* attenuation caches
(E tensors, fmm.smooth) once; per-mode kernels are tiny static factor tables
folded in at apply time.  The multi-mode forward/rhs are ONE compiled
program each: all (charge, mode) translations share the up sweep and V-list
gathers (fmm.apply.fmm_apply_all_modes), and the mode coupling
sum_j chi_|j| K_|i-j| is a static (N, N, D) combination tensor -- unlike the
reference MATLAB path, which crosses the MEX boundary N*(2N-1) times per
GMRES iteration (aniso.m:141-156).

compat_global_basis (the reference's global-coordinate basis evaluation
quirk, KernelFactory.cpp:180-205) is supported by BOTH backends via the
exact per-square coefficient transform ops.compat.to_local_equivalent --
the fast path stays translation invariant.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.config import SolverConfig
from ..core.geometry import Grid, make_grid
from ..ops import dense as dense_ops
from ..ops.compat import to_local_equivalent
from ..ops.fields import project, evaluate_at_nodes
from ..ops.near import build_near_stencil
from ..utils.logging import log
from .gmres import gmres, GmresResult


def _mode_coupling(N: int, chi: np.ndarray, weighted: bool) -> np.ndarray:
    """C[i, a, d] such that out_i = sum_{a,d} C[i,a,d] K_d(u_a).

    Encodes the reference mode loops (aniso.m:121-156): j runs over
    -(N-1)..N-1 with a = |j|, d = |i - j|; `weighted` multiplies chi_|j|
    (forward/mforward) -- rhs uses chi = 1.
    """
    D = 2 * N - 1
    C = np.zeros((N, N, D))
    for i in range(N):
        for j in range(-(N - 1), N):
            w = chi[abs(j)] if weighted else 1.0
            C[i, abs(j), abs(i - j)] += w
    return C


class TransportSolver:
    """Facade playing the role of reference `Aniso` + `aniso.m` orchestration.

    Parameters mirror Aniso(domain, quadRule, kernelSize, g, singRule, np,
    maxLevel) (Aniso.h:14-15) through SolverConfig.
    """

    def __init__(self, cfg: SolverConfig, backend: str = "dense"):
        cfg.validate()
        self.cfg = cfg
        self.grid = make_grid(cfg.domain_size, cfg.quad_rule)
        self.n_modes = 2 * cfg.kernel_size - 1
        self.backend_name = backend
        # float64 silently degrades to float32 when x64 is disabled; resolve
        # once here so downstream asarray calls don't warn per-array
        requested = jnp.float64 if cfg.dtype == "float64" else jnp.float32
        self.dtype = jax.dtypes.canonicalize_dtype(requested)

        # chi_i = (g^i - g^N) / (1 - g^N)  (KernelFactory.cpp:18-20)
        N, g = cfg.kernel_size, cfg.g
        if g == 0.0:
            chi = np.array([1.0] + [0.0] * (N - 1))
        else:
            chi = (g ** np.arange(N) - g ** N) / (1.0 - g ** N)
        self.chi = chi
        self._C_fwd = jnp.asarray(
            _mode_coupling(N, chi, True), dtype=self.dtype
        )
        self._C_rhs = jnp.asarray(
            _mode_coupling(N, chi, False), dtype=self.dtype
        )

        # geometry-only near stencils per mode; the FMM path omits the
        # real-kernel U list, so its stencil carries no removal term.
        # Kept as host numpy: they are built on the host and uploaded by
        # the consumers that need them.
        self._stencils = []
        self._duffys = []
        for m in range(self.n_modes):
            s, d = build_near_stencil(
                self.grid, m, cfg.sing_rule, cfg.compat_global_basis,
                include_removal=(backend == "dense"),
            )
            self._stencils.append(np.asarray(s))
            self._duffys.append(None if d is None else np.asarray(d))

        self._k_real = None
        self._k_smooth = None
        self.sigma_s = None
        self.sigma_t = None
        self.sigma_t_coeff = None
        self._caches = None

        if cfg.refine:
            if backend != "fmm":
                raise NotImplementedError(
                    "refine=True needs the fmm backend (dense runs f64 as-is)"
                )
            if jax.dtypes.canonicalize_dtype(jnp.float64) != jnp.float64:
                raise RuntimeError(
                    "refine=True needs jax.config.update('jax_enable_x64', "
                    "True) before solver construction"
                )

        if backend == "fmm":
            from ..fmm.structure import tree_config
            from ..fmm.apply import build_fmm_static, build_mode_static

            self._tcfg = tree_config(cfg.domain_size, cfg.max_level)
            self._fmm_static = build_fmm_static(
                self.grid, cfg.np_cheb, dtype=self.dtype
            )

            def _statics_for(dtype):
                out = []
                for m in range(self.n_modes):
                    ms = build_mode_static(
                        self.grid, self._tcfg, cfg.np_cheb, m,
                        self._stencils[m], dtype=dtype,
                    )
                    if self._duffys[m] is not None:
                        # (sz, sz, nq, nq) -> (nq, nq, sz, sz): spatial
                        # dims last, like near_E (fmm.smooth.build_near_E)
                        ms["duffy"] = jnp.asarray(
                            self._duffys[m].transpose(2, 3, 0, 1), dtype=dtype
                        )
                    out.append(ms)
                return out

            self._mode_statics = _statics_for(self.dtype)
            if cfg.refine:
                # f64 twin of the operator for outer residuals
                # (solver.refine).  refine_twin='device' (default) keeps
                # the f64 caches on the device -- fine levels in the
                # per-offset recompute form, so the footprint next to the
                # f32 fast path stays small -- and runs the 2-4 residual
                # matvecs per solve there.  refine_twin='host' is the
                # numpy/BLAS twin on the host CPU backend, kept as the
                # oracle (SURVEY section 7 hard part (b)).
                self._cpu = jax.devices("cpu")[0]
                self._twin_device = (
                    self._cpu if cfg.refine_twin == "host"
                    else jax.devices()[0]
                )
                with jax.default_device(self._twin_device):
                    self._fmm_static64 = build_fmm_static(
                        self.grid, cfg.np_cheb, dtype=jnp.float64
                    )
                    self._mode_statics64 = _statics_for(jnp.float64)
                    self._C_fwd64 = jnp.asarray(
                        _mode_coupling(N, chi, True), dtype=jnp.float64
                    )
                    self._C_rhs64 = jnp.asarray(
                        _mode_coupling(N, chi, False), dtype=jnp.float64
                    )
            self._make_fmm_jits()
        elif backend != "dense":
            raise NotImplementedError(backend)

    def _make_fmm_jits(self):
        from ..fmm.apply import fmm_apply_mode, fmm_apply_all_modes

        leaf = self._tcfg.leaf_level
        static = self._fmm_static
        N = self.cfg.kernel_size
        shape = (N,) + self.grid.nodes_x.shape

        def apply_one(caches, ms, u, m):
            return fmm_apply_mode(leaf, static, caches, ms, m, u)

        self._apply_jit = {
            m: jax.jit(functools.partial(apply_one, m=m))
            for m in range(self.n_modes)
        }

        def all_modes(st, caches, mode_statics, u):
            return fmm_apply_all_modes(leaf, st, caches, mode_statics, u)

        # `st` (the P2M/M2M/L2T tables) rides as a jit argument so one
        # traced function serves both the f32 fast path and the f64
        # refinement twin -- and large arrays never bake into the HLO
        # as constants.  The C[i, a, d] coupling is applied as an
        # ACCUMULATION over the charge index a (and per-mode list
        # entries d), never as one einsum over a stacked
        # (N, D, sz, sz, nq) tensor: the stack would hold all N*D mode
        # sweeps live at once, while the accumulated form keeps one
        # charge's D sweeps + the (N, ...) output live.  The charges are
        # a lax.scan, so the D-mode sweep is compiled once rather than
        # unrolled N times (unrolled, the N=5 128^2 forward took minutes
        # to compile for the GPU).
        def _coupled(st, caches, mode_statics, C, v):
            def one_charge(out, xs):
                Ca, va = xs                     # C[:, a, :], v[a]
                Ka = all_modes(st, caches, mode_statics, va)
                return out + sum(
                    Ca[:, d][:, None, None, None] * Kd[None]
                    for d, Kd in enumerate(Ka)
                ), None

            out, _ = jax.lax.scan(
                one_charge, jnp.zeros_like(v), (jnp.moveaxis(C, 1, 0), v)
            )
            return out

        def forward_impl(st, caches, mode_statics, C_fwd, sigma_s, u):
            u = u.reshape(shape)
            v = sigma_s[None] * u
            return u - _coupled(st, caches, mode_statics, C_fwd, v)

        def rhs_impl(st, caches, mode_statics, C_rhs, q):
            q = q.reshape(shape)
            return _coupled(st, caches, mode_statics, C_rhs, q)

        self._forward_impl_jit = jax.jit(forward_impl)
        self._rhs_impl_jit = jax.jit(rhs_impl)

        # the whole restarted GMRES as ONE jitted program with the caches
        # as ARGUMENTS: calling gmres() eagerly traces its lax.while_loop
        # with the operator closure's cache arrays captured as lowered
        # CONSTANTS (GBs at 512^2 -- jax warns) and the solve then pays
        # per-call constant handling.  As args, the caches are ordinary
        # parameters of the compiled program.
        def gmres_impl(st, caches, mode_statics, C_fwd, sigma_s, b, x0,
                       tol):
            from .gmres import gmres

            fwd = functools.partial(
                forward_impl, st, caches, mode_statics, C_fwd, sigma_s
            )
            return gmres(
                fwd, b, x0, restart=self.cfg.restart,
                max_iter=self.cfg.max_iter, tol=tol,
            )

        self._gmres_jit = jax.jit(gmres_impl)

    def _forward64(self, u: jnp.ndarray) -> jnp.ndarray:
        """f64 twin of forward() for refinement residuals (solver.refine)."""
        return self._forward_impl_jit(
            self._fmm_static64, self._caches64, self._mode_statics64,
            self._C_fwd64, self._sigma_s64, u,
        )

    def _rhs64(self, q: jnp.ndarray) -> jnp.ndarray:
        return self._rhs_impl_jit(
            self._fmm_static64, self._caches64, self._mode_statics64,
            self._C_rhs64, q,
        )

    # -- coefficient setting (reference AnisoWrapper 'setCoeff' + 'cache') --

    def set_coeff(self, sigma_s: np.ndarray, sigma_t: np.ndarray):
        """sigma_s / sigma_t: nodal fields shaped (sz, sz, nq) (or flat).

        Triggers the sigma-dependent precompute (the reference's
        interpolation + cache passes, AnisoWrapper.cpp:46-90).  All caches
        are mode-independent E tensors; cost does not scale with kernelSize.
        """
        g = self.grid
        from ..core.geometry import project_field
        from ..ops.fields import evaluate_at_nodes_np

        # release the previous coefficients' caches BEFORE rebuilding:
        # holding both generations doubles the device footprint
        if self._caches is not None or getattr(self, "_caches64", None):
            self._caches = None
            self._caches64 = None
            self._k_real = None
            self._k_smooth = None
            import gc

            gc.collect()

        shape = (g.sz, g.sz, g.nq)
        # the whole sigma pipeline (projection, compat transform, node
        # evaluation) runs on the host in f64: it is tiny, and its inputs
        # and the native coarse-level engine are on the host
        sig_s_np = np.asarray(sigma_s, np.float64).reshape(shape)
        sig_t_np = np.asarray(sigma_t, np.float64).reshape(shape)
        self.sigma_s = jnp.asarray(sig_s_np, dtype=self.dtype)
        self.sigma_t = jnp.asarray(sig_t_np, dtype=self.dtype)
        if self.cfg.refine:
            self._sigma_s64 = jax.device_put(
                np.asarray(sig_s_np, np.float64), self._twin_device
            )
        coeffs_np = project_field(g, sig_t_np)
        self.sigma_t_coeff = jnp.asarray(coeffs_np, dtype=self.dtype)
        # under the reference's global-basis quirk, evaluate with transformed
        # coefficients in the (translation-invariant) local basis
        if self.cfg.compat_global_basis:
            coeffs_np = to_local_equivalent(g, coeffs_np)
        self._coeffs_np = coeffs_np
        sigma_nodes = evaluate_at_nodes_np(g, coeffs_np)

        if self.backend_name == "dense":
            self._k_real = [
                dense_ops.build_dense_real(g, m, dtype=self.dtype)
                for m in range(self.n_modes)
            ]
            self._k_smooth = dense_ops.build_dense_smooth_all(
                g, range(self.n_modes), coeffs_np, sigma_nodes,
                dtype=self.dtype,
            )
        else:
            self._build_fmm_caches(coeffs_np, sigma_nodes)

    def _build_fmm_caches(self, coeffs_np, sigma_nodes):
        from ..fmm.smooth import (
            build_near_E, build_m2l_E, m2l_cache_bytes,
            build_m2l_E_coarse_all, coarse_m2l_levels,
        )

        import time as _time

        g = self.grid
        w_glob = g.w2d * 0.25 * g.dx * g.dx
        phases = {}

        # coarse-level E is f64 work shared by the f32 cache (on-device
        # cast) and the f64 twin, built ONCE: dgemm-eligible levels on
        # the device, per-pair levels on the host native engine
        # overlapping the async device dispatch.  The host twin keeps the
        # all-host oracle path (its caches must live on the CPU backend).
        coarse_np = None
        if coarse_m2l_levels(self._tcfg):
            t0 = _time.time()
            allow_dev = not (
                self.cfg.refine and self.cfg.refine_twin == "host"
            )
            coarse_np = build_m2l_E_coarse_all(
                g, self._tcfg, self.cfg.np_cheb, coeffs_np,
                allow_device=allow_dev,
            )
            coarse_np = {
                lv: (jax.block_until_ready(v)
                     if isinstance(v, jax.Array) else v)
                for lv, v in coarse_np.items()
            }
            phases["coarse_s"] = _time.time() - t0

        def build(dtype, tag="", virtual=False, budget=None,
                  fine_fallback="factored"):
            """virtual=True stores only the coefficient field + static
            weights for the near field and recompute-level tables; the
            apply re-forms them in-matvec (fmm.apply._level_E /
            _near_apply).  Used for the f64 device twin, whose stored
            form would double the device footprint at 512^2."""
            coeffs_dev = jnp.asarray(coeffs_np, dtype=dtype)
            out = {
                "sigma_w": jnp.asarray(sigma_nodes * w_glob, dtype=dtype),
            }
            t0 = _time.time()
            if virtual:
                from ..fmm.smooth import near_weights_np

                # grid.dx folded in here (the weights are in cell units),
                # so the in-matvec re-forming needs no scale factor and
                # stays correct for any domain scaling
                out["near_W"] = jnp.asarray(
                    near_weights_np(g.deg) * g.dx, dtype=dtype
                )
                out["coeffs"] = coeffs_dev
            else:
                out["near_E"] = jax.block_until_ready(
                    build_near_E(g, coeffs_dev, dtype=dtype)
                )
            phases[f"near_E{tag}_s"] = _time.time() - t0
            t0 = _time.time()
            out["m2l_E"] = jax.block_until_ready(build_m2l_E(
                g, self._tcfg, self.cfg.np_cheb, coeffs_dev,
                dtype=dtype, coeffs_np=coeffs_np, coarse_np=coarse_np,
                store_patch=not virtual, budget_bytes=budget,
                fine_fallback=fine_fallback,
            ))
            # per-offset levels re-form E from the coefficient field
            # inside the matvec (fmm.apply._m2l_translate_offsets)
            if any(
                isinstance(v, dict) and "Wo" in v
                for v in out["m2l_E"].values()
            ):
                out["coeffs"] = coeffs_dev
            phases[f"m2l{tag}_s"] = _time.time() - t0
            return out

        from ..fmm.smooth import device_memory_budget, unsharded_build

        # single-device builds take the fast per-offset recompute fallback;
        # sharded builds (declared by ANISO_UNSHARDED=0 / _UNSHARDED_BUILD)
        # keep the GSPMD-safe factored patch form
        fine_fb = "offsets" if unsharded_build() else "factored"
        budget = device_memory_budget() - self._resident_bytes()
        log.info(f"dense E budget: {budget / 1e9:.2f} GB")

        t0 = _time.time()
        caches = jax.block_until_ready(
            build(self.dtype, budget=budget, fine_fallback=fine_fb)
        )
        phases["device_build_s"] = _time.time() - t0
        if self.cfg.refine and self.cfg.refine_twin == "device":
            # f64 twin on the device: coarse levels dense f64 (shared
            # with the f32 build), ALL fine levels in the per-offset
            # recompute form (budget=0) -- MBs resident instead of the
            # factored W64 + patch form, and ~6x fewer re-form flops per
            # residual sweep than factored.
            t0 = _time.time()
            self._caches64 = jax.block_until_ready(
                build(jnp.float64, "64", virtual=True, budget=0,
                      fine_fallback="offsets")
            )
            phases["twin_device_s"] = _time.time() - t0
        elif self.cfg.refine:
            # f64 twin built (numpy/BLAS -- zero XLA compiles) and kept on
            # the host CPU backend (see __init__); the accelerator holds
            # only the f32 fast path
            from ..fmm.smooth import build_near_E_np, build_m2l_E_host

            t0 = _time.time()
            with jax.default_device(self._cpu):
                self._caches64 = {
                    "near_E": jnp.asarray(
                        build_near_E_np(g, coeffs_np), dtype=jnp.float64
                    ),
                    "m2l_E": build_m2l_E_host(
                        g, self._tcfg, self.cfg.np_cheb, coeffs_np,
                        coarse_np=coarse_np,
                    ),
                    "sigma_w": jnp.asarray(
                        sigma_nodes * w_glob, dtype=jnp.float64
                    ),
                }
            phases["twin_host_s"] = _time.time() - t0
        self.set_coeff_phases = {k: round(v, 2) for k, v in phases.items()}
        log.info(f"set_coeff phases: {self.set_coeff_phases}")
        mb = (
            m2l_cache_bytes(caches["m2l_E"])
            + caches["near_E"].size * caches["near_E"].dtype.itemsize
        ) / 1e6
        twin = (
            f"; plus a {self.cfg.refine_twin}-resident f64 twin"
            if self.cfg.refine else ""
        )
        log.info(
            f"fmm E caches: {mb:.1f} MB (mode-independent; "
            f"{self.n_modes} mode(s) share them{twin})"
        )
        self._caches = jax.block_until_ready(caches)

    def _resident_bytes(self) -> int:
        """Everything resident on the device next to the fast path's E
        levels during a solve: the near-field E, the mode tables, the
        Krylov basis, the f64 device twin and an allowance for program
        temporaries.  The E levels get what is left of the device."""
        from ..fmm.smooth import coarse_dense_bytes

        g, cfg = self.grid, self.cfg
        itemsize = jnp.dtype(self.dtype).itemsize
        nfield = g.sz * g.sz * g.nq
        near_bytes = 9 * g.nq * g.nq * nfield * itemsize
        mode_static_bytes = sum(
            int(np.prod(v.shape)) * v.dtype.itemsize
            for ms in self._mode_statics
            for v in jax.tree_util.tree_leaves(ms)
        )
        krylov_bytes = (cfg.restart + 1) * cfg.kernel_size * nfield * itemsize
        twin_bytes = 0
        if cfg.refine and cfg.refine_twin == "device":
            # coarse levels dense f64, fine levels per-offset (weights,
            # coefficient field, sigma and the f64 refinement vectors)
            twin_bytes = (
                coarse_dense_bytes(self._tcfg, cfg.np_cheb, 8)
                + 64 * 1024 * 1024
                + 4 * cfg.kernel_size * nfield * 8
            )
        transients = 1024 * 1024 * 1024 + 8 * cfg.kernel_size * nfield * itemsize
        return (near_bytes + mode_static_bytes + krylov_bytes + twin_bytes
                + transients)

    def cache_report(self) -> dict:
        """Footprint accounting (role of Aniso::displayKernelCacheSize,
        Aniso.cpp:19-47 -- but mode-count independent: one E cache serves
        all 2N-1 kernels; the reference stores per-mode FMM caches).

        Returns bytes per cache family, including the f64 refinement twin
        when present."""
        from ..fmm.smooth import m2l_cache_bytes

        def nbytes(a):
            return int(np.prod(a.shape)) * a.dtype.itemsize

        rep = {}
        if self.backend_name == "fmm" and self._caches is not None:
            rep["m2l_E"] = m2l_cache_bytes(self._caches["m2l_E"])
            rep["near_E"] = nbytes(self._caches["near_E"])
            rep["sigma_w"] = nbytes(self._caches["sigma_w"])
            if getattr(self, "_caches64", None) is not None:
                rep["f64_twin"] = m2l_cache_bytes(
                    self._caches64["m2l_E"]
                ) + sum(
                    nbytes(v) for k, v in self._caches64.items()
                    if k != "m2l_E"
                )
            rep["mode_statics"] = sum(
                nbytes(v) for ms in self._mode_statics for v in
                jax.tree_util.tree_leaves(ms)
            )
        elif self._k_smooth is not None:
            rep["dense_smooth"] = sum(nbytes(k) for k in self._k_smooth)
            rep["dense_real"] = sum(nbytes(k) for k in self._k_real)
        rep["total"] = sum(rep.values())
        return rep

    # -- corrected matvec (reference MEX 'mapping') --

    def apply_mode(self, m: int, u: jnp.ndarray) -> jnp.ndarray:
        """K_m u on (sz, sz, nq) charge (AnisoWrapper.cpp:92-136)."""
        if self.backend_name == "fmm":
            if self._caches is None:
                raise RuntimeError("call set_coeff first")
            return self._apply_jit[m](
                self._caches, self._mode_statics[m], u
            )
        if self._k_smooth is None:
            raise RuntimeError("call set_coeff first")
        return dense_ops.dense_apply(
            self._k_smooth[m], self._k_real[m], self._stencils[m],
            self._duffys[m], self.grid, u,
        )

    # -- forward operators --

    def rhs(self, charge: jnp.ndarray) -> jnp.ndarray:
        """Multi-mode rhs (aniso.m:121-137).  charge: (N, sz, sz, nq)."""
        N = self.cfg.kernel_size
        charge = charge.reshape((N,) + self.grid.nodes_x.shape)
        if self.backend_name == "fmm":
            return self._rhs_impl_jit(
                self._fmm_static, self._caches, self._mode_statics,
                self._C_rhs, charge,
            )
        out = []
        for i in range(N):
            acc = jnp.zeros_like(charge[0])
            for j in range(-(N - 1), N):
                acc = acc + self.apply_mode(abs(i - j), charge[abs(j)])
            out.append(acc)
        return jnp.stack(out)

    def forward(self, u: jnp.ndarray) -> jnp.ndarray:
        """(A u)_i = u_i - sum_j chi_|j| K_|i-j|(sigma_s u_|j|)  (aniso.m:139-156)."""
        N = self.cfg.kernel_size
        shape = (N,) + self.grid.nodes_x.shape
        u = u.reshape(shape)
        if self.backend_name == "fmm":
            return self._forward_impl_jit(
                self._fmm_static, self._caches, self._mode_statics,
                self._C_fwd, self.sigma_s, u,
            )
        v = self.sigma_s[None] * u  # (N, sz, sz, nq)
        # T[a][d] = K_d(sigma_s u_a), computed once per needed pair
        needed = {}
        for i in range(N):
            for j in range(-(N - 1), N):
                needed.setdefault((abs(j), abs(i - j)), None)
        for (a, d) in needed:
            needed[(a, d)] = self.apply_mode(d, v[a])
        out = []
        for i in range(N):
            acc = u[i]
            for j in range(-(N - 1), N):
                acc = acc - self.chi[abs(j)] * needed[(abs(j), abs(i - j))]
            out.append(acc)
        return jnp.stack(out)

    def inner_gmres(self, b, tol, x0=None, precond=None) -> GmresResult:
        """GMRES on the corrected forward operator.

        fmm backend, unpreconditioned: the fully-jitted program with the
        caches as arguments (see _make_fmm_jits).  With a preconditioner
        (whose closure state is MB-scale) or the dense backend, the
        eager-traced path.
        """
        N = self.cfg.kernel_size
        shape = (N,) + self.grid.nodes_x.shape
        if self.backend_name == "fmm" and precond is None:
            b = jnp.asarray(b, dtype=self.dtype).reshape(shape)
            x0a = (
                jnp.zeros_like(b) if x0 is None
                else jnp.asarray(x0, dtype=self.dtype).reshape(shape)
            )
            return self._gmres_jit(
                self._fmm_static, self._caches, self._mode_statics,
                self._C_fwd, self.sigma_s, b, x0a, tol,
            )
        return gmres(
            self.forward, b, x0, restart=self.cfg.restart,
            max_iter=self.cfg.max_iter, tol=tol, precond=precond,
        )

    # -- solve (aniso.m:159-173 / main.cpp:138-141) --

    def solve(
        self,
        charge: jnp.ndarray,
        x0: Optional[jnp.ndarray] = None,
        precond=None,
    ) -> GmresResult:
        if self.cfg.refine:
            from .refine import refined_solve

            return refined_solve(self, charge, x0=x0, precond=precond)
        N = self.cfg.kernel_size
        shape = (N,) + self.grid.nodes_x.shape
        charge = jnp.asarray(charge, dtype=self.dtype).reshape(shape)
        b = self.rhs(charge)
        return self.inner_gmres(b, self.cfg.tol, x0=x0, precond=precond)
