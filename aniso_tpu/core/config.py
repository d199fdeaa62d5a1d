"""Typed solver configuration with a data.cfg-compatible loader.

Replaces the reference's untyped `key = value` string map
(/root/reference/utility/config.{h,cpp}) with a validated dataclass.  The
reference parses `Krylov` and `Precdn` but never reads them
(main.cpp:14-20); we honour them.
"""

from __future__ import annotations

from dataclasses import dataclass, field, asdict
from typing import Optional


@dataclass
class SolverConfig:
    # equation
    kernel_size: int = 1          # number of Fourier modes N (kernels 0..2N-2)
    g: float = 0.95               # Henyey-Greenstein anisotropy
    # domain
    domain_size: int = 64         # sz: squares per direction
    # quadrature
    quad_rule: int = 3            # deg: Gauss points per direction per square
    sing_rule: int = 8            # Duffy Gauss rule
    # fmm
    np_cheb: int = 4              # Chebyshev interpolation order per dim
    max_level: int = 20           # max tree depth (cap; implicit tree is static)
    # krylov
    krylov: str = "GMRES"
    precdn: str = "NONE"          # NONE | DSA
    restart: int = 80             # GMRES restart (reference main.cpp:141)
    max_iter: int = 400
    tol: float = 1e-12
    # io
    io: bool = True
    # numerics
    dtype: str = "float64"        # float32 | float64
    # mixed-precision iterative refinement (solver.refine): f32 inner GMRES
    # + f64 outer residuals; reaches the reference's 1e-12 target with an
    # f32 fast path.  Requires dtype=float32 and jax_enable_x64.
    refine: bool = False
    # where the f64 twin operator for refinement residuals lives:
    #   device -- f64 caches in device memory; the residual matvecs (2-4
    #             per solve) run there.  No host round-trips in the
    #             refine loop.
    #   host   -- numpy/BLAS-built caches on the host CPU backend (kept as
    #             the oracle; minutes per residual at 512^2 on small
    #             hosts).
    refine_twin: str = "device"
    # reference-compat: evaluate per-square Legendre expansions at *global*
    # coordinates like the reference does (KernelFactory.cpp:174-207,
    # :828-860) instead of the mathematically consistent local coordinates.
    compat_global_basis: bool = False

    def validate(self) -> "SolverConfig":
        if self.kernel_size < 1:
            raise ValueError("kernel_size must be >= 1")
        if self.domain_size < 1:
            raise ValueError("domain_size must be >= 1")
        # power-of-two is required only by the implicit quadtree; the dense
        # backend accepts any size.  The real check lives in
        # fmm.structure.tree_config, raised when the fmm backend is chosen.
        if self.quad_rule < 1:
            raise ValueError("quad_rule must be >= 1")
        if self.sing_rule < 1:
            raise ValueError("sing_rule must be >= 1")
        if self.np_cheb < 2:
            raise ValueError("np_cheb must be >= 2")
        if self.krylov.upper() != "GMRES":
            raise ValueError(f"unsupported Krylov solver {self.krylov!r}")
        if self.precdn.upper() not in ("NONE", "DSA", "FFT"):
            # the reference parses Precdn=FFT but never implements it
            # (data.cfg:30, main.cpp:14-20); accept and ignore it likewise
            raise ValueError(f"unsupported preconditioner {self.precdn!r}")
        if self.dtype not in ("float32", "float64"):
            raise ValueError(f"unsupported dtype {self.dtype}")
        if self.refine and self.dtype != "float32":
            raise ValueError(
                "refine=True is the mixed f32-inner/f64-outer mode; "
                "set dtype='float32' (a full-f64 solve needs no refinement)"
            )
        if self.refine_twin not in ("device", "host"):
            raise ValueError(
                f"refine_twin must be 'device' or 'host', got "
                f"{self.refine_twin!r}"
            )
        return self

    def to_dict(self) -> dict:
        return asdict(self)


_KEYMAP = {
    "kernelSize": ("kernel_size", int),
    "g": ("g", float),
    "domainSize": ("domain_size", int),
    "quadRule": ("quad_rule", int),
    "singRule": ("sing_rule", int),
    "np": ("np_cheb", int),
    "maxLevel": ("max_level", int),
    "Krylov": ("krylov", str),
    "Precdn": ("precdn", str),
    "IO": ("io", lambda s: bool(int(s))),
    "restart": ("restart", int),
    "maxIter": ("max_iter", int),
    "tol": ("tol", float),
    "dtype": ("dtype", str),
    "Refine": ("refine", lambda s: bool(int(s))),
    "RefineTwin": ("refine_twin", str),
}


def load_cfg(path: str) -> SolverConfig:
    """Parse a reference-format data.cfg file (utility/config.cpp:17-44)."""
    cfg = SolverConfig()
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if "=" not in line:
                continue
            key, _, value = line.partition("=")
            key = key.strip()
            value = value.strip()
            if key in _KEYMAP:
                attr, conv = _KEYMAP[key]
                setattr(cfg, attr, conv(value))
    return cfg.validate()
