"""ctypes binding to the native host runtime (csrc/aniso_host.cpp).

The library is built lazily with the repo Makefile on first use (g++ is a
hard dependency of the image; no pip packages involved).  Every entry point
has a pure Python/JAX fallback, so `available()` gating is advisory: callers
use the native path when present for host-side cache assembly (the
reference's C++/OpenMP role) and fall back transparently otherwise.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), os.pardir, "csrc")
_CSRC = os.path.normpath(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "csrc")
)
_LIB_PATH = os.path.join(_CSRC, "libaniso_host.so")

_lock = threading.Lock()
_lib = None
_tried = False

_f64p = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")


def _build() -> bool:
    try:
        subprocess.run(
            ["make", "-s"], cwd=_CSRC, check=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, timeout=120,
        )
        return os.path.exists(_LIB_PATH)
    except subprocess.CalledProcessError as e:
        from ..utils.logging import log

        log.warning(f"native host engine did not build: "
                    f"{e.stderr.decode(errors='replace')[-500:]}")
        return False
    except (OSError, subprocess.TimeoutExpired) as e:
        from ..utils.logging import log

        log.warning(f"native host engine did not build: {e}")
        return False


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_CSRC):
            return None
        src = os.path.join(_CSRC, "aniso_host.cpp")
        if not os.path.exists(_LIB_PATH) or (
            os.path.exists(src)
            and os.path.getmtime(src) > os.path.getmtime(_LIB_PATH)
        ):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None

        lib.aniso_attenuation_batch.argtypes = [
            ctypes.c_int, ctypes.c_int, _f64p, _f64p, _f64p, _f64p,
            ctypes.c_int, _f64p, _f64p, ctypes.c_long, _f64p,
        ]
        lib.aniso_attenuation_batch.restype = None
        lib.aniso_smooth_rows.argtypes = [
            ctypes.c_int, ctypes.c_int, _f64p, _f64p, _f64p, _f64p,
            ctypes.c_int, _f64p, _f64p, ctypes.c_int, ctypes.c_long,
            ctypes.c_long, ctypes.c_long, _f64p,
        ]
        lib.aniso_smooth_rows.restype = None
        lib.aniso_write_csv.argtypes = [ctypes.c_char_p, _f64p, ctypes.c_long]
        lib.aniso_write_csv.restype = ctypes.c_int
        lib.aniso_read_csv.argtypes = [ctypes.c_char_p, _f64p, ctypes.c_long]
        lib.aniso_read_csv.restype = ctypes.c_long
        lib.aniso_num_threads.argtypes = []
        lib.aniso_num_threads.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def num_threads() -> int:
    lib = _load()
    return int(lib.aniso_num_threads()) if lib else 0


def _tables(grid, coeffs):
    gx = np.ascontiguousarray(grid.rule.points, dtype=np.float64)
    gw = np.ascontiguousarray(grid.rule.weights, dtype=np.float64)
    norms = np.ascontiguousarray(grid.norms, dtype=np.float64)
    c = np.ascontiguousarray(
        np.asarray(coeffs, dtype=np.float64).reshape(
            grid.sz * grid.sz, grid.nq
        )
    )
    return gx, gw, norms, c


def attenuation_batch(grid, coeffs, p0, p1,
                      compat_global_basis: bool = False) -> np.ndarray:
    """E along each p0[k] -> p1[k] (physical coords), exact quadrature.

    Semantics identical to ops.attenuation.make_line_integral (and hence the
    reference lineIntegral, KernelFactory.cpp:67-190), computed on host with
    OpenMP.  Returns float64 (n,).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    gx, gw, norms, c = _tables(grid, coeffs)
    p0 = np.ascontiguousarray(np.asarray(p0, np.float64).reshape(-1, 2))
    p1 = np.ascontiguousarray(np.asarray(p1, np.float64).reshape(-1, 2))
    n = p0.shape[0]
    out = np.empty(n, dtype=np.float64)
    lib.aniso_attenuation_batch(
        grid.sz, grid.deg, gx, gw, norms, c,
        int(compat_global_basis), p0, p1, n, out,
    )
    return out


def smooth_rows(grid, coeffs, mode: int, row0: int, nrows: int,
                compat_global_basis: bool = False) -> np.ndarray:
    """Dense smooth-kernel rows [row0, row0+nrows) x all nodes, float64.

    out[t, s] = expm1(-E(s, t)) cos(m theta) / r * w_glob[s]; m = 0 diagonal
    is sigma_hat(node) * w (reference KernelFactory.cpp:240-267).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    gx, gw, norms, c = _tables(grid, coeffs)
    nodes = np.ascontiguousarray(grid.flat_nodes(), dtype=np.float64)
    w = np.ascontiguousarray(grid.weights.reshape(-1), dtype=np.float64)
    n = nodes.shape[0]
    out = np.empty((nrows, n), dtype=np.float64)
    lib.aniso_smooth_rows(
        grid.sz, grid.deg, gx, gw, norms, c, int(compat_global_basis),
        nodes, w, mode, n, row0, nrows, out,
    )
    return out


def write_csv(path: str, x) -> None:
    lib = _load()
    x = np.ascontiguousarray(np.asarray(x, np.float64).reshape(-1))
    if lib is None:
        raise RuntimeError("native library unavailable")
    rc = lib.aniso_write_csv(path.encode(), x, x.shape[0])
    if rc != 0:
        raise OSError(f"cannot write {path}")


def read_csv(path: str, n: int) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    out = np.empty(n, dtype=np.float64)
    got = lib.aniso_read_csv(path.encode(), out, n)
    if got < 0:
        raise OSError(f"cannot read {path}")
    return out[:got]
