"""Roofline accounting for the corrected FMM matvec: bytes streamed and
FLOPs per matvec, against the peaks of the device that ran it.

The model counts the MINIMUM device-memory traffic (every resident cache
byte read exactly once per matvec -- the algorithm is a streaming
evaluation of its caches) and the arithmetic of every contraction.
Achieved bandwidth = min_bytes / measured_time is therefore a LOWER bound
on what the device actually moved; the share of peak computed from it is
a lower bound on roofline position.  Factored levels add their exact
re-form matmul FLOPs and the written+re-read E transient.

Every contraction pins jax.lax.Precision.HIGHEST, which an NVIDIA GPU
runs as true f32 outside the tensor cores, so the f32 compute peak is
the non-tensor-core rate.
"""

from __future__ import annotations

import numpy as np

# Published peaks per device, keyed by jax `device_kind`.  Source: NVIDIA
# H100 Tensor Core GPU data sheet, SXM part (80 GB HBM3 at 3.35 TB/s;
# 67 TFLOP/s FP32 and 34 TFLOP/s FP64 outside the tensor cores), at the
# full 700 W power limit.  A device missing here gets no shares.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_gbps": 3350.0,
        "f32_tflops": 67.0,
        "f64_tflops": 34.0,
    },
}


def device_peaks(device_kind: str):
    """Peaks dict for `device_kind`, or None when the table lacks it."""
    return PEAKS.get(device_kind)


def _nbytes(a) -> int:
    return int(np.prod(a.shape)) * a.dtype.itemsize


def matvec_costs(solver) -> dict:
    """Per corrected single-mode matvec: minimum HBM bytes + FLOPs.

    Reads the ACTUAL cache pytree (dense per-class tuples / stacked
    arrays / factored {'patch','W'} levels, stored or virtual near
    field), so the accounting always matches the representation that
    ran.  Small operands (multipole pyramids, static sweep tables,
    cosr tables) are counted too -- they are minor but free to count.
    """
    g = solver.grid
    caches = solver._caches
    tcfg = solver._tcfg
    r = solver.cfg.np_cheb ** 2
    sz, nq = g.sz, g.nq

    bytes_read = 0
    flops = 0
    transient_bytes = 0
    detail = {}

    # --- M2L levels ---
    for lv, E_l in caches["m2l_E"].items():
        m2 = tcfg.boxes(lv) // 2
        P = r * 27 * r
        if isinstance(E_l, dict) and "Wo" in E_l:
            # per-offset virtual (build_m2l_offsets_fine): one window
            # dot per CANONICAL (class, offset) block, exp shared with
            # the mirror -- half the generic exp count
            from ..fmm.smooth import _fine_offset_entries

            entries, keys, _ = _fine_offset_entries(solver.cfg.np_cheb)
            itemsize = E_l["Wo"][0].dtype.itemsize
            bytes_read += sum(_nbytes(v) for v in E_l["Wo"])
            bytes_read += sz * sz * nq * itemsize   # coeff field read
            blk = m2 * m2 * r * r
            for (_c, _o, _px, _py, _di, _dj, ki) in entries:
                flops += 2 * blk * E_l["Wo"][ki].shape[1]
            # E transient written + re-read per canonical block; exp on
            # the canonical half only; contract over all 4*27 blocks
            transient_bytes += 2 * len(entries) * blk * itemsize
            flops += 3 * len(entries) * blk
            flops += 2 * 4 * m2 * m2 * P
            bytes_read += 2 * 4 * m2 * m2 * r * 4
            detail[f"m2l_level_{lv}"] = "offsets"
            continue
        if isinstance(E_l, dict):            # factored {patch?, W}
            W = E_l["W"]
            itemsize = W.dtype.itemsize
            Q = W.shape[1]
            stored = sum(_nbytes(v) for v in E_l.values())
            if "patch" not in E_l:           # virtual: patch re-formed
                stored += sz * sz * nq * itemsize   # coeff field read
            bytes_read += stored
            # re-form matmul (4, m2*m2, Q) @ (Q, P) + the E transient
            # written then re-read by the fused exp/contract consumer
            flops += 2 * 4 * m2 * m2 * Q * P
            transient_bytes += 2 * 4 * m2 * m2 * P * itemsize
            detail[f"m2l_level_{lv}"] = "factored"
        else:                                # dense: tuple or stacked
            blocks = E_l if isinstance(E_l, (list, tuple)) else (E_l,)
            lvl_bytes = sum(_nbytes(b) for b in blocks)
            bytes_read += lvl_bytes
            detail[f"m2l_level_{lv}"] = "dense"
        # fused operator exp(-E)*cosr (~3 elementwise ops) + the batched
        # (r x 27r) @ (27r) translate per box per class
        flops += 3 * 4 * m2 * m2 * P
        flops += 2 * 4 * m2 * m2 * P
        # multipole/local planes at this level
        bytes_read += 2 * 4 * m2 * m2 * r * 4

    # --- near field ---
    itemsize = 4
    if "near_E" in caches:
        bytes_read += _nbytes(caches["near_E"])
        itemsize = caches["near_E"].dtype.itemsize
    else:                                    # virtual near field
        W = caches["near_W"]
        itemsize = W.dtype.itemsize
        bytes_read += sz * sz * nq * itemsize
        flops += 2 * 9 * nq * sz * sz * (9 * nq * nq)   # E re-form einsum
        transient_bytes += 2 * 9 * nq * nq * sz * sz * itemsize
    near_elems = 9 * nq * nq * sz * sz
    flops += 2 * near_elems          # block contract
    flops += 3 * near_elems          # expm1 + scale + stencil add
    bytes_read += _nbytes(caches["sigma_w"])
    if "duffy" in solver._mode_statics[0]:
        bytes_read += _nbytes(solver._mode_statics[0]["duffy"])
        flops += 2 * nq * nq * sz * sz

    # --- sweeps (P2M/M2M/L2L/L2T) ---
    flops += 2 * 2 * sz * sz * nq * r        # P2M + L2T
    for lv in range(2, tcfg.leaf_level):
        m = tcfg.boxes(lv + 1)
        flops += 2 * 2 * m * m * r * r       # M2M + L2L through this level
    bytes_read += 3 * sz * sz * nq * itemsize   # u in, out, weights fold

    return {
        "min_hbm_bytes": int(bytes_read),
        "transient_hbm_bytes": int(transient_bytes),
        "flops": int(flops),
        "level_repr": detail,
    }


def roofline_summary(solver, matvec_s: float, peaks) -> dict:
    """Roofline position of a measured matvec time.

    peaks: an entry of PEAKS (`device_peaks(device.device_kind)`); with
    None the shares are None -- no default device is assumed."""
    c = matvec_costs(solver)
    gbps = c["min_hbm_bytes"] / matvec_s / 1e9
    gbps_incl = (c["min_hbm_bytes"] + c["transient_hbm_bytes"]) \
        / matvec_s / 1e9
    tflops = c["flops"] / matvec_s / 1e12
    flop_peak = None
    if peaks is not None:
        f64 = np.dtype(solver.dtype).itemsize == 8
        flop_peak = peaks["f64_tflops" if f64 else "f32_tflops"]

    def share(x, peak):
        return None if peak is None else round(100.0 * x / peak, 2)

    return {
        **c,
        "matvec_ms": round(matvec_s * 1e3, 4),
        "achieved_gbps_min": round(gbps, 1),
        "achieved_gbps_incl_transients": round(gbps_incl, 1),
        "pct_hbm_peak": share(gbps, peaks and peaks["hbm_gbps"]),
        "pct_hbm_peak_incl_transients": share(
            gbps_incl, peaks and peaks["hbm_gbps"]),
        "achieved_tflops": round(tflops, 4),
        "pct_flop_peak": share(tflops, flop_peak),
        "peaks": peaks,
    }
