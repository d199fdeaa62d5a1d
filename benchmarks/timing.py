"""Guarded amortized-matvec timing.

Times K and 5K chained applies and differences them to cancel the fixed
dispatch and transfer latency of one call; the estimate is the median
over repeats.  The difference of two noisy times can go ~zero or
negative, so it is cross-checked against the absolute chain rate and
falls back to that rate when implausible.

Returns (seconds_per_apply, detail) where detail records the raw samples
and which estimator was used, for inclusion in the results JSON.
"""

from __future__ import annotations

import time

import numpy as np


def amortized_apply_time(run_chain, K: int, reps: int = 3):
    """run_chain(k, rep) -> wall seconds for a k-long chain, timed to
    completion (block_until_ready inside the timed region)."""
    t_k = [run_chain(K, r) for r in range(reps)]
    t_5k = [run_chain(5 * K, r + reps) for r in range(reps)]
    diffs = [(b - a) / (4 * K) for a, b in zip(t_k, t_5k)]
    per_diff = float(np.median(diffs))
    per_abs = float(np.median(t_5k)) / (5 * K)

    spread = (max(diffs) - min(diffs)) / per_diff if per_diff > 0 else np.inf
    plausible = (
        per_diff > 0
        and per_diff >= 0.3 * per_abs   # differencing can't beat the
        and per_diff <= 1.2 * per_abs   # absolute rate by >3x (noise) nor
        and spread < 0.5                # exceed it; samples must agree
    )
    per = per_diff if plausible else per_abs
    detail = {
        "timing_mode": "differenced" if plausible else
                       "absolute-fallback (differencing implausible)",
        "K": K,
        "t_K_s": [round(t, 4) for t in t_k],
        "t_5K_s": [round(t, 4) for t in t_5k],
        "per_apply_differenced_ms": round(per_diff * 1e3, 4),
        "per_apply_absolute_ms": round(per_abs * 1e3, 4),
    }
    return per, detail
