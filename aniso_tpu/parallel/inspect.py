"""Collective-traffic accounting for SPMD programs.

GSPMD chooses the collectives; this module makes the choice *visible* so
tests can gate on it: the domain-decomposed near field and the parity-plane
M2L gathers must move O(halo) bytes via collective-permute, never
O(volume) via all-gather.  The reference has no analogue (single-process
OpenMP); this plays the role its shared address space played.
"""

from __future__ import annotations

import re
from typing import Dict, NamedTuple

import numpy as np

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2,
    "s64": 8, "s32": 4, "s16": 2, "s8": 1,
    "u64": 8, "u32": 4, "u16": 2, "u8": 1, "pred": 1,
}

_COLLECTIVES = (
    "all-gather", "collective-permute", "all-reduce", "all-to-all",
    "reduce-scatter",
)


class CollectiveStats(NamedTuple):
    counts: Dict[str, int]    # op name -> number of instructions
    bytes: Dict[str, int]     # op name -> total output bytes (per shard)

    def total_bytes(self) -> int:
        return sum(self.bytes.values())


def collective_stats(hlo_text: str) -> CollectiveStats:
    """Parse compiled HLO text (`compiled.as_text()`) for collective ops."""
    counts: Dict[str, int] = {}
    nbytes: Dict[str, int] = {}
    shape_re = re.compile(r"=\s*(?:\()?(\w+)\[([\d,]*)\]")
    for line in hlo_text.splitlines():
        op = next(
            (c for c in _COLLECTIVES if re.search(rf"\b{c}\b", line) and "=" in line
             and re.search(rf"{c}(-start|-done)?\(", line)),
            None,
        )
        if op is None:
            continue
        if f"{op}-done(" in line:
            continue  # avoid double counting start/done pairs
        counts[op] = counts.get(op, 0) + 1
        m = shape_re.search(line)
        if m:
            dims = [int(x) for x in m.group(2).split(",") if x]
            b = int(np.prod(dims)) * _DTYPE_BYTES.get(m.group(1), 4) if dims \
                else _DTYPE_BYTES.get(m.group(1), 4)
            nbytes[op] = nbytes.get(op, 0) + b
    return CollectiveStats(counts, nbytes)


def compiled_collective_stats(compiled) -> CollectiveStats:
    """Stats for a jax `Compiled` (jit(...).lower(...).compile())."""
    return collective_stats(compiled.as_text())
