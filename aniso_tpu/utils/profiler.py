"""Named-section wall-clock profiler + JAX phase-timing helpers.

Plays the role of the reference's two instruments (SURVEY.md section 5):
`Profiler` tic/toc with counted [C] / uncounted [U] tags and a
percent-of-total table (reference utility/Profiler.h:12-69), and the
compile-time `RUN` phase macro (reference bbfmm/utils.h:51-62).

Additions the reference has no analogue for:

  * sections synchronize on device work (`jax.block_until_ready`) so a
    section measures execution, not dispatch;
  * `trace()` wraps `jax.profiler.trace` for XLA-level traces viewable in
    TensorBoard/XProf.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Optional

import jax


class Profiler:
    """tic/toc named sections; summary printed via report() or on __exit__.

    Matches reference semantics: tic while clocking is a no-op
    (Profiler.h:32-33), toc(count=False) records the section time but
    excludes it from the counted total and tags it [U] (Profiler.h:47-56).
    """

    def __init__(self, sync: bool = True):
        self._times: Dict[str, float] = {}
        self._counted: Dict[str, bool] = {}
        self._order: list[str] = []
        self._total = 0.0
        self._clocking = False
        self._task: Optional[str] = None
        self._begin = 0.0
        self._sync = sync

    def tic(self, name: str = "") -> None:
        if self._clocking:
            return
        self._clocking = True
        self._task = name
        if name not in self._times:
            self._times[name] = 0.0
            self._order.append(name)
        self._counted[name] = False
        self._begin = time.perf_counter()

    def toc(self, count: bool = True, result: Any = None) -> Any:
        """End the current section.  Pass the section's device output as
        `result` to block on it before reading the clock."""
        if not self._clocking:
            return result
        if result is not None and self._sync:
            jax.block_until_ready(result)
        elapsed = time.perf_counter() - self._begin
        self._clocking = False
        self._times[self._task] += elapsed
        if count:
            self._total += elapsed
            self._counted[self._task] = True
        return result

    @contextlib.contextmanager
    def section(self, name: str, count: bool = True):
        """`with profiler.section("up pass"): ...` sugar over tic/toc."""
        self.tic(name)
        try:
            yield self
        finally:
            self.toc(count=count)

    def times(self) -> Dict[str, float]:
        return dict(self._times)

    @property
    def total(self) -> float:
        return self._total

    def report(self) -> str:
        """The reference's destructor table (Profiler.h:21-29)."""
        lines = []
        total = self._total if self._total > 0 else float("inf")
        for name in self._order:
            secs = self._times[name]
            tag = "[C]" if self._counted.get(name) else "[U]"
            lines.append(
                f"{name:>30s}{tag}{secs / total * 100:15.3f}%{secs:15.3f} seconds"
            )
        lines.append(f'{"counted time":>30s}{self._total:34.3f} seconds')
        return "\n".join(lines)

    def __enter__(self) -> "Profiler":
        return self

    def __exit__(self, *exc) -> None:
        print(self.report())


@contextlib.contextmanager
def trace(logdir: str):
    """XLA-level trace (TensorBoard/XProf) around a block of device work."""
    with jax.profiler.trace(logdir):
        yield


def timed(fn, *args, reps: int = 1, warmup: int = 1, **kwargs):
    """Median wall-clock of `fn(*args)` with device sync — the `RUN` macro
    analogue (utils.h:51-62), but measuring steady state, not first call."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args, **kwargs))
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args, **kwargs))
        samples.append(time.perf_counter() - t0)
    samples.sort()
    return samples[len(samples) // 2], samples
