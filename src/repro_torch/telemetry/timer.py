"""Per-phase wall-clock accounting that keeps first dispatches apart.

A round's first dispatch at a new shape pays one-time costs (in this
package: the kernels' first load and the caching allocator's first growth);
every later one pays only execution. :class:`PhaseTimer` keeps one sample
list per ``(phase, first dispatch?)`` so callers can report steady-state
means beside the one-time cost. The ``compile`` flag keeps the JAX
package's name for that bucket.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, List, Tuple


class PhaseTimer:
    """Accumulates wall-time samples per phase, tagged by ``compile``.

    Use ``with timer.phase("round"):`` around host work, or ``add`` when the
    duration was measured elsewhere. ``compile=True`` samples are kept apart
    so ``mean()`` is a steady-state figure.
    """

    def __init__(self):
        self._samples: Dict[Tuple[str, bool], List[float]] = {}

    def add(self, name: str, seconds: float, compile: bool = False) -> None:
        self._samples.setdefault((name, bool(compile)), []).append(float(seconds))

    @contextmanager
    def phase(self, name: str, compile: bool = False):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0, compile)

    def total(self, name: str, compile: bool = False) -> float:
        return sum(self._samples.get((name, bool(compile)), []))

    def count(self, name: str, compile: bool = False) -> int:
        return len(self._samples.get((name, bool(compile)), []))

    def mean(self, name: str) -> float:
        """Steady-state mean seconds for ``name`` (0.0 if never sampled)."""
        xs = self._samples.get((name, False), [])
        return sum(xs) / len(xs) if xs else 0.0

    def summary(self) -> Dict[str, Dict[str, float]]:
        """``{phase: {mean_s, total_s, count, compile_s, compile_count}}``."""
        return {name: {"mean_s": self.mean(name), "total_s": self.total(name),
                       "count": self.count(name),
                       "compile_s": self.total(name, compile=True),
                       "compile_count": self.count(name, compile=True)}
                for name in sorted({name for name, _ in self._samples})}
