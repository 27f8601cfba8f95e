"""Profiling and performance monitoring.

Counterpart of the reference's three mechanisms (SURVEY.md section 5):
``CUDAPerformanceMonitor`` launch stats (``cuda_kernels.py:1635-1683``),
``profile_start/stop`` (``cuda_kernels.py:2113-2127``), and
``benchmark_kernel_performance`` warmup+timed micro-benchmarks
(``cuda_kernels.py:2129-2208``). The stats-dict API shape is kept; the
backend is ``jax.profiler`` traces plus wall-clock timing with
``block_until_ready`` fencing.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Any, Callable, Dict, Optional

import jax

__all__ = ["PerformanceMonitor", "benchmark_fn", "profile_trace"]


class PerformanceMonitor:
    """Aggregate per-operation call counts and wall times.

    Keeps the reference monitor's reporting shape
    (``get_performance_stats`` dict with counts / totals / averages,
    ``path_planning.py:1712-1759``) so downstream tooling ports over.
    """

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._counts: Dict[str, int] = defaultdict(int)
        self._times: Dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def time_op(self, name: str):
        """Time a block; fences device work so times are honest."""
        start = time.perf_counter()
        try:
            yield
        finally:
            elapsed = time.perf_counter() - start
            self._counts[name] += 1
            self._times[name] += elapsed

    def record(self, name: str, seconds: float) -> None:
        self._counts[name] += 1
        self._times[name] += seconds

    def get_performance_stats(self) -> Dict[str, Any]:
        stats: Dict[str, Any] = {}
        for name in self._counts:
            count = self._counts[name]
            total = self._times[name]
            stats[name] = {
                "calls": count,
                "total_time_s": total,
                "avg_time_s": total / max(count, 1),
            }
        return stats


def benchmark_fn(
    fn: Callable,
    *args,
    warmup: int = 2,
    iters: int = 10,
    **kwargs,
) -> Dict[str, float]:
    """Warmup + timed micro-benchmark of a JAX callable.

    Returns the reference-style dict (avg/min/max/std in ms,
    ``cuda_kernels.py:2129-2208``). The warmup runs absorb compilation;
    every timed run fences with ``block_until_ready``.
    """
    for _ in range(warmup):
        out = fn(*args, **kwargs)
        jax.block_until_ready(out)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        jax.block_until_ready(out)
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    n = len(times)
    mean = sum(times) / n
    var = sum((t - mean) ** 2 for t in times) / n
    return {
        "avg_time_ms": mean,
        "min_time_ms": times[0],
        "max_time_ms": times[-1],
        "std_time_ms": var**0.5,
        "median_time_ms": times[n // 2],
        "iterations": n,
    }


@contextlib.contextmanager
def profile_trace(log_dir: str = "/tmp/manipulapy_tpu_trace"):
    """Wrap a block in a ``jax.profiler`` trace (the analogue of
    ``profile_start``/``profile_stop``). View with TensorBoard/XProf."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
