"""Shared benchmark infrastructure: timing, environment capture, JSON
artifacts, and regression comparison.

The reference's benchmarks time CUDA kernels with warm-up launches and
write JSON result artifacts (``Benchmark/quick_benchmark.py``,
``Benchmark/ik_branch_benchmark_results.json``); the XLA equivalents are
compile-excluded steady-state timing (first call = compile) and
``block_until_ready`` fencing.
"""

from __future__ import annotations

import json
import os
import platform
import time
from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Dict, List, Optional

import jax


def setup_backend(prefer: Optional[str] = None) -> str:
    """Select the benchmark backend.

    Defaults to whatever jax resolves (the GPU when there is one);
    ``prefer='cpu'`` forces CPU (accuracy benchmarks want f64 + CPU).
    Returns the backend name actually in use.
    """
    if prefer == "cpu":
        try:
            jax.config.update("jax_platforms", "cpu")
        except RuntimeError:
            pass  # backend already initialized
    from manipulapy_tpu.utils.config import configure_cache

    configure_cache()
    return jax.default_backend()


def enable_x64() -> None:
    jax.config.update("jax_enable_x64", True)


@dataclass
class Timing:
    """Steady-state timing of one jitted workload."""

    name: str
    compile_s: float
    mean_s: float
    min_s: float
    sustained_s: float  # per-call time with pipelined dispatch (one fence)
    iters: int
    throughput: Optional[float] = None  # items/s at the sustained rate
    latency_throughput: Optional[float] = None  # items/s fenced per call
    extra: Dict[str, Any] = field(default_factory=dict)


def time_fn(
    name: str,
    fn: Callable[[], Any],
    *,
    iters: int = 10,
    items_per_call: Optional[float] = None,
    **extra,
) -> Timing:
    """Warm-up (compile) + timed steady-state runs, fenced with
    ``block_until_ready`` — the XLA analogue of the reference's
    warm-up-launch-then-cuda.synchronize timing
    (``cuda_kernels.py:2129-2208``)."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    compile_s = time.perf_counter() - t0

    # Per-call latency: fence every call (includes the dispatch and the
    # host<->device synchronisation).
    times: List[float] = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    mean_s = sum(times) / len(times)

    # Sustained rate: pipeline all dispatches, fence once — what a real
    # batch/streaming workload sees.
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn()
    jax.block_until_ready(out)
    sustained_s = (time.perf_counter() - t0) / iters

    return Timing(
        name=name,
        compile_s=compile_s,
        mean_s=mean_s,
        min_s=min(times),
        sustained_s=sustained_s,
        iters=iters,
        throughput=(items_per_call / sustained_s) if items_per_call else None,
        latency_throughput=(items_per_call / mean_s) if items_per_call else None,
        extra=extra,
    )


def environment_info() -> Dict[str, Any]:
    return {
        "backend": jax.default_backend(),
        "devices": [str(d) for d in jax.devices()],
        "jax_version": jax.__version__,
        "python": platform.python_version(),
        "platform": platform.platform(),
    }


def write_artifact(path: str, payload: Dict[str, Any]) -> str:
    """Write a JSON result artifact (reference commits these, e.g.
    ``Benchmark/ik_branch_benchmark_results.json``)."""
    payload = dict(payload)
    payload.setdefault("environment", environment_info())
    payload.setdefault("timestamp", time.strftime("%Y-%m-%dT%H:%M:%S"))
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, default=_json_default)
    return path


def _json_default(o):
    if isinstance(o, Timing):
        return asdict(o)
    try:
        import numpy as np

        if isinstance(o, (np.floating, np.integer)):
            return o.item()
        if isinstance(o, np.ndarray):
            return o.tolist()
    except ImportError:
        pass
    return str(o)


def compare_to_previous(path: str, results: Dict[str, float], tol: float = 0.25):
    """Regression check against a previous artifact: flags metrics that
    regressed by more than ``tol`` fractionally (the reference's
    quick-benchmark regression detection, ``Benchmark/quick_benchmark.py``).

    Returns (regressions, previous) — empty when no previous artifact.
    """
    if not os.path.exists(path):
        return [], None
    with open(path) as f:
        prev = json.load(f)
    prev_metrics = prev.get("metrics", {})
    regressions = []
    for k, v in results.items():
        pv = prev_metrics.get(k)
        if pv is None or not isinstance(pv, (int, float)) or pv <= 0:
            continue
        # Larger-is-better metrics named *_per_s; smaller-is-better else.
        if k.endswith("_per_s"):
            if v < pv * (1 - tol):
                regressions.append({"metric": k, "previous": pv, "current": v})
        else:
            if v > pv * (1 + tol):
                regressions.append({"metric": k, "previous": pv, "current": v})
    return regressions, prev
