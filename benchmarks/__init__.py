"""Benchmark suite.

Mirrors the reference's ``Benchmark/`` package (SURVEY.md section 2.7):

* ``accuracy_benchmark`` — numerical-consistency checks with the
  reference's published tolerances (``Benchmark/accuracy_benchmark.py``).
* ``performance_benchmark`` — throughput/latency sweeps over problem
  sizes (``Benchmark/performance_benchmark.py``).
* ``quick_benchmark`` — a <60 s CI subset with regression detection
  (``Benchmark/quick_benchmark.py``).
* ``ik_benchmark`` — IK solver success/latency comparison
  (``Benchmark/ik_benchmark.py``).
* ``kernel_vs_xla`` — the GPU rollout kernel against the XLA scan, and
  the MPC tick with its launches per iteration (GPU only).

Run as modules: ``python -m benchmarks.quick_benchmark``. Each writes a
JSON artifact next to itself (override with ``--output``).
"""
