"""Smoke tests for the examples tree and benchmark suite.

Mirrors the reference's doc-example regression classes
(``test_cuda_kernels.py`` doc-example tests): demos must run clean on the
CPU backend, and the benchmark helpers' pure logic must behave.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_demo(rel_path, *argv):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, rel_path), "--cpu", *argv],
        capture_output=True,
        text=True,
        timeout=420,
        env=env,
        cwd=REPO,
    )
    assert proc.returncode == 0, f"{rel_path} failed:\n{proc.stderr[-2000:]}"
    return proc.stdout


class TestExamples:
    def test_kinematics_demo(self):
        out = _run_demo("examples/basic/kinematics_demo.py", "--quick")
        assert "space-vs-body frame max diff" in out
        assert "payload" in out
        assert "saved workspace plot" in out or "matplotlib unavailable" in out

    def test_dynamics_demo_quick(self):
        out = _run_demo("examples/basic/dynamics_demo.py", "--quick")
        assert "RNEA vs composed Lagrangian agreement" in out
        assert "energy balance" in out
        assert "work-energy mismatch" in out

    def test_urdf_demo(self):
        out = _run_demo("examples/basic/urdf_demo.py", "--quick")
        assert "IK from a perturbed guess: success=True" in out
        assert "robots parse + validate clean" in out

    def test_perception_demo(self):
        out = _run_demo("examples/intermediate/perception_demo.py", "--quick")
        assert "detected 3 obstacles (truth: 3)" in out
        assert "correct segmentation is stable" in out

    def test_singularity_demo_quick(self):
        out = _run_demo("examples/intermediate/singularity_analysis_demo.py", "--quick")
        assert "sigma_min minimized at" in out
        assert "audit a planned path" in out

    def test_gpu_acceleration_demo_quick(self):
        out = _run_demo("examples/advanced/gpu_acceleration_demo.py", "--quick")
        assert "Phase 3: trajectory pipeline" in out
        assert "plot saved" in out or "matplotlib unavailable" in out

    def test_collision_avoidance_demo_quick(self):
        out = _run_demo("examples/advanced/collision_avoidance_demo.py", "--quick")
        assert "min clearance BEFORE avoidance: -" in out  # obstacle really on path
        assert "endpoints pinned: start True, goal True" in out
        assert "Phase 3: three obstacles" in out

    def test_fleet_mpc_demo_quick(self):
        out = _run_demo("examples/advanced/fleet_mpc_demo.py", "--quick", "--virtual", "2")
        assert "fleet mean cost" in out
        assert "plot saved" in out or "matplotlib unavailable" in out

    def test_optimal_control_demo_quick(self):
        out = _run_demo("examples/advanced/optimal_control_demo.py", "--quick")
        assert "Phase 4: torque-limit sweep" in out
        assert "recovered: True" in out

    def test_batch_processing_demo_quick(self):
        out = _run_demo("examples/advanced/batch_processing_demo.py", "--quick")
        assert "within limits everywhere: True" in out
        assert "converged" in out

    @pytest.mark.slow
    def test_stereo_vision_advanced_demo(self):
        pytest.importorskip("cv2")
        out = _run_demo("examples/advanced/stereo_vision_advanced_demo.py")
        assert "DBSCAN: 3 clusters" in out
        assert "OK" in out

    @pytest.mark.slow
    def test_real_robot_integration_demo(self):
        out = _run_demo("examples/advanced/real_robot_integration_demo.py")
        assert "closed-loop tracking" in out
        assert "safety:" in out


class TestBenchmarkHelpers:
    def test_compare_to_previous_regression_semantics(self, tmp_path):
        from benchmarks.common import compare_to_previous

        prev = tmp_path / "prev.json"
        prev.write_text(json.dumps({"metrics": {"op_ms": 10.0, "op_per_s": 100.0}}))
        # Slower ms and lower per_s are regressions; improvements are not.
        regs, _ = compare_to_previous(str(prev), {"op_ms": 20.0, "op_per_s": 50.0})
        assert {r["metric"] for r in regs} == {"op_ms", "op_per_s"}
        regs, _ = compare_to_previous(str(prev), {"op_ms": 5.0, "op_per_s": 300.0})
        assert regs == []
        # No previous artifact -> no regressions.
        regs, prev_data = compare_to_previous(str(tmp_path / "missing.json"), {"op_ms": 1.0})
        assert regs == [] and prev_data is None

    @pytest.mark.slow
    def test_quick_benchmark_accuracy_core(self):
        from benchmarks.quick_benchmark import run_accuracy_core

        checks = run_accuracy_core()
        failed = {k: v for k, v in checks.items() if not v["pass"]}
        assert not failed, f"quick accuracy core failed: {failed}"

    @pytest.mark.slow
    def test_accuracy_benchmark_small(self):
        from benchmarks.accuracy_benchmark import run

        results = run("ur5", num_configs=4, ik_targets=2)
        failed = {k: v for k, v in results.items() if not v["pass"]}
        assert not failed, f"accuracy categories failed: {failed}"
