"""Tests for checkpoint/resume of solver state (SURVEY.md section 5:
the reference has no computation-state checkpointing; this is the
framework's orbax-style snapshot surface for long MPC runs)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from manipulapy_tpu.mpc.ilqr import ILQRResult
from manipulapy_tpu.utils import CheckpointManager, load_checkpoint, save_checkpoint


class TestSaveLoad:
    def test_roundtrip_dict_tree(self, tmp_path):
        tree = {
            "us": jnp.arange(12.0).reshape(3, 4),
            "reg": jnp.float32(1e-3),
            "nested": {"key": jax.random.PRNGKey(7)},
        }
        path = save_checkpoint(str(tmp_path / "a.npz"), tree, meta={"note": "x"})
        restored, meta = load_checkpoint(path, with_meta=True)
        assert meta["note"] == "x"
        np.testing.assert_array_equal(np.asarray(restored["us"]), np.asarray(tree["us"]))
        np.testing.assert_array_equal(
            np.asarray(restored["nested"]["key"]), np.asarray(tree["nested"]["key"])
        )

    def test_roundtrip_namedtuple(self, tmp_path):
        res = ILQRResult(
            xs=jnp.ones((6, 4)),
            us=jnp.zeros((5, 2)),
            cost=jnp.float32(3.5),
            gains_K=jnp.ones((5, 2, 4)),
            converged=jnp.asarray(True),
        )
        path = save_checkpoint(str(tmp_path / "res.npz"), res)
        restored = load_checkpoint(path)
        assert isinstance(restored, ILQRResult)
        assert float(restored.cost) == pytest.approx(3.5)
        assert restored.us.shape == (5, 2)

    def test_creates_parent_dirs(self, tmp_path):
        path = save_checkpoint(str(tmp_path / "sub" / "dir" / "c.npz"), {"x": jnp.ones(2)})
        assert os.path.exists(path)


class TestCheckpointManager:
    def test_save_restore_latest(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), max_to_keep=3)
        assert mgr.restore_latest() == (None, None)
        for step in (1, 5, 9):
            mgr.save(step, {"step_val": jnp.asarray(float(step))})
        step, tree = mgr.restore_latest()
        assert step == 9
        assert float(tree["step_val"]) == 9.0

    def test_rotation_keeps_newest(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
        for step in range(5):
            mgr.save(step, {"x": jnp.asarray(step)})
        assert mgr.all_steps() == [3, 4]

    def test_restore_specific_step(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), max_to_keep=5)
        mgr.save(2, {"x": jnp.asarray(2.0)})
        mgr.save(4, {"x": jnp.asarray(4.0)})
        assert float(mgr.restore(2)["x"]) == 2.0

    def test_mpc_warm_start_resume(self, tmp_path):
        """End-to-end: save a warm start mid-'run', resume, continue."""
        mgr = CheckpointManager(str(tmp_path))
        us_warm = jnp.ones((10, 6)) * 0.5
        key = jax.random.PRNGKey(3)
        mgr.save(100, {"us_warm": us_warm, "key": key}, meta={"robot": "ur5"})
        step, state = mgr.restore_latest()
        assert step == 100
        np.testing.assert_allclose(np.asarray(state["us_warm"]), 0.5)
        # resumed key drives identical randomness
        a = jax.random.normal(jnp.asarray(state["key"], dtype=jnp.uint32), (3,))
        b = jax.random.normal(key, (3,))
        np.testing.assert_allclose(np.asarray(a), np.asarray(b))
