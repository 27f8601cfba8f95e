"""Tests for the URDF processor facade and the feature-detection surface.

Reference counterparts: ``URDFToSerialManipulator`` behavior
(``/root/reference/ManipulaPy/urdf_processor.py``) and the facade's
dependency machinery (``/root/reference/ManipulaPy/__init__.py:272-461``).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import manipulapy_tpu as mtpu
from manipulapy_tpu.urdf import URDFToRobotModel


@pytest.fixture(scope="module")
def proc():
    return URDFToRobotModel("ur5", dtype=jnp.float64)


class TestURDFToRobotModel:
    def test_load_by_catalog_name(self, proc):
        assert proc.num_joints == 6
        assert proc.model.dtype == jnp.float64

    def test_load_from_string(self):
        from manipulapy_tpu.models.data import robot_urdf_string

        proc2 = URDFToRobotModel(robot_urdf_string("ur5"), dtype=jnp.float64)
        assert proc2.num_joints == 6

    def test_robot_data_reference_layout(self, proc):
        d = proc.robot_data()
        n = proc.num_joints
        assert d["M"].shape == (4, 4)
        assert d["Slist"].shape == (6, n)  # reference column-major layout
        assert d["Blist"].shape == (6, n)
        assert d["Glist"].shape == (n, 6, 6)
        assert d["joint_limits"].shape == (n, 2)
        assert len(d["chain_links"]) >= n

    def test_batch_fk_matches_single(self, proc):
        qs = np.linspace(-0.5, 0.5, 3 * proc.num_joints).reshape(3, -1)
        Ts = np.asarray(proc.batch_forward_kinematics(qs))
        for i in range(3):
            Ti = np.asarray(proc.forward_kinematics(qs[i]))
            np.testing.assert_allclose(Ts[i], Ti, atol=1e-12)

    def test_joint_limit_override(self):
        lower = -np.ones(6)
        upper = np.ones(6)
        p = URDFToRobotModel("ur5", joint_limits=(lower, upper), dtype=jnp.float64)
        np.testing.assert_allclose(np.asarray(p.model.joint_lower), lower)
        np.testing.assert_allclose(np.asarray(p.model.joint_upper), upper)

    def test_dynamics_passthrough(self, proc):
        z = np.zeros(6)
        tau = np.asarray(proc.inverse_dynamics(z, z, z))
        ddq = np.asarray(proc.forward_dynamics(z, z, tau))
        # invdyn(0,0,0) is the gravity torque; feeding it back gives ddq=0.
        np.testing.assert_allclose(ddq, 0.0, atol=1e-8)

    def test_ik_dispatch_iterative(self, proc):
        q_ref = np.array([0.2, -0.4, 0.3, 0.1, 0.2, -0.1])
        T = proc.forward_kinematics(q_ref)
        res = proc.inverse_kinematics(T, theta0=q_ref + 0.05, max_iterations=80)
        assert bool(res.success)

    def test_ik_dispatch_unknown_method(self, proc):
        with pytest.raises(ValueError):
            proc.inverse_kinematics(np.eye(4), method="nope")

    def test_planner_constructor(self, proc):
        planner = proc.planner()
        traj = planner.joint_trajectory(np.zeros(6), np.ones(6), Tf=1.0, N=16)
        assert np.asarray(traj.position).shape == (16, 6)


class TestFeatures:
    def test_get_available_features_keys(self):
        feats = mtpu.get_available_features()
        for key in ("core", "simulation", "vision", "ml", "gpu", "mesh"):
            assert key in feats
        assert feats["core"] is True  # jax+numpy are always present here

    def test_check_dependencies_quiet(self, capsys):
        feats = mtpu.check_dependencies(verbose=False)
        assert capsys.readouterr().out == ""
        assert isinstance(feats, dict)

    def test_check_dependencies_verbose_prints(self, capsys):
        mtpu.check_dependencies(verbose=True)
        out = capsys.readouterr().out
        assert "feature availability" in out

    def test_require_feature_core_passes(self):
        mtpu.require_feature("core")

    def test_require_feature_unknown_raises(self):
        with pytest.raises(ValueError):
            mtpu.require_feature("warp-drive")

    def test_require_feature_missing_raises_importerror(self, monkeypatch):
        from manipulapy_tpu.utils import features

        monkeypatch.setitem(features._FEATURE_DEPS, "simulation", [("definitely_not_a_module", "nope")])
        features.get_available_features(refresh=True)
        with pytest.raises(ImportError, match="nope"):
            features.require_feature("simulation")
        # restore cache for other tests
        monkeypatch.undo()
        features.get_available_features(refresh=True)

    def test_installation_command(self):
        assert "pybullet" in mtpu.get_installation_command("simulation")
        assert mtpu.get_installation_command("core") == ""

    def test_test_installation(self):
        assert mtpu.test_installation() is True
