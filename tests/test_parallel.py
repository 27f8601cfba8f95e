"""Distributed-layer tests on the 8-device virtual CPU mesh (the
multi-device testing strategy: xla_force_host_platform_device_count in
conftest — SURVEY.md section 4's 'GPU-without-GPU' analogue)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from manipulapy_tpu import parallel
from manipulapy_tpu.models import catalog

pytestmark = pytest.mark.multichip


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return parallel.make_mesh(8)


@pytest.fixture(scope="module")
def ur5_f32():
    return catalog.ur5(dtype=jnp.float32)


class TestMeshBasics:
    def test_mesh_shape(self, mesh):
        assert mesh.devices.size == 8
        assert mesh.axis_names == ("scenario",)

    def test_shard_batch_placement(self, mesh):
        x = jnp.arange(32.0).reshape(16, 2)
        xs = parallel.shard_batch(x, mesh)
        assert xs.sharding.num_devices == 8
        np.testing.assert_allclose(np.asarray(xs), np.asarray(x))

    def test_replicate_model(self, mesh, ur5_f32):
        m = parallel.replicate_model(ur5_f32, mesh)
        assert m.screws_space.sharding.is_fully_replicated


class TestShardedCompute:
    def test_sharded_vmap_matches_local(self, mesh, ur5_f32):
        from manipulapy_tpu.kinematics import forward_kinematics

        rng = np.random.default_rng(0)
        qs = jnp.asarray(rng.uniform(-1, 1, (16, 6)), dtype=jnp.float32)
        f = parallel.sharded_vmap(forward_kinematics, mesh)
        out = f(ur5_f32, qs)
        local = jax.vmap(lambda q: forward_kinematics(ur5_f32, q))(qs)
        np.testing.assert_allclose(np.asarray(out), np.asarray(local), atol=1e-6)

    def test_sharded_vmap_ragged_batch(self, mesh, ur5_f32):
        """Batch not divisible by device count: padded internally,
        un-padded on return."""
        from manipulapy_tpu.kinematics import forward_kinematics

        qs = jnp.asarray(np.random.default_rng(1).uniform(-1, 1, (13, 6)), dtype=jnp.float32)
        out = parallel.sharded_vmap(forward_kinematics, mesh)(ur5_f32, qs)
        assert out.shape == (13, 4, 4)

    @pytest.mark.slow
    def test_distributed_rollout(self, mesh, ur5_f32):
        B, N = 16, 5
        rng = np.random.default_rng(2)
        q0 = jnp.asarray(rng.uniform(-0.5, 0.5, (B, 6)), dtype=jnp.float32)
        dq0 = jnp.zeros((B, 6), dtype=jnp.float32)
        taus = jnp.asarray(rng.uniform(-5, 5, (B, N, 6)), dtype=jnp.float32)
        qs, dqs, dds = parallel.distributed_rollout(ur5_f32, mesh, q0, dq0, taus, dt=0.01)
        assert qs.shape == (B, N, 6)
        assert np.all(np.isfinite(np.asarray(qs)))

    @pytest.mark.parametrize("B", [13, 64])
    def test_distributed_rollout_runs_dispatched_engine(self, mesh, B):
        """Each device runs the engine forward_dynamics_trajectory picks
        (the cgen scan on the CPU) on its shard; ragged B is padded and
        un-padded; the result is the one-device engine's."""
        from manipulapy_tpu import trajectory
        from manipulapy_tpu.ops.fd_step import build_rollout

        model = catalog.two_link_planar(dtype=jnp.float32)
        rng = np.random.default_rng(4)
        q0 = jnp.asarray(rng.uniform(-1, 1, (B, 2)), dtype=jnp.float32)
        dq0 = jnp.asarray(rng.uniform(-0.5, 0.5, (B, 2)), dtype=jnp.float32)
        taus = jnp.asarray(rng.uniform(-1, 1, (B, 4, 2)), dtype=jnp.float32)
        trajectory._ENGINE_CACHE.clear()
        out = parallel.distributed_rollout(model, mesh, q0, dq0, taus, dt=0.01)
        assert [k[-1] for k in trajectory._ENGINE_CACHE] == ["cgen"]
        assert out[0].sharding.num_devices == 8
        # Tolerances per quantity scale (ddq reaches ~1e2 rad/s^2): the
        # shard's program is compiled for another batch width, so f32
        # sums may round differently.
        ref = build_rollout(model, dt=0.01)(q0, dq0, taus)
        for a, b, tol in zip(out, ref, (1e-5, 1e-4, 1e-2)):
            assert a.shape == (B, 4, 2)
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol)

    def test_distributed_rollout_runs_kernel_on_gpu(self, mesh, monkeypatch):
        """With a GPU backend the sharded rollout runs the rollout kernel
        on every shard (interpreted here)."""
        from manipulapy_tpu import trajectory
        from manipulapy_tpu.ops import triton_rollout
        from manipulapy_tpu.ops.fd_step import build_rollout

        build = triton_rollout.build_triton_rollout
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        monkeypatch.setattr(triton_rollout, "build_triton_rollout",
                            lambda *a, **kw: build(*a, **kw, block=8, interpret=True))
        monkeypatch.setattr(trajectory, "_ENGINE_CACHE", {})
        model = catalog.two_link_planar(dtype=jnp.float32)
        rng = np.random.default_rng(5)
        q0 = jnp.asarray(rng.uniform(-1, 1, (20, 2)), dtype=jnp.float32)
        dq0 = jnp.zeros((20, 2), dtype=jnp.float32)
        taus = jnp.asarray(rng.uniform(-1, 1, (20, 3, 2)), dtype=jnp.float32)
        qs, dqs, _ = parallel.distributed_rollout(model, mesh, q0, dq0, taus, dt=0.01)
        assert [k[-1] for k in trajectory._ENGINE_CACHE] == ["kernel"]
        ref = build_rollout(model, dt=0.01)(q0, dq0, taus)
        np.testing.assert_allclose(np.asarray(qs), np.asarray(ref[0]), atol=1e-5)
        np.testing.assert_allclose(np.asarray(dqs), np.asarray(ref[1]), atol=1e-4)

    @pytest.mark.slow
    def test_distributed_ik(self, mesh, ur5_f32):
        from manipulapy_tpu.kinematics import forward_kinematics

        rng = np.random.default_rng(3)
        q_true = jnp.asarray(rng.uniform(-1.0, 1.0, (8, 6)), dtype=jnp.float32)
        targets = jax.vmap(lambda q: forward_kinematics(ur5_f32, q))(q_true)
        res = parallel.distributed_ik(
            ur5_f32, mesh, targets, q_true + 0.1, max_iterations=60, eomg=1e-3, ev=1e-3
        )
        assert np.asarray(res.success).mean() >= 0.75


class TestGraftEntry:
    def test_entry_compiles(self):
        import importlib.util, os

        spec = importlib.util.spec_from_file_location(
            "graft_entry", os.path.join(os.path.dirname(__file__), "..", "__graft_entry__.py")
        )
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        fn, args = mod.entry()
        out = jax.jit(fn)(*args)
        jax.block_until_ready(out)
        assert out[0].shape == args[0].shape

    @pytest.mark.slow
    def test_dryrun_multichip(self):
        import importlib.util, os

        spec = importlib.util.spec_from_file_location(
            "graft_entry2", os.path.join(os.path.dirname(__file__), "..", "__graft_entry__.py")
        )
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod.dryrun_multichip(8)


class TestScalingReport:
    def test_scaling_efficiency(self):
        eff = parallel.scaling_efficiency({1: 10.0, 2: 10.5, 4: 11.0})
        assert eff[1] == pytest.approx(1.0)
        assert 0.9 < eff[2] < 1.0
