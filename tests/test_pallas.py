"""Rollout kernel tests (ops/triton_rollout.py) and the dispatch policy.

The kernel runs in the Pallas interpreter here and is compared with the
cgen XLA scan (``ops/fd_step.py::build_rollout``) — the same emitted
dynamics, so agreement is at f32 roundoff. Its Triton lowering is
checked by lowering for CUDA on this host (no card needed); the compiled
kernel on the card is checked by ``chip_smoke.py``. Small robots
(2-link planar, 3-link chain) keep the interpret-mode compiles cheap.
"""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from manipulapy_tpu.models import catalog
from manipulapy_tpu.ops import dispatch
from manipulapy_tpu.ops.fd_step import build_rollout
from manipulapy_tpu.ops.triton_rollout import build_triton_rollout

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODELS = {
    "planar2": lambda: catalog.two_link_planar(dtype=jnp.float32),
    "chain3": lambda: catalog.serial_chain(3, dtype=jnp.float32),
}


def _data(n, B, N, seed=0):
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    q0 = jax.random.uniform(k1, (B, n), minval=-1, maxval=1, dtype=jnp.float32)
    dq0 = jax.random.uniform(k2, (B, n), minval=-0.5, maxval=0.5, dtype=jnp.float32)
    taus = jax.random.uniform(k3, (B, N, n), minval=-1, maxval=1, dtype=jnp.float32)
    return q0, dq0, taus


class TestTritonRolloutInterpret:
    @pytest.mark.parametrize("intRes", [1, 3])
    @pytest.mark.parametrize("robot", sorted(MODELS))
    def test_matches_cgen_scan(self, robot, intRes):
        model = MODELS[robot]()
        q0, dq0, taus = _data(model.num_joints, 64, 6)
        ker = build_triton_rollout(model, dt=0.01, intRes=intRes, block=32,
                                   interpret=True)
        ref = build_rollout(model, dt=0.01, intRes=intRes)
        # ddq reaches ~1e2 rad/s^2 here; tolerances follow each quantity's
        # scale (f32 fusion order, not a difference in the math).
        for a, b, tol in zip(ker(q0, dq0, taus), ref(q0, dq0, taus), (1e-5, 1e-4, 1e-2)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol)

    @pytest.mark.parametrize("B", [1, 100, 257])
    def test_ragged_batch_matches_unpadded(self, B):
        """B is padded to a block multiple inside the wrapper; each
        scenario's result must not depend on its neighbours or the pad."""
        model = MODELS["planar2"]()
        q0, dq0, taus = _data(2, 300, 4, seed=1)
        ker = build_triton_rollout(model, block=64, interpret=True)
        full = ker(q0, dq0, taus)
        part = ker(q0[:B], dq0[:B], taus[:B])
        for x, y in zip(full, part):
            assert y.shape == (B, 4, 2)
            np.testing.assert_array_equal(np.asarray(x[:B]), np.asarray(y))

    def test_output_contract(self):
        """Row 0 is the initial state; ddqs[t] is the step's acceleration;
        row t+1 follows from row t by the semi-implicit Euler update."""
        model = MODELS["chain3"]()
        q0, dq0, taus = _data(3, 8, 5, seed=2)
        qs, dqs, ddqs = build_triton_rollout(
            model, dt=0.01, block=8, interpret=True
        )(q0, dq0, taus)
        assert qs.shape == dqs.shape == ddqs.shape == (8, 5, 3)
        assert qs.dtype == jnp.float32
        np.testing.assert_array_equal(np.asarray(qs[:, 0]), np.asarray(q0))
        np.testing.assert_array_equal(np.asarray(dqs[:, 0]), np.asarray(dq0))
        dq1 = np.asarray(dqs[:, 0] + 0.01 * ddqs[:, 0])
        np.testing.assert_allclose(np.asarray(dqs[:, 1]), dq1, atol=1e-6)

    def test_block_must_be_power_of_two(self):
        with pytest.raises(ValueError, match="power of two"):
            build_triton_rollout(MODELS["planar2"](), block=96)

    def test_intres_validated(self):
        with pytest.raises(ValueError, match="intRes"):
            build_triton_rollout(MODELS["planar2"](), intRes=0)

    @pytest.mark.parametrize("block", [32, 128, 256])
    def test_lowers_for_cuda(self, block):
        """The kernel's Triton lowering at real widths (UR5, N=50, ragged
        B) runs here without a card: Pallas emits the Triton module at
        lowering time, which rejects non-power-of-two value shapes and
        unsupported primitives."""
        model = catalog.ur5(dtype=jnp.float32)
        ker = build_triton_rollout(model, block=block)
        B, N = 1000, 50
        args = (
            jax.ShapeDtypeStruct((B, 6), jnp.float32),
            jax.ShapeDtypeStruct((B, 6), jnp.float32),
            jax.ShapeDtypeStruct((B, N, 6), jnp.float32),
        )
        text = ker.trace(*args).lower(lowering_platforms=("cuda",)).as_text()
        assert "triton" in text


class TestDispatchPolicy:
    @pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
    @pytest.mark.parametrize("backend", ["gpu", "cpu"])
    def test_kernel_only_for_f32_on_gpu(self, monkeypatch, backend, dtype):
        monkeypatch.setattr(jax, "default_backend", lambda: backend)
        want = backend == "gpu" and dtype == jnp.float32
        assert dispatch.rollout_kernel_wanted(dtype) is want

    def test_unbatched_never_takes_kernel(self, monkeypatch):
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        assert not dispatch.rollout_kernel_wanted(jnp.float32, batched=False)

    @pytest.mark.parametrize("B", [1, 4096])
    def test_public_api_serves_scan_on_cpu(self, monkeypatch, B):
        """On the CPU every batch, small or large, is served by the cgen
        scan under its own cache key."""
        from manipulapy_tpu import trajectory

        monkeypatch.setattr(trajectory, "_ENGINE_CACHE", {})
        model = MODELS["planar2"]()
        q0, dq0, taus = _data(2, B, 4, seed=4)
        qs, dqs, ddqs = trajectory.forward_dynamics_trajectory(model, q0, dq0, taus)
        assert qs.shape == (B, 4, 2)
        assert [k[-1] for k in trajectory._ENGINE_CACHE] == ["cgen"]

    @pytest.mark.parametrize("B", [1, 259])
    def test_public_api_serves_kernel_on_gpu(self, monkeypatch, B):
        """forward_dynamics_trajectory routes an f32 batch of any size to
        the kernel when the backend is a GPU (interpreted here) and caches
        it under its own key; results match the scan."""
        from manipulapy_tpu import trajectory
        from manipulapy_tpu.ops import triton_rollout

        built = []

        def interpreted(*args, **kw):
            built.append(kw)
            return build_triton_rollout(*args, **kw, interpret=True)

        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        monkeypatch.setattr(triton_rollout, "build_triton_rollout", interpreted)
        monkeypatch.setattr(trajectory, "_ENGINE_CACHE", {})
        model = MODELS["planar2"]()
        q0, dq0, taus = _data(2, B, 4, seed=3)
        out = trajectory.forward_dynamics_trajectory(model, q0, dq0, taus)
        assert len(built) == 1
        assert [k[-1] for k in trajectory._ENGINE_CACHE] == ["kernel"]
        ref = build_rollout(model, dt=0.01)(q0, dq0, taus)
        for a, b, tol in zip(out, ref, (1e-5, 1e-4, 1e-2)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol)


class TestConfigureCache:
    def test_env_dir_is_used_and_nothing_set(self, monkeypatch, tmp_path):
        from manipulapy_tpu.utils.config import configure_cache

        calls = []
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
        assert configure_cache() == str(tmp_path)
        assert calls == []

    def test_default_is_fixed_checkout_path(self, monkeypatch):
        from manipulapy_tpu.utils.config import configure_cache

        calls = []
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
        path = configure_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert ("jax_compilation_cache_dir", path) in calls
        assert configure_cache() == path  # same path on every call


class TestChipSmokeRefuses:
    """chip_smoke.py must fail, and print no result line, where there is
    no GPU and where the program is missing."""

    def _run(self, script, cwd):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        return subprocess.run(
            [sys.executable, script], cwd=cwd, env=env,
            capture_output=True, text=True, timeout=300,
        )

    def test_exits_nonzero_without_gpu(self):
        proc = self._run(os.path.join(REPO, "chip_smoke.py"), REPO)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout

    def test_exits_nonzero_alone(self, tmp_path):
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        proc = self._run(os.path.join(tmp_path, "chip_smoke.py"), tmp_path)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
