"""On-card parity: the f32 core and the rollout kernel on the GPU.

The fast suite runs everything on CPU/x64 (see ``conftest.py``) and tests
Pallas kernels in interpret mode. ``pytest -m gpu`` runs this module,
which drives the f32 kinematics/dynamics core and the public rollout
(served by the GPU kernel) on the default backend in a SUBPROCESS — the
conftest pins this process's jax to CPU, and a platform can't be
switched after backend init; this process never opens the card, so the
subprocess is the only one on it — and compares against the f64 oracle
computed here. ``chip_smoke.py`` runs the same checks at full width.

Skips (not fails) when there is no GPU, mirroring the reference's
GPU-marker skip logic (``tests/conftest.py`` cuda markers).
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_DEVICE_SCRIPT = r"""
import json, sys
import jax, jax.numpy as jnp
import numpy as np

if jax.default_backend() != "gpu":
    print(json.dumps({"skip": f"no GPU backend (got {jax.default_backend()})"}))
    sys.exit(0)

sys.path.insert(0, %(repo)r)
from manipulapy_tpu import dynamics as dyn, kinematics as kin
from manipulapy_tpu import trajectory as traj
from manipulapy_tpu.models.robot_data import load_robot

model = load_robot("ur5")  # f32
n = int(model.num_joints)
rng = np.random.default_rng(11)
q = jnp.asarray(rng.uniform(-1.5, 1.5, (16, n)), jnp.float32)
dq = jnp.asarray(rng.uniform(-1, 1, (16, n)), jnp.float32)
tau = jnp.asarray(rng.uniform(-20, 20, (16, n)), jnp.float32)
g = jnp.asarray([0.0, 0.0, -9.81], jnp.float32)
f0 = jnp.zeros(6, jnp.float32)

out = {
    "fk": np.asarray(jax.jit(jax.vmap(lambda qq: kin.forward_kinematics(model, qq)))(q)).tolist(),
    "invdyn": np.asarray(
        jax.jit(jax.vmap(lambda a, b, c: dyn.inverse_dynamics(model, a, b, c, g, f0)))(q, dq, tau)
    ).tolist(),
    "fwddyn": np.asarray(
        jax.jit(jax.vmap(lambda a, b, c: dyn.forward_dynamics(model, a, b, c, g, f0)))(q, dq, tau)
    ).tolist(),
}

# Public rollout on the card (dispatched to the GPU kernel): B=2048.
B, N = 2048, 20
q0 = jnp.asarray(rng.uniform(-0.5, 0.5, (B, n)), jnp.float32)
dq0 = jnp.asarray(rng.uniform(-0.2, 0.2, (B, n)), jnp.float32)
taus = jnp.asarray(rng.uniform(-5, 5, (B, N, n)), jnp.float32)
qs, dqs, dds = traj.forward_dynamics_trajectory(model, q0, dq0, taus, dt=0.01, intRes=1)
out["rollout_q_tail"] = np.asarray(qs[:4, -1]).tolist()
out["rollout_finite"] = bool(jnp.all(jnp.isfinite(qs)) and jnp.all(jnp.isfinite(dqs)))
out["rollout_inputs"] = {
    "q0": np.asarray(q0[:4]).tolist(),
    "dq0": np.asarray(dq0[:4]).tolist(),
    "taus": np.asarray(taus[:4]).tolist(),
}
print(json.dumps(out))
""" % {"repo": _REPO}


@pytest.fixture(scope="module")
def device_out():
    if shutil.which("nvidia-smi") is None:
        pytest.skip("no GPU on this host (nvidia-smi not found)")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)  # let the default (GPU) backend resolve
    proc = subprocess.run(
        [sys.executable, "-c", _DEVICE_SCRIPT],
        capture_output=True, text=True, timeout=1200, env=env, cwd=_REPO,
    )
    assert proc.returncode == 0, f"device subprocess failed:\n{proc.stderr[-2000:]}"
    payload = json.loads(proc.stdout.strip().splitlines()[-1])
    if "skip" in payload:
        pytest.skip(payload["skip"])
    return payload


class TestOnDeviceF32Parity:
    def _oracle(self):
        from manipulapy_tpu import dynamics as dyn, kinematics as kin
        from manipulapy_tpu.models.robot_data import load_robot

        model = load_robot("ur5", dtype=jnp.float64)
        rng = np.random.default_rng(11)
        n = int(model.num_joints)
        q = rng.uniform(-1.5, 1.5, (16, n)).astype(np.float32).astype(np.float64)
        dq = rng.uniform(-1, 1, (16, n)).astype(np.float32).astype(np.float64)
        tau = rng.uniform(-20, 20, (16, n)).astype(np.float32).astype(np.float64)
        g = jnp.asarray([0.0, 0.0, -9.81])
        f0 = jnp.zeros(6)
        fk = jax.vmap(lambda qq: kin.forward_kinematics(model, qq))(jnp.asarray(q))
        iv = jax.vmap(lambda a, b, c: dyn.inverse_dynamics(model, a, b, c, g, f0))(
            jnp.asarray(q), jnp.asarray(dq), jnp.asarray(tau)
        )
        fw = jax.vmap(lambda a, b, c: dyn.forward_dynamics(model, a, b, c, g, f0))(
            jnp.asarray(q), jnp.asarray(dq), jnp.asarray(tau)
        )
        return np.asarray(fk), np.asarray(iv), np.asarray(fw)

    def test_core_matches_f64_oracle(self, device_out):
        fk64, iv64, fw64 = self._oracle()
        np.testing.assert_allclose(np.asarray(device_out["fk"]), fk64, atol=2e-5)
        np.testing.assert_allclose(np.asarray(device_out["invdyn"]), iv64, atol=1e-3)
        # fwddyn: norm-wise scaled gate (reference_parity.py rationale).
        fw32 = np.asarray(device_out["fwddyn"])
        rel = np.max(np.abs(fw32 - fw64), axis=-1) / np.maximum(
            1.0, np.max(np.abs(fw64), axis=-1)
        )
        assert rel.max() < 1e-3, rel.max()

    def test_rollout_on_card_matches_cpu(self, device_out):
        """The on-card rollout vs this process's CPU f64 generic scan, on
        the same inputs the device actually used."""
        from manipulapy_tpu import trajectory
        from manipulapy_tpu.models.robot_data import load_robot

        assert device_out["rollout_finite"]
        model = load_robot("ur5", dtype=jnp.float64)
        ins = device_out["rollout_inputs"]
        qs, _, _ = trajectory._forward_dynamics_trajectory_generic(
            model,
            jnp.asarray(ins["q0"]), jnp.asarray(ins["dq0"]), jnp.asarray(ins["taus"]),
            None, None, 0.01, 1,
        )
        np.testing.assert_allclose(
            np.asarray(device_out["rollout_q_tail"]), np.asarray(qs[:, -1]), atol=5e-4
        )
