"""AOT executable export/load tests (utils/aot.py — the cold-start
eliminator; no reference counterpart, its CUDA kernels rely on
numba/cupy JIT caches).

The CPU suite covers the artifact mechanics (save/load/validation) with
reduce-free programs: XLA:CPU's AOT loader cannot re-resolve reduction
kernel symbols across a serialize/deserialize boundary on this host
("Buffer Definition Event: Function wrapped_reduce not found"), so the
full solver round trips — which contain reductions — run on the card
under ``pytest -m gpu`` (subprocess, like test_gpu_device.py).
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

from manipulapy_tpu.utils import aot

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestPrimitives:
    def test_save_load_roundtrip_identity(self, tmp_path):
        # elementwise + matmul only (no reduction; see module docstring)
        @jax.jit
        def f(x, y):
            return jnp.tanh(x @ y) * 2.5, x + y

        x = jnp.ones((16, 16))
        y = jnp.eye(16) * 0.5
        path = os.path.join(tmp_path, "f.aot")
        aot.save_jitted(f, (x, y), path)
        loaded = aot.load_executable(path)
        assert loaded is not None
        fn, meta = loaded
        assert meta["backend"] == jax.default_backend()
        assert meta["num_devices"] == 1
        a1, b1 = f(x, y)
        a2, b2 = fn(x, y)
        try:
            np.testing.assert_array_equal(np.asarray(a1), np.asarray(a2))
            np.testing.assert_array_equal(np.asarray(b1), np.asarray(b2))
        except Exception as e:  # pragma: no cover - host-dependent
            if "not found" in str(e):
                pytest.skip(
                    "XLA:CPU AOT loader cannot re-resolve kernel symbols on "
                    "this host (machine-feature mismatch); the GPU path is "
                    "covered by the -m gpu roundtrip test"
                )
            raise

    def test_load_missing_returns_none(self, tmp_path):
        assert aot.load_executable(os.path.join(tmp_path, "nope.aot")) is None

    def test_load_wrong_env_returns_none(self, tmp_path):
        @jax.jit
        def f(x):
            return x + 1

        path = os.path.join(tmp_path, "f.aot")
        aot.save_jitted(f, (jnp.ones(4),), path)
        # corrupt the metadata to simulate a different backend
        import pickle

        blob = pickle.load(open(path, "rb"))
        blob["meta"]["backend"] = "not_a_backend"
        pickle.dump(blob, open(path, "wb"))
        assert aot.load_executable(path) is None

    def test_load_corrupt_file_returns_none(self, tmp_path):
        path = os.path.join(tmp_path, "junk.aot")
        with open(path, "wb") as f:
            f.write(b"not a pickle at all")
        assert aot.load_executable(path) is None

    def test_artifact_path_contains_backend(self):
        p = aot.artifact_path("thing", "/tmp/aot_root")
        assert jax.default_backend() in p and p.endswith("thing.aot")


_DEVICE_SCRIPT = r"""
import json, os, sys, time
import jax, jax.numpy as jnp
import numpy as np

if jax.default_backend() != "gpu":
    print(json.dumps({"skip": f"no GPU backend (got {jax.default_backend()})"}))
    sys.exit(0)

sys.path.insert(0, %(repo)r)
from manipulapy_tpu.models import catalog
from manipulapy_tpu.mpc import build_tracking_mpc
from manipulapy_tpu.utils import aot

model = catalog.two_link_planar(dtype=jnp.float32)
n = model.num_joints
H = 10
q_goal = jnp.asarray([0.4, -0.3], jnp.float32)
mpc = build_tracking_mpc(model, q_goal, horizon=H, dt=0.02, iterations=2)
path = os.path.join(%(tmp)r, "planar_lat.aot")
aot.save_tracking_mpc(mpc, path)

solve = aot.load_tracking_mpc(path)
if solve is None:
    print(json.dumps({"error": "load returned None"})); sys.exit(1)
x0 = jnp.zeros(2 * n, jnp.float32)
us0 = jnp.zeros((H, n), jnp.float32)
us_a, xs_a, cost_a = mpc.solve(x0, us0)
t0 = time.perf_counter()
us_b, xs_b, cost_b = solve(x0, us0)
jax.block_until_ready(cost_b)
first_solve_s = time.perf_counter() - t0
# retarget through the loaded wrapper
g2 = jnp.asarray([0.1, 0.2], jnp.float32)
us_c, _, cost_c = mpc.solve(x0, us0, q_goal_new=g2)
us_d, _, cost_d = solve(x0, us0, q_goal=g2)
print(json.dumps({
    "max_us_diff": float(jnp.abs(us_a - us_b).max()),
    "cost_diff": abs(float(cost_a) - float(cost_b)),
    "retarget_us_diff": float(jnp.abs(us_c - us_d).max()),
    "retarget_cost_diff": abs(float(cost_c) - float(cost_d)),
    "first_solve_s": first_solve_s,
}))
"""


@pytest.mark.gpu
def test_tracking_mpc_aot_roundtrip_on_device(tmp_path):
    """Full solver AOT round trip on the card: the loaded executable must
    match the in-process solver bit-for-bit and solve without compiling."""
    if shutil.which("nvidia-smi") is None:
        pytest.skip("no GPU on this host (nvidia-smi not found)")
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX_PLATFORMS")}
    out = subprocess.run(
        [sys.executable, "-c", _DEVICE_SCRIPT % {"repo": _REPO, "tmp": str(tmp_path)}],
        capture_output=True, text=True, timeout=1200, env=env,
    )
    lines = [l for l in out.stdout.strip().splitlines() if l.startswith("{")]
    assert lines, f"no JSON from device subprocess:\n{out.stdout}\n{out.stderr[-2000:]}"
    data = json.loads(lines[-1])
    if "skip" in data:
        pytest.skip(data["skip"])
    assert "error" not in data, data
    assert data["max_us_diff"] == 0.0
    assert data["cost_diff"] == 0.0
    assert data["retarget_us_diff"] == 0.0
    assert data["retarget_cost_diff"] == 0.0
    assert data["first_solve_s"] < 10.0
