"""MPC solver tests: the iLQR loop must actually solve control problems
(regulation on the 2R arm, cost decrease, control-limit respect) and the
receding-horizon step must track (BASELINE config #3 shape, tiny sizes
for CI)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from manipulapy_tpu import dynamics
from manipulapy_tpu.mpc import (
    ILQRParams,
    ilqr,
    make_step_fn,
    make_tracking_costs,
    mpc_step,
    quadratic_tracking_cost,
)

G0 = jnp.zeros(3)  # gravity-free keeps the toy problems well-conditioned


@pytest.fixture(scope="module")
def planar2_f64():
    from manipulapy_tpu.models import catalog

    return catalog.two_link_planar(dtype=jnp.float64)


class TestILQRLinearSystem:
    def test_solves_double_integrator(self):
        """Sanity on a known LQR problem: 1-D double integrator reaches
        the origin."""
        dt = 0.1

        def step(x, u):
            p, v = x[0], x[1]
            v2 = v + u[0] * dt
            return jnp.asarray([p + v2 * dt, v2])

        cost = quadratic_tracking_cost(jnp.zeros(2), w_q=1.0, w_dq=0.1, w_u=1e-3)

        def terminal(x):
            return 10.0 * jnp.sum(x**2)

        params = ILQRParams(horizon=30, dt=dt, iterations=15)
        x0 = jnp.asarray([2.0, 0.0])
        res = ilqr(step, cost, terminal, x0, jnp.zeros((30, 1)), params)
        assert float(jnp.abs(res.xs[-1][0])) < 0.1
        assert np.isfinite(float(res.cost))


class TestILQRManipulator:
    def test_regulates_to_goal(self, planar2_f64):
        model = planar2_f64
        params = ILQRParams(horizon=25, dt=0.05, iterations=12)
        step = make_step_fn(model, params.dt, g=G0)
        q_goal = jnp.asarray([0.6, -0.4])
        running, terminal = make_tracking_costs(model, q_goal, w_terminal=500.0)
        x0 = jnp.zeros(4, dtype=jnp.float64)
        res = ilqr(step, running, terminal, x0, jnp.zeros((25, 2), dtype=jnp.float64), params)
        q_final = np.asarray(res.xs[-1][:2])
        np.testing.assert_allclose(q_final, np.asarray(q_goal), atol=0.05)

    def test_cost_decreases_from_init(self, planar2_f64):
        model = planar2_f64
        params = ILQRParams(horizon=20, dt=0.05, iterations=8)
        step = make_step_fn(model, params.dt, g=G0)
        running, terminal = make_tracking_costs(model, jnp.asarray([0.5, 0.5]))
        x0 = jnp.zeros(4, dtype=jnp.float64)
        us0 = jnp.zeros((20, 2), dtype=jnp.float64)

        # Initial rollout cost:
        from manipulapy_tpu.mpc.ilqr import _rollout

        xs0 = _rollout(step, x0, us0)
        ts = jnp.arange(20)
        c0 = float(
            jnp.sum(jax.vmap(running)(xs0[:-1], us0, ts)) + terminal(xs0[-1])
        )
        res = ilqr(step, running, terminal, x0, us0, params)
        assert float(res.cost) < c0

    def test_respects_control_limits(self, planar2_f64):
        model = planar2_f64
        params = ILQRParams(horizon=15, dt=0.05, iterations=6)
        step = make_step_fn(model, params.dt, g=G0)
        running, terminal = make_tracking_costs(model, jnp.asarray([1.5, -1.5]))
        u_max = jnp.asarray([3.0, 3.0])
        res = ilqr(
            step, running, terminal, jnp.zeros(4, dtype=jnp.float64),
            jnp.zeros((15, 2), dtype=jnp.float64), params,
            u_min=-u_max, u_max=u_max,
        )
        us = np.asarray(res.us)
        assert np.all(us <= 3.0 + 1e-9) and np.all(us >= -3.0 - 1e-9)

    @pytest.mark.slow
    def test_batched_solves_vmap(self, planar2_f64):
        """Scenario batching: vmapped solves agree with individual ones."""
        model = planar2_f64
        params = ILQRParams(horizon=10, dt=0.05, iterations=4)
        step = make_step_fn(model, params.dt, g=G0)
        goals = jnp.asarray([[0.3, -0.2], [-0.4, 0.5]])

        def solve(qg):
            running, terminal = make_tracking_costs(model, qg)
            return ilqr(
                step, running, terminal, jnp.zeros(4, dtype=jnp.float64),
                jnp.zeros((10, 2), dtype=jnp.float64), params,
            ).cost

        # NOTE: make_tracking_costs closes over qg; vmap via explicit cost.
        def solve_traced(qg):
            x_goal = jnp.concatenate([qg, jnp.zeros_like(qg)])
            running = quadratic_tracking_cost(x_goal, 10.0, 0.5, 1e-4)

            def terminal(x):
                err = x - x_goal
                return 100.0 * (jnp.sum(err[:2] ** 2) + 0.1 * jnp.sum(err[2:] ** 2))

            return ilqr(
                step, running, terminal, jnp.zeros(4, dtype=jnp.float64),
                jnp.zeros((10, 2), dtype=jnp.float64), params,
            ).cost

        batched = jax.vmap(solve_traced)(goals)
        for i in range(2):
            np.testing.assert_allclose(
                float(batched[i]), float(solve_traced(goals[i])), rtol=1e-6
            )


class TestMPCLoop:
    def test_receding_horizon_tracks(self, planar2_f64):
        """Closed receding-horizon loop drives the arm to the goal — the
        full MPC behavior at toy scale."""
        model = planar2_f64
        params = ILQRParams(horizon=12, dt=0.05, iterations=4)
        step = make_step_fn(model, params.dt, g=G0)
        q_goal = jnp.asarray([0.5, -0.3])
        running, terminal = make_tracking_costs(model, q_goal, w_terminal=300.0)

        x = jnp.zeros(4, dtype=jnp.float64)
        us = jnp.zeros((12, 2), dtype=jnp.float64)
        for _ in range(25):
            u, us, _ = mpc_step(step, running, terminal, x, us, params)
            x = step(x, u)
        np.testing.assert_allclose(np.asarray(x[:2]), np.asarray(q_goal), atol=0.05)
        assert np.abs(np.asarray(x[2:])).max() < 0.2


@pytest.mark.slow
class TestParallelRiccati:
    """Associative-scan Riccati (mpc/pscan.py) vs the sequential sweep."""

    def _lqr_problem(self, H=20, nx=6, nu=3, seed=0, dtype=jnp.float64):
        rng = np.random.default_rng(seed)
        A = jnp.asarray(np.eye(nx) + 0.01 * rng.standard_normal((H, nx, nx)), dtype)
        B = jnp.asarray(0.1 * rng.standard_normal((H, nx, nu)), dtype)
        lx = jnp.asarray(rng.standard_normal((H, nx)), dtype)
        lu = jnp.asarray(rng.standard_normal((H, nu)), dtype)
        W = rng.standard_normal((H, nx, nx))
        lxx = jnp.asarray(np.eye(nx) + 0.1 * (W @ W.transpose(0, 2, 1)), dtype)
        Wu = rng.standard_normal((H, nu, nu))
        luu = jnp.asarray(np.eye(nu) + 0.1 * (Wu @ Wu.transpose(0, 2, 1)), dtype)
        lux = jnp.asarray(0.05 * rng.standard_normal((H, nu, nx)), dtype)
        Vx_T = jnp.asarray(rng.standard_normal(nx), dtype)
        WT = rng.standard_normal((nx, nx))
        Vxx_T = jnp.asarray(np.eye(nx) + 0.1 * (WT @ WT.T), dtype)
        return A, B, lx, lu, lxx, luu, lux, Vx_T, Vxx_T

    def _sequential(self, A, B, lx, lu, lxx, luu, lux, Vx_T, Vxx_T):
        from manipulapy_tpu.ops.smallinalg import (
            chol_factor_small,
            chol_solve_small,
            chol_solve_small_mat,
        )

        def bstep(carry, inp):
            Vx, Vxx = carry
            A_t, B_t, lx_t, lu_t, lxx_t, luu_t, lux_t = inp
            Qx = lx_t + A_t.T @ Vx
            Qu = lu_t + B_t.T @ Vx
            Qxx = lxx_t + A_t.T @ Vxx @ A_t
            Quu = luu_t + B_t.T @ Vxx @ B_t
            Qux = lux_t + B_t.T @ Vxx @ A_t
            L = chol_factor_small(Quu)
            k = -chol_solve_small(L, Qu)
            K = -chol_solve_small_mat(L, Qux)
            Vx2 = Qx + K.T @ Quu @ k + K.T @ Qu + Qux.T @ k
            Vxx2 = Qxx + K.T @ Quu @ K + K.T @ Qux + Qux.T @ K
            return (Vx2, 0.5 * (Vxx2 + Vxx2.T)), (k, K)

        (_, _), (ks, Ks) = jax.lax.scan(
            bstep, (Vx_T, Vxx_T), (A, B, lx, lu, lxx, luu, lux), reverse=True
        )
        return ks, Ks

    def test_matches_sequential_f64(self):
        from manipulapy_tpu.mpc.pscan import parallel_riccati

        prob = self._lqr_problem(dtype=jnp.float64)
        ks_p, Ks_p, dV, ok = parallel_riccati(*prob)
        ks_s, Ks_s = self._sequential(*prob)
        assert bool(ok)
        np.testing.assert_allclose(np.asarray(ks_p), np.asarray(ks_s), atol=1e-9)
        np.testing.assert_allclose(np.asarray(Ks_p), np.asarray(Ks_s), atol=1e-9)

    def test_matches_sequential_f32(self):
        from manipulapy_tpu.mpc.pscan import parallel_riccati

        prob = self._lqr_problem(H=50, dtype=jnp.float32)
        ks_p, Ks_p, _, ok = parallel_riccati(*prob)
        ks_s, Ks_s = self._sequential(*prob)
        assert bool(ok)
        scale = float(jnp.max(jnp.abs(ks_s))) + 1.0
        assert float(jnp.max(jnp.abs(ks_p - ks_s))) / scale < 1e-4
        assert float(jnp.max(jnp.abs(Ks_p - Ks_s))) < 1e-3

    def test_ilqr_with_parallel_riccati_converges(self):
        """Full iLQR on the 2-link arm, parallel backward: same solution
        quality as the sequential solver."""
        from manipulapy_tpu.models import catalog
        from manipulapy_tpu.mpc import ILQRParams, ilqr, make_step_fn, make_tracking_costs

        model = catalog.two_link_planar(dtype=jnp.float32)
        step_fn = make_step_fn(model, 0.02, fused=False)
        q_goal = jnp.asarray([0.6, -0.4], jnp.float32)
        running, terminal = make_tracking_costs(model, q_goal)
        x0 = jnp.zeros(4, jnp.float32)
        us0 = jnp.zeros((30, 2), jnp.float32)
        res_seq = ilqr(step_fn, running, terminal, x0, us0,
                       ILQRParams(horizon=30, dt=0.02, iterations=8))
        res_par = ilqr(step_fn, running, terminal, x0, us0,
                       ILQRParams(horizon=30, dt=0.02, iterations=8, parallel_riccati=True))
        assert float(res_par.cost) <= float(res_seq.cost) * 1.05 + 1e-3
        # Same solution as the sequential backward pass (not an absolute
        # reach gate: 8 iterations on a 30-step horizon leaves a small
        # steady tracking offset in both solvers).
        np.testing.assert_allclose(
            np.asarray(res_par.xs[-1, :2]), np.asarray(res_seq.xs[-1, :2]), atol=0.02
        )


class TestFusedTrackingMPC:
    """Tracking-MPC builder (mpc/tracking.py) vs the generic iLQR."""

    def test_matches_generic_solver(self):
        from manipulapy_tpu.models import catalog
        from manipulapy_tpu.mpc import ILQRParams, ilqr, make_step_fn, make_tracking_costs
        from manipulapy_tpu.mpc import build_tracking_mpc

        model = catalog.two_link_planar(dtype=jnp.float32)
        q_goal = jnp.asarray([0.6, -0.4], jnp.float32)
        H, dt, iters = 30, 0.02, 6
        step_fn = make_step_fn(model, dt)
        running, terminal = make_tracking_costs(model, q_goal)
        res = ilqr(
            step_fn, running, terminal, jnp.zeros(4, jnp.float32),
            jnp.zeros((H, 2), jnp.float32), ILQRParams(horizon=H, dt=dt, iterations=iters),
        )
        mpc = build_tracking_mpc(model, q_goal, H, dt, iterations=iters)
        us, xs, cost = mpc.solve(jnp.zeros(4, jnp.float32), jnp.zeros((H, 2), jnp.float32))
        # Same math end-to-end: the builder wraps this very solver.
        np.testing.assert_allclose(float(cost), float(res.cost), rtol=1e-5)
        # f32 roundoff: the two programs may fuse/order the same math
        # differently.
        np.testing.assert_allclose(np.asarray(xs[-1]), np.asarray(res.xs[-1]), atol=5e-4)
        np.testing.assert_allclose(np.asarray(us), np.asarray(res.us), atol=5e-3)

    def test_respects_torque_limits(self):
        from manipulapy_tpu.models import catalog
        from manipulapy_tpu.mpc import build_tracking_mpc

        model = catalog.two_link_planar(dtype=jnp.float32)
        mpc = build_tracking_mpc(
            model, jnp.asarray([1.5, 0.5], jnp.float32), 20, 0.02,
            iterations=4, u_limit=jnp.asarray([3.0, 2.0]),
        )
        us, xs, cost = mpc.solve(jnp.zeros(4, jnp.float32), jnp.zeros((20, 2), jnp.float32))
        assert float(jnp.max(jnp.abs(us[:, 0]))) <= 3.0 + 1e-5
        assert float(jnp.max(jnp.abs(us[:, 1]))) <= 2.0 + 1e-5

    def test_linearize_matches_jacfwd(self):
        """The plane-wise cgen step the builders solve with has the same
        A = df/dx as the generic step."""
        from manipulapy_tpu.models import catalog
        from manipulapy_tpu.mpc import make_step_fn
        from manipulapy_tpu.ops.fd_step import build_fd_step_planes

        model = catalog.two_link_planar(dtype=jnp.float32)
        H, dt = 10, 0.02
        step_fn = make_step_fn(model, dt)
        rng = np.random.default_rng(3)
        xs = jnp.asarray(rng.uniform(-0.5, 0.5, (H, 4)), jnp.float32)
        us = jnp.asarray(rng.uniform(-2, 2, (H, 2)), jnp.float32)
        A_ref = jax.vmap(jax.jacfwd(step_fn, 0))(xs, us)

        n, step_planes = build_fd_step_planes(
            model, dt=dt, clip_limits=True, clip_velocity=False
        )

        def step_vec(x, u):
            q2, dq2, _ = step_planes(
                [x[i] for i in range(2)], [x[2 + i] for i in range(2)],
                [u[j] for j in range(2)],
            )
            return jnp.stack(list(q2) + list(dq2))

        A_pl = jax.vmap(jax.jacfwd(step_vec, 0))(xs, us)
        np.testing.assert_allclose(np.asarray(A_pl), np.asarray(A_ref), atol=1e-5)


class TestBatchFusedMPC:
    """Batched builder (mpc/tracking.py): per-scenario goals, line search
    and regularization. Parity bar: each scenario matches an independent
    generic iLQR solve."""

    def test_matches_generic_per_scenario(self):
        from manipulapy_tpu.models import catalog
        from manipulapy_tpu.mpc import ILQRParams, ilqr, make_step_fn, make_tracking_costs
        from manipulapy_tpu.mpc import build_batch_tracking_mpc

        model = catalog.two_link_planar(dtype=jnp.float32)
        H, dt, iters, B = 20, 0.02, 4, 3
        rng = np.random.default_rng(0)
        x0s = jnp.asarray(rng.uniform(-0.3, 0.3, (B, 4)), jnp.float32)
        goals = jnp.asarray(rng.uniform(-0.8, 0.8, (B, 2)), jnp.float32)

        mpc = build_batch_tracking_mpc(
            model, goals, B, H, dt, iterations=iters
        )
        us_b, xs_b, cost_b = mpc.solve(x0s, jnp.zeros((B, H, 2), jnp.float32))
        assert us_b.shape == (B, H, 2) and xs_b.shape == (B, H + 1, 4)

        step_fn = make_step_fn(model, dt)
        for s in range(B):
            running, terminal = make_tracking_costs(model, goals[s])
            res = ilqr(
                step_fn, running, terminal, x0s[s], jnp.zeros((H, 2), jnp.float32),
                ILQRParams(horizon=H, dt=dt, iterations=iters),
            )
            np.testing.assert_allclose(float(cost_b[s]), float(res.cost), rtol=1e-5)
            np.testing.assert_allclose(
                np.asarray(xs_b[s, -1]), np.asarray(res.xs[-1]), atol=5e-4
            )
            np.testing.assert_allclose(
                np.asarray(us_b[s]), np.asarray(res.us), atol=5e-3
            )

    def test_shared_goal_and_torque_limits(self):
        from manipulapy_tpu.models import catalog
        from manipulapy_tpu.mpc import build_batch_tracking_mpc

        model = catalog.two_link_planar(dtype=jnp.float32)
        B, H = 2, 12
        mpc = build_batch_tracking_mpc(
            model, jnp.asarray([1.0, 0.3], jnp.float32), B, H, 0.02,
            iterations=3, u_limit=jnp.asarray([3.0, 2.0]),
        )
        x0s = jnp.zeros((B, 4), jnp.float32).at[1, 0].set(0.2)
        us, xs, cost = mpc.solve(x0s, jnp.zeros((B, H, 2), jnp.float32))
        assert float(jnp.max(jnp.abs(us[:, :, 0]))) <= 3.0 + 1e-5
        assert float(jnp.max(jnp.abs(us[:, :, 1]))) <= 2.0 + 1e-5
        # Different initial states must give different solutions.
        assert float(jnp.max(jnp.abs(us[0] - us[1]))) > 1e-4
        # And both scenarios make progress toward the goal.
        assert float(jnp.abs(xs[0, -1, 0] - 1.0)) < float(jnp.abs(xs[0, 0, 0] - 1.0))

    def test_goal_argument_matches_baked(self):
        """solve(..., q_goal) must equal a solver built with those goals."""
        from manipulapy_tpu.models import catalog
        from manipulapy_tpu.mpc import build_batch_tracking_mpc

        model = catalog.two_link_planar(dtype=jnp.float32)
        B, H = 2, 10
        g1 = jnp.asarray([[0.5, -0.2], [0.2, 0.4]], jnp.float32)
        g2 = jnp.asarray([[-0.3, 0.6], [0.7, 0.1]], jnp.float32)
        x0 = jnp.zeros((B, 4), jnp.float32)
        us0 = jnp.zeros((B, H, 2), jnp.float32)
        mpc1 = build_batch_tracking_mpc(model, g1, B, H, 0.02, iterations=3)
        mpc2 = build_batch_tracking_mpc(model, g2, B, H, 0.02, iterations=3)
        a = mpc1.solve(x0, us0, g2)
        b = mpc2.solve(x0, us0)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))

    def test_shared_goal_retarget_runtime(self):
        """A (n,) runtime goal broadcasts like the build-time path."""
        from manipulapy_tpu.models import catalog
        from manipulapy_tpu.mpc import build_batch_tracking_mpc

        model = catalog.two_link_planar(dtype=jnp.float32)
        B, H = 2, 8
        mpc = build_batch_tracking_mpc(
            model, jnp.asarray([0.5, -0.2], jnp.float32), B, H, 0.02,
            iterations=2,
        )
        x0 = jnp.zeros((B, 4), jnp.float32)
        us0 = jnp.zeros((B, H, 2), jnp.float32)
        shared = jnp.asarray([-0.3, 0.6], jnp.float32)
        a = mpc.solve(x0, us0, shared)  # (n,) shape
        b = mpc.solve(x0, us0, jnp.broadcast_to(shared, (B, 2)))
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))

    def test_batch_mpc_step_receding_horizon(self):
        from manipulapy_tpu.models import catalog
        from manipulapy_tpu.mpc import make_step_fn
        from manipulapy_tpu.mpc import batch_mpc_step, build_batch_tracking_mpc

        model = catalog.two_link_planar(dtype=jnp.float32)
        B, H = 2, 10
        goals = jnp.asarray([[0.6, -0.3], [-0.4, 0.5]], jnp.float32)
        mpc = build_batch_tracking_mpc(model, goals, B, H, 0.02, iterations=3)
        step = make_step_fn(model, 0.02)
        x = jnp.zeros((B, 4), jnp.float32)
        us_warm = jnp.zeros((B, H, 2), jnp.float32)
        err0 = float(jnp.max(jnp.abs(x[:, :2] - goals)))
        for _ in range(6):
            u, us_warm, _ = batch_mpc_step(mpc, x, us_warm)
            x = jax.vmap(step)(x, u)
        err = float(jnp.max(jnp.abs(x[:, :2] - goals)))
        assert err < err0  # both scenarios progress toward their own goals


class TestFusedGoalArgument:
    def test_single_solver_goal_argument_matches_baked(self):
        from manipulapy_tpu.models import catalog
        from manipulapy_tpu.mpc import build_tracking_mpc

        model = catalog.two_link_planar(dtype=jnp.float32)
        H = 12
        g1 = jnp.asarray([0.5, -0.2], jnp.float32)
        g2 = jnp.asarray([-0.3, 0.6], jnp.float32)
        x0 = jnp.zeros(4, jnp.float32)
        us0 = jnp.zeros((H, 2), jnp.float32)
        mpc1 = build_tracking_mpc(model, g1, H, 0.02, iterations=3)
        mpc2 = build_tracking_mpc(model, g2, H, 0.02, iterations=3)
        a = mpc1.solve(x0, us0, g2)
        b = mpc2.solve(x0, us0)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
