"""IK initial-guess strategies: solution cache, smart and robust solvers.

Capability parity with the reference's ``ManipulaPy/ik_helpers.py``
(``IKInitialGuessCache``, ``ik_helpers.py:227-360``;
``adaptive_multi_start_ik``, ``ik_helpers.py:390-519``) and the
``smart_`` / ``robust_inverse_kinematics`` wrappers
(``kinematics.py:494-757``).

The cache is a host-side structure (it's warm-start *state*, the one
thing that legitimately lives outside jit); everything it feeds runs as
batched device solves. Where the reference retries strategies
*sequentially* with a fallback chain, ``robust_ik`` runs the whole
(strategy x damping x step-cap) schedule as ONE vmapped solve.
"""

from __future__ import annotations

from functools import partial
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .ik import (
    IKResult,
    extrapolate_guess,
    freeze_solve_kw,
    midpoint_guess,
    random_guesses,
    select_best,
    solve_ik,
    workspace_heuristic_guess,
)
from .models.robot import RobotModel

__all__ = ["IKInitialGuessCache", "smart_ik", "robust_ik", "adaptive_multi_start_ik"]


def _pose_distance(T_a: np.ndarray, T_b: np.ndarray, w_rot: float = 0.5) -> float:
    """Position + weighted rotation (chordal) distance between poses —
    the cache's similarity metric (``ik_helpers.py:252-270``)."""
    dp = float(np.linalg.norm(T_a[:3, 3] - T_b[:3, 3]))
    dR = float(np.linalg.norm(T_a[:3, :3] - T_b[:3, :3], "fro"))
    return dp + w_rot * dR


class IKInitialGuessCache:
    """k-NN cache of (pose -> solution) pairs with quality scores and
    FIFO eviction (reference ``IKInitialGuessCache``,
    ``ik_helpers.py:227-360``)."""

    def __init__(self, max_entries: int = 128, k: int = 3):
        self.max_entries = int(max_entries)
        self.k = int(k)
        self._poses: List[np.ndarray] = []
        self._solutions: List[np.ndarray] = []
        self._quality: List[float] = []
        # Lazily-materialized inserts: (pose, success_dev, theta_dev)
        # tuples whose device values have NOT been fetched yet: a
        # ``device_get`` waits for the device, so deferring the fetch to
        # the next lookup keeps ``smart_ik`` at one dispatch per call.
        self._pending: List[Tuple[np.ndarray, object, object]] = []

    def add_async(self, T: np.ndarray, success_dev, theta_dev) -> None:
        """Queue an insert whose (success, theta) are still device
        arrays; they are fetched in one batch at the next host-side
        access (lookup/add/len)."""
        # Start the device->host copies NOW without blocking: by the
        # time the next lookup materializes, the bytes are usually
        # already on the host and device_get returns immediately.
        for arr in (success_dev, theta_dev):
            copy_async = getattr(arr, "copy_to_host_async", None)
            if copy_async is not None:
                copy_async()
        self._pending.append((np.asarray(T, dtype=np.float64).copy(), success_dev, theta_dev))
        # A caller that never performs a host-side access (e.g. smart_ik
        # with a fixed non-'cached' strategy) must not grow _pending —
        # and the pinned device buffers — without bound.
        if len(self._pending) > self.max_entries:
            self._materialize()

    def _materialize(self) -> None:
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        fetched = jax.device_get([(s, th) for _, s, th in pending])
        for (T, _, _), (success, theta) in zip(pending, fetched):
            if bool(success):
                self.add(T, np.asarray(theta, dtype=np.float64))

    def __len__(self) -> int:
        self._materialize()
        return len(self._poses)

    def add(self, T: np.ndarray, theta: np.ndarray, quality: float = 1.0) -> None:
        """Insert a solved pose; FIFO-evict beyond capacity. Pending
        async inserts are materialized FIRST so insertion order (and
        therefore FIFO eviction order) matches solve order."""
        self._materialize()
        self._poses.append(np.asarray(T, dtype=np.float64).copy())
        self._solutions.append(np.asarray(theta, dtype=np.float64).copy())
        self._quality.append(float(quality))
        if len(self._poses) > self.max_entries:
            self._poses.pop(0)
            self._solutions.pop(0)
            self._quality.pop(0)

    def lookup(self, T: np.ndarray, max_distance: float = np.inf) -> Optional[np.ndarray]:
        """Quality-weighted blend of the k nearest cached solutions
        (``ik_helpers.py:300-340``); None on a miss."""
        hit = self.lookup_with_distance(T, max_distance)
        return None if hit is None else hit[0]

    def lookup_with_distance(
        self, T: np.ndarray, max_distance: float = np.inf
    ) -> Optional[Tuple[np.ndarray, float]]:
        """Like :meth:`lookup` but also returns the nearest-entry pose
        distance, so callers can gate fast paths on hit proximity."""
        self._materialize()
        if not self._poses:
            return None
        T = np.asarray(T, dtype=np.float64)
        d = np.array([_pose_distance(T, P) for P in self._poses])
        order = np.argsort(d)[: self.k]
        if d[order[0]] > max_distance:
            return None
        w = np.array([self._quality[i] / (d[i] + 1e-6) for i in order])
        w = w / w.sum()
        blend = np.einsum("i,ij->j", w, np.stack([self._solutions[i] for i in order]))
        return blend, float(d[order[0]])

    def clear(self) -> None:
        self._pending.clear()
        self._poses.clear()
        self._solutions.clear()
        self._quality.clear()


def smart_ik(
    model: RobotModel,
    T_desired: jnp.ndarray,
    *,
    strategy: str = "auto",
    q_current: Optional[jnp.ndarray] = None,
    cache: Optional[IKInitialGuessCache] = None,
    seed: int = 0,
    fast_path_distance: float = 0.25,
    **solve_kw,
) -> IKResult:
    """Strategy-dispatched IK with an automatic fallback chain
    (reference ``smart_inverse_kinematics``, ``kinematics.py:494-642``).

    Strategies: ``workspace_heuristic`` / ``extrapolate`` / ``cached`` /
    ``random`` / ``midpoint`` / ``auto`` (chain through all of them,
    stopping at the first success). Successful solves populate ``cache``
    *lazily* (one batched fetch at the next lookup — no sync here).

    ``fast_path_distance``: on an ``auto`` chain, a cache hit whose
    nearest entry is within this pose distance is raced ALONE first
    (one small dispatch); only a failure falls through to the full
    strategy race. Repeated near-identical queries — the cache's use
    case — then cost a single m=1 solve instead of the full chain.
    """

    # The only host-side strategy is the cache lookup (a k-NN over host
    # memory); every device-computable guess, the race, and the
    # chain-order selection live in ONE jitted program
    # (:func:`_smart_core`) — a single device dispatch per call. The
    # previous eager composition (stack / score / argmin / 5 indexings as
    # separate ops) cost 5-10 dispatches per solve.
    chain = (
        ["cached", "extrapolate", "workspace_heuristic", "midpoint", "random"]
        if strategy == "auto"
        else [strategy]
    )
    extras = []
    device_chain = []
    hit_dist = np.inf
    for s in chain:
        if s == "cached":
            if cache is None:
                continue
            hit = cache.lookup_with_distance(np.asarray(T_desired))
            if hit is not None:
                extras.append(np.asarray(hit[0], dtype=np.float64))
                hit_dist = hit[1]
        elif s == "extrapolate":
            if q_current is not None:
                device_chain.append(s)
        elif s in ("workspace_heuristic", "midpoint", "random"):
            device_chain.append(s)
        else:
            raise ValueError(f"Unknown IK strategy {s!r}")
    if not extras and not device_chain:
        return None

    n = model.num_joints
    extra_stack = (
        jnp.asarray(np.stack(extras), dtype=model.dtype)
        if extras
        else jnp.zeros((0, n), dtype=model.dtype)
    )
    qc = (
        jnp.asarray(q_current, dtype=model.dtype)
        if q_current is not None
        else jnp.zeros(n, dtype=model.dtype)
    )
    Td = jnp.asarray(T_desired, dtype=model.dtype)
    kw = freeze_solve_kw(solve_kw)

    # Cache-hit fast path: a *near* hit (see ``fast_path_distance``) is
    # raced alone first — one m=1 dispatch; only a failure falls through
    # to the full chain. Far hits skip the gamble (a failed fast path
    # costs a whole extra dispatch and host synchronisation).
    res = None
    if extras and device_chain and strategy == "auto" and hit_dist <= fast_path_distance:
        hit_res = _smart_core(model, Td, extra_stack, qc, seed, 1, (), kw)
        if bool(jax.device_get(hit_res.success)):
            res = hit_res
    if res is None:
        res = _smart_core(
            model, Td, extra_stack, qc, seed, len(extras), tuple(device_chain), kw
        )
    if cache is not None:
        # Lazy insert: no device_get here — smart_ik stays at one
        # dispatch per call; the fetch happens batched at the next
        # host-side cache access.
        cache.add_async(np.asarray(T_desired), res.success, res.theta)
    return res


@partial(jax.jit, static_argnames=("n_extra", "device_chain", "solve_kw_items"))
def _smart_core(
    model, T_desired, extra_guesses, q_current, seed, n_extra, device_chain, solve_kw_items
):
    """The whole smart-IK fallback chain as one traced program: build the
    device-side guesses, race every strategy concurrently (the
    reference's sequential chain pays a full solve per strategy,
    ``kinematics.py:601-642``), and select with chain semantics — the
    EARLIEST successful strategy wins; with no success, the best error."""
    solve_kw = dict(solve_kw_items)
    key = jax.random.PRNGKey(seed)
    dev = []
    for s in device_chain:
        key, sub = jax.random.split(key)
        if s == "workspace_heuristic":
            dev.append(workspace_heuristic_guess(model, T_desired))
        elif s == "midpoint":
            dev.append(midpoint_guess(model))
        elif s == "random":
            dev.append(random_guesses(model, sub, 1)[0])
        elif s == "extrapolate":
            dev.append(extrapolate_guess(model, q_current, T_desired))
    parts = ([extra_guesses[:n_extra]] if n_extra else []) + (
        [jnp.stack(dev)] if dev else []
    )
    stack = jnp.concatenate(parts, axis=0)
    m = n_extra + len(dev)
    if m == 1:
        return solve_ik(model, T_desired, stack[0], **solve_kw)
    results = jax.vmap(lambda th: solve_ik(model, T_desired, th, **solve_kw))(stack)
    order = jnp.arange(m, dtype=results.rot_err.dtype)
    combined = results.rot_err + results.trans_err
    # NaN-safe like ik.select_best: a diverged lane's NaN score would
    # win the argmin under NumPy NaN semantics.
    combined = jnp.where(jnp.isnan(combined), jnp.inf, combined)
    score = jnp.where(results.success, order, 1e6 + combined)
    i = jnp.argmin(score)
    return IKResult(
        results.theta[i],
        results.success[i],
        results.iterations[i],
        results.rot_err[i],
        results.trans_err[i],
    )


@partial(jax.jit, static_argnames=("with_theta0", "solve_kw_items"))
def _robust_core(model, T_desired, theta0, seed, with_theta0, solve_kw_items):
    solve_kw = dict(solve_kw_items)
    key = jax.random.PRNGKey(seed)
    dampings = jnp.asarray([5e-2, 5e-2, 1e-1, 1e-1, 2e-1, 5e-2, 1e-1, 2e-1, 3e-1, 5e-1], dtype=model.dtype)
    step_caps = jnp.asarray([0.5, 0.3, 0.5, 0.3, 0.5, 1.0, 1.0, 0.7, 0.5, 0.3], dtype=model.dtype)
    guesses = jnp.stack(
        [
            theta0 if with_theta0 else workspace_heuristic_guess(model, T_desired),
            midpoint_guess(model),
            jnp.zeros(model.num_joints, dtype=model.dtype),
        ]
        + list(random_guesses(model, key, 7))
    )
    results = jax.vmap(
        lambda th, d, c: solve_ik(model, T_desired, th, damping=d, step_cap=c, **solve_kw)
    )(guesses, dampings, step_caps)
    return select_best(results)


def robust_ik(
    model: RobotModel,
    T_desired: jnp.ndarray,
    *,
    theta0: Optional[jnp.ndarray] = None,
    seed: int = 0,
    **solve_kw,
) -> IKResult:
    """The reference's 10-entry (strategy, damping, step-cap) schedule
    (``kinematics.py:674-686``) — run as ONE vmapped batch instead of
    sequential restarts. Guesses repeat across damping tiers so every
    (guess, parameters) combination races concurrently.

    Guess construction, the 10-way race, and the selection are one jitted
    program — a single device dispatch per call (the previous eager
    composition paid ~8 dispatches)."""
    th0 = (
        jnp.asarray(theta0, dtype=model.dtype)
        if theta0 is not None
        else jnp.zeros(model.num_joints, dtype=model.dtype)
    )
    return _robust_core(
        model,
        jnp.asarray(T_desired, dtype=model.dtype),
        th0,
        seed,
        theta0 is not None,
        freeze_solve_kw(solve_kw),
    )


def adaptive_multi_start_ik(
    model: RobotModel,
    T_desired: jnp.ndarray,
    *,
    initial_starts: int = 4,
    max_starts: int = 32,
    cache: Optional[IKInitialGuessCache] = None,
    seed: int = 0,
    **solve_kw,
) -> Tuple[IKResult, int]:
    """Escalating multi-start (reference ``adaptive_multi_start_ik``,
    ``ik_helpers.py:390-519``): start with a small batch, double the
    start count until success or ``max_starts``. Returns
    (result, total_starts_used)."""
    from .ik import multi_start_ik

    key = jax.random.PRNGKey(seed)
    num = initial_starts
    used = 0
    best: Optional[IKResult] = None
    theta0 = None
    if cache is not None:
        hit = cache.lookup(np.asarray(T_desired))
        if hit is not None:
            theta0 = jnp.asarray(hit, dtype=model.dtype)
    while True:
        key, sub = jax.random.split(key)
        res = multi_start_ik(
            model,
            T_desired,
            num_starts=num,
            theta0=theta0,
            seed=int(jax.random.randint(sub, (), 0, 2**31 - 1)),
            **solve_kw,
        )
        used += num
        if best is None or float(res.rot_err + res.trans_err) < float(
            best.rot_err + best.trans_err
        ):
            best = res
        if bool(res.success):
            if cache is not None:
                cache.add(np.asarray(T_desired), np.asarray(res.theta))
            return best, used
        if num >= max_starts:
            return best, used
        num = min(2 * num, max_starts)
