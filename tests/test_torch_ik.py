"""The port's IK (gsworld_tpu_torch/physics/ik.py) and end-effector
control modes against the JAX package's: the pose error, the written-out
Jacobian against ``torch.func.jacfwd`` of the plain error, ``solve_ik``
against the JAX solver for both robots, ``compute_targets`` in
``pd_ee_delta_pos`` and ``pd_ee_delta_pose``, and the modes stepping an
env.

Tolerances: the Jacobian to 1e-5 (the analytic form against autodiff of
the same f32 error; measured ~5e-7); solve_ik and the targets to 1e-5
rad.  The port solves J J^T + 1e-3 I by Cholesky and two triangular
solves, JAX by LU, and the port's FK along the chain is 4x4 products
where JAX composes quaternions: each agrees to f32 rounding.  The states
lie around the task-init pose, where the controller runs: at arbitrary
states within the joint limits 12 damped steps near a singular
configuration amplify that rounding (up to 5e-2 rad measured), so there
the solvers are not held to each other.  ``solve_ik`` runs the
controller's 12 iterations here (not its default 64): JAX's solver takes
~1.3 s per iteration at 16 FR3 states on the CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gsworld_tpu.envs.agents.base import get_agent as jget_agent
from gsworld_tpu.physics import ik as jik
import gsworld_tpu.envs.agents.fr3_umi  # noqa: F401
import gsworld_tpu.envs.agents.xarm6  # noqa: F401
from gsworld_tpu_torch import constants
from gsworld_tpu_torch import envs as tenvs
from gsworld_tpu_torch.core.maths import axis_angle_to_quat, quat_to_matrix
from gsworld_tpu_torch.envs.agents.base import get_agent
from gsworld_tpu_torch.physics import ik
from torch_physics_common import one_torch_thread  # noqa: F401 (autouse)

ROBOTS = {"fr3_umi": (0.0, 0.0, 0.0), "xarm6_uf_gripper": (0.0, 0.0, 0.03)}
N = 16
TOL = 1e-5
ITERS = 12


def _states(uid, seed, sigma=0.1):
    """N joint states around the task-init pose, targets at the TCP pose of
    another state near each, and the robot's root pose."""
    agent = get_agent(uid)
    m = agent.model
    rng = np.random.default_rng(seed)
    lim = m.qlimits
    q0 = np.asarray(constants.robot_task_init_qpos[uid], np.float32)
    q = np.clip(q0 + rng.normal(0, sigma, (N, m.dof)), lim[:, 0],
                lim[:, 1]).astype(np.float32)
    q1 = np.clip(q + rng.normal(0, sigma, q.shape), lim[:, 0],
                 lim[:, 1]).astype(np.float32)
    rp = np.tile(np.asarray(ROBOTS[uid], np.float32), (N, 1))
    rq = np.tile(np.array([1, 0, 0, 0], np.float32), (N, 1))
    pt, qt = ik.ee_pose_fn(m, agent.ee_link)(
        torch.as_tensor(q1), torch.as_tensor(rp), torch.as_tensor(rq))
    return agent, q, pt.numpy(), qt.numpy(), rp, rq


def test_pose_error_matches_jax():
    """Large and tiny rotations, both signs of w."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    aa = rng.normal(size=(64, 3)) * np.logspace(-9, 0.5, 64)[:, None]
    dq = axis_angle_to_quat(torch.as_tensor(aa, dtype=torch.float32))
    from gsworld_tpu_torch.core.maths import quat_multiply
    qt = quat_multiply(dq, torch.as_tensor(q)).numpy()
    qt[::2] *= -1.0                                      # the w < 0 flip
    p = rng.normal(size=(64, 3)).astype(np.float32)
    pt = rng.normal(size=(64, 3)).astype(np.float32)
    got = ik.pose_error(*map(torch.as_tensor, (p, q, pt, qt))).numpy()
    want = np.asarray(jik.pose_error(*map(jnp.asarray, (p, q, pt, qt))))
    assert np.abs(got - want).max() <= 1e-6
    # the small-angle branch was taken by some, the general by others
    ang = np.linalg.norm(want[:, 3:], axis=-1)
    assert (ang < 1e-6).any() and (ang > 1.0).any()


@pytest.mark.parametrize("uid", sorted(ROBOTS))
def test_chain_fk_matches_full_fk(uid):
    agent, q, *_, rp, rq = _states(uid, 1, sigma=0.5)
    chain = ik.ik_chain(agent.model, agent.ee_link, "cpu")
    T_root = ik.root_transform(torch.as_tensor(rp), torch.as_tensor(rq),
                               (N,), "cpu")
    T_ee, frames = ik.chain_fk(chain, torch.as_tensor(q), T_root)
    p, quat = ik.ee_pose_fn(agent.model, agent.ee_link)(
        torch.as_tensor(q), torch.as_tensor(rp), torch.as_tensor(rq))
    # f32 rounding of ~10 composed transforms either way
    assert (T_ee[:, :3, 3] - p).abs().max() <= 2e-6
    assert (T_ee[:, :3, :3] - quat_to_matrix(quat)).abs().max() <= 2e-6
    assert frames.shape == (N, len(agent.arm_dof_ids), 4, 4)
    assert chain.dofs == tuple(agent.arm_dof_ids)


@pytest.mark.parametrize("uid", sorted(ROBOTS))
def test_jacobian_matches_jacfwd(uid):
    """The written-out Jacobian of the pose error, rotation rows through
    the rotation-vector map included, equals autodiff of the plain error
    (full FK, quaternions) at 16 states, near the target and far."""
    agent, q, pt, qt, rp, rq = _states(uid, 2, sigma=0.3)
    m, ee = agent.model, agent.ee_link
    act = torch.as_tensor(agent.arm_dof_ids)
    chain = ik.ik_chain(m, ee, "cpu")
    T_root = ik.root_transform(torch.as_tensor(rp), torch.as_tensor(rq),
                               (N,), "cpu")
    T_ee, frames = ik.chain_fk(chain, torch.as_tensor(q), T_root)
    e, J = ik.error_and_jacobian(chain, T_ee, frames, torch.as_tensor(pt),
                                 quat_to_matrix(torch.as_tensor(qt)))
    fk = ik.ee_pose_fn(m, ee)
    for b in range(N):
        qf = torch.as_tensor(q[b])

        def err(qa):
            p, quat = fk(qf.index_copy(0, act, qa), torch.as_tensor(rp[b]),
                         torch.as_tensor(rq[b]))
            return ik.pose_error(p, quat, torch.as_tensor(pt[b]),
                                 torch.as_tensor(qt[b]))

        J_ad = torch.func.jacfwd(err)(qf[act])
        assert (e[b] - err(qf[act])).abs().max() <= 2e-6, b
        assert (J[b] - J_ad).abs().max() <= TOL * max(
            1.0, float(J_ad.abs().max())), b


@pytest.mark.parametrize("uid", sorted(ROBOTS))
def test_solve_ik_matches_jax(uid):
    agent, q, pt, qt, rp, rq = _states(uid, 3)
    act = agent.arm_dof_ids
    q_t, ok_t = ik.solve_ik(agent.model, agent.ee_link, torch.as_tensor(pt),
                            torch.as_tensor(qt), torch.as_tensor(q), act,
                            torch.as_tensor(rp), torch.as_tensor(rq),
                            iters=ITERS)
    ja = jget_agent(uid)
    solve = jax.jit(jax.vmap(lambda a, b, c, d, e: jik.solve_ik(
        ja.model, ja.ee_link, a, b, c, act, d, e, iters=ITERS)))
    q_j, ok_j = solve(*map(jnp.asarray, (pt, qt, q, rp, rq)))
    assert np.abs(q_t.numpy() - np.asarray(q_j)).max() <= TOL
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    assert ok_t.sum() >= N // 2              # most reachable targets met
    # gripper dofs keep their values; the solution stays in the limits
    other = [d for d in range(agent.model.dof) if d not in act]
    np.testing.assert_array_equal(q_t.numpy()[:, other], q[:, other])
    lim = agent.model.qlimits
    assert (q_t.numpy() >= lim[:, 0]).all() and (q_t.numpy() <= lim[:, 1]).all()


@pytest.mark.parametrize("mode", ["pd_ee_delta_pos", "pd_ee_delta_pose"])
def test_compute_targets_matches_jax(mode):
    """Actions beyond [-1, 1] (clipped before the scale) from states
    around the task-init pose, with the root off the origin."""
    ja, ta = jget_agent("fr3_umi"), get_agent("fr3_umi")
    jc, tc = ja.controller(mode), ta.controller(mode)
    assert jc.action_dim == tc.action_dim == (4 if mode.endswith("pos")
                                              else 7)
    for a, b in zip(jc.gains(), tc.gains()):
        np.testing.assert_array_equal(a, b)
    _, q, _, _, rp, rq = _states("fr3_umi", 4)
    q, rp, rq = q[:8], rp[:8] + np.float32(0.05), rq[:8]    # 8 states
    rng = np.random.default_rng(5)
    prev = q + rng.normal(0, 0.01, q.shape).astype(np.float32)
    act = rng.uniform(-1.5, 1.5, (len(q), jc.action_dim)).astype(np.float32)
    f = jax.jit(jax.vmap(jc.compute_targets))
    want = np.asarray(f(*map(jnp.asarray, (q, prev, act, rp, rq))))
    got = tc.compute_targets(*map(torch.as_tensor, (q, prev, act, rp, rq)))
    assert np.abs(got.numpy() - want).max() <= TOL
    # the arm moved towards the target; the gripper took its action
    assert np.abs(want[:, :7] - q[:, :7]).max() > 1e-2


@pytest.mark.parametrize("mode", ["pd_ee_delta_pos", "pd_ee_delta_pose"])
def test_ee_mode_moves_the_tcp(mode):
    """An env steps in the EE modes (they raised before IK was ported),
    and a held +x action moves the TCP along +x."""
    env = tenvs.make("AlignFr3Env-v1", num_envs=2, control_mode=mode,
                     device="cpu")
    env.reset(seed=0)
    tcp0 = env.tcp_pose(env._env_data(env.state))[0].clone()
    a = np.zeros(env.action_dim, np.float32)
    a[0] = 1.0                                   # +0.1 m along x per step
    for _ in range(4):
        obs, r, term, trunc, info = env.step(a)
    tcp = env.tcp_pose(env._env_data(env.state))[0]
    d = (tcp - tcp0).numpy()
    assert (d[:, 0] > 0.03).all(), d
    assert (np.abs(d[:, 1:]) < 0.5 * d[:, :1]).all(), d
    assert torch.isfinite(env.state.world.qpos).all()
    assert env.state.prev_target.shape == (2, 9)
