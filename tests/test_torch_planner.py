"""The port's motion planning (gsworld_tpu_torch/rollout/planner/) against
the JAX package's: the screw interpolation and grasp quaternions, the
screw move's dry-run waypoints from a bridged reset (FR3, and the xArm6
with its mimic joints), the batched collision checker and RRT-Connect,
and two whole scripted solutions under a kinematic stand-in of
``env.step``.

Tolerances: the quaternion helpers to 1e-6 (the same f32 products); the
dry-run waypoints to 1e-4 rad with the same count (the IK solvers agree
to f32 rounding, tests/test_torch_ik.py); the checker's booleans equal;
JAX's RRT path on the free straight line to 1e-6; the solutions' action
sequences equal in length and within 1e-4.

Cost: JAX's jitted IK closure takes ~3.7 s per waypoint on a CPU
(~60 ms per damped least-squares iteration), so the dry runs move the
TCP a few centimetres (two waypoints), and in the whole-solution tests
the JAX planner's IK is the port's ``solve_ik`` through numpy.  Those
tests hold the planners' and the solutions' control flow (waypoint
counts, screw poses, gripper phases, grasp and place poses, the runaway
guard) with the same IK on both sides; the dry runs hold the IKs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gsworld_tpu import envs as jenvs
from gsworld_tpu.rollout.planner import motionplanner as jmp
from gsworld_tpu.rollout.planner import rrt as jrrt
from gsworld_tpu.rollout.planner import solutions as jsol
from gsworld_tpu_torch import envs as tenvs
from gsworld_tpu_torch.core.maths import axis_angle_to_quat, quat_multiply
from gsworld_tpu_torch.envs.base import env_state_from_numpy
from gsworld_tpu_torch.physics.ik import solve_ik
from gsworld_tpu_torch.rollout.planner import motionplanner as tmp
from gsworld_tpu_torch.rollout.planner import rrt as trrt
from gsworld_tpu_torch.rollout.planner import solutions as tsol
from torch_physics_common import (
    jax_state_fields,
    one_torch_thread,  # noqa: F401 (autouse fixture)
)

SIM = dict(sim_freq=100, control_freq=20)
SOLVERS = {"fr3_umi": (jmp.FR3UmiMotionPlanningSolver,
                       tmp.FR3UmiMotionPlanningSolver),
           "xarm6_uf_gripper": (jmp.XArmMotionPlanningSolver,
                                tmp.XArmMotionPlanningSolver)}
_PAIRS = {}


def pair(env_id):
    """(JAX env, port env, bridged fields) at JAX's reset(0) state, one
    env in pd_joint_pos at sim 100 / control 20 (the planner's)."""
    if env_id not in _PAIRS:
        kw = dict(num_envs=1, obs_mode="state_dict",
                  control_mode="pd_joint_pos", sim_config=SIM)
        jenv = jenvs.make(env_id, **kw)
        tenv = tenvs.make(env_id, device="cpu", **kw)
        jenv.reset(seed=0)
        fields = jax_state_fields(jenv.state)
        tenv._state = env_state_from_numpy(fields, device="cpu")
        _PAIRS[env_id] = (jenv, tenv, jenv.state, fields)
    jenv, tenv, jstate, fields = _PAIRS[env_id]
    jenv._state = jstate
    tenv._state = env_state_from_numpy(fields, device="cpu")
    return jenv, tenv


def _solvers(jenv, tenv):
    jcls, tcls = SOLVERS[tenv.robot_uids]
    return jcls(jenv), tcls(tenv)


def test_quat_helpers_match_jax():
    rng = np.random.default_rng(0)
    for n in (2, 7, 120):
        p0, p1 = rng.normal(size=(2, 3))
        q0, q1 = rng.normal(size=(2, 4))
        want = jmp.quat_slerp_screw(p0, q0, p1, q1, n)
        got = tmp.quat_slerp_screw(p0, q0, p1, q1, n)
        assert len(got) == len(want) == n
        for (pg, qg), (pw, qw) in zip(got, want):
            assert pg.dtype == qg.dtype == np.float32
            assert np.abs(pg - pw).max() <= 1e-6
            assert np.abs(qg - qw).max() <= 1e-6
    np.testing.assert_allclose(tsol.TOPDOWN_Q, jsol.TOPDOWN_Q, atol=1e-6)
    for _ in range(8):
        a = rng.normal(size=3)
        a /= np.linalg.norm(a)
        c = np.cross(a, rng.normal(size=3))
        c /= np.linalg.norm(c)
        np.testing.assert_allclose(tsol.build_grasp_quat(a, c),
                                   jsol.build_grasp_quat(a, c), atol=1e-6)


@pytest.mark.parametrize("env_id", ["AlignFr3Env-v1", "AlignXArmEnv-v1"])
def test_grasp_quat_for_matches_jax(env_id):
    """The OBB closing axis of every actor of a bridged reset, and with
    the actors turned about z (the axis choice follows the turn)."""
    jenv, tenv = pair(env_id)
    turn = axis_angle_to_quat(torch.tensor([0.0, 0.0, 1.1]))
    for turned in (False, True):
        if turned:
            w = tenv.state.world
            aq = quat_multiply(turn, w.a_quat)
            tenv._state = tenv.state.replace(world=w.replace(a_quat=aq))
            jenv._state = jenv.state.replace(world=jenv.state.world.replace(
                a_quat=jnp.asarray(aq.numpy())))
        for name in tenv.actor_names:
            np.testing.assert_allclose(
                tsol._grasp_quat_for(tenv, name),
                jsol._grasp_quat_for(jenv, name), atol=1e-6, err_msg=name)
    pair(env_id)


@pytest.mark.parametrize("env_id", ["AlignFr3Env-v1", "AlignXArmEnv-v1"])
def test_screw_dry_run_matches_jax(env_id):
    """Dry-run waypoints of a 4.7 cm, 0.05 rad screw move from the bridged
    reset, each solved by the package's own IK: the same count (two, from
    the speed budget) and values within 1e-4 rad."""
    jenv, tenv = pair(env_id)
    jp, tp = _solvers(jenv, tenv)
    p, q = tp.tcp_pose()
    jp_now, jq_now = jp.tcp_pose()
    assert np.abs(p - jp_now).max() <= 1e-6 and np.abs(q - jq_now).max() <= 1e-6
    target = p + np.array([0.03, -0.02, -0.03], np.float32)
    tq = quat_multiply(axis_angle_to_quat(torch.tensor([0.0, 0.05, 0.0])),
                       torch.as_tensor(q)).numpy()
    want = jp.move_to_pose_with_screw(target, tq, dry_run=True)
    got = tp.move_to_pose_with_screw(target, tq, dry_run=True)
    assert want != -1 and got != -1
    assert len(got) == len(want) == 2
    assert np.abs(np.stack(got) - np.stack(want)).max() <= 1e-4
    # the move reaches the target pose
    q_end = tenv.state.world.qpos[0].clone()
    q_end[list(tp.arm_dofs)] = torch.as_tensor(got[-1])
    pe, _ = tp._fk(q_end, tenv.state.world.root_pos[0],
                   tenv.state.world.root_quat[0])
    assert np.abs(pe.numpy() - target).max() <= 1e-3


_JAX_CHECKERS = {}


def jax_checker(jenv):
    """JAX's collision checker of ``jenv``, made once: its jit compiles
    once per batch size, so every check below asks for CHECK_M
    configurations (the goal check of rrt_connect excepted)."""
    if id(jenv) not in _JAX_CHECKERS:
        _JAX_CHECKERS[id(jenv)] = jrrt.make_collision_checker(jenv)
    return _JAX_CHECKERS[id(jenv)]


CHECK_M = 8


def _checker_batches(tenv, tcheck, rng):
    """Two batches of CHECK_M configurations: 4 around the task-init pose
    (free) and 4 farther out (3 of them with a finger or the hand below
    the table, picked by the port's checker with the actors out of
    reach); then 8 around the task-init pose, to be checked against a
    hull moved onto the TCP (penetration)."""
    m = tenv.agent.model
    lim = m.qlimits
    w = tenv.state.world
    q0 = w.qpos[0].numpy()
    clip = lambda x: np.clip(x, lim[:, 0], lim[:, 1]).astype(np.float32)  # noqa: E731
    near = clip(q0 + rng.normal(0, 0.05, (4, m.dof)))
    wide = clip(q0 + rng.normal(0, 1.0, (200, m.dof)))
    low = tcheck(wide, w.a_pos[0] + 10.0, w.a_quat[0], w.root_pos[0],
                 w.root_quat[0]).numpy()
    wide = np.concatenate([wide[low][:3], wide[~low][:1]])
    grip = clip(q0 + rng.normal(0, 0.02, (CHECK_M, m.dof)))
    return np.concatenate([near, wide]), grip


def test_collision_checker_matches_jax():
    jenv, tenv = pair("AlignFr3Env-v1")
    jcheck = jax_checker(jenv)
    tcheck = trrt.make_collision_checker(tenv)
    rng = np.random.default_rng(3)
    free_or_table, on_tcp = _checker_batches(tenv, tcheck, rng)
    w = tenv.state.world
    tp, _ = tmp.FR3UmiMotionPlanningSolver(tenv).tcp_pose()
    a_pos = w.a_pos[0].clone()
    a_pos[2] = torch.as_tensor(tp) - torch.tensor([0.0, 0.0, 0.06])
    got, want = [], []
    for qs, ap in ((free_or_table, w.a_pos[0]), (on_tcp, a_pos)):
        targs = (ap, w.a_quat[0], w.root_pos[0], w.root_quat[0])
        jargs = tuple(jnp.asarray(x.numpy()) for x in targs)
        got.append(tcheck(qs, *targs).numpy())
        want.append(np.asarray(jcheck(jnp.asarray(qs), *jargs)))
    np.testing.assert_array_equal(np.concatenate(got), np.concatenate(want))
    # every kind is present: free, below the table, inside a hull
    assert not got[0][:4].any() and got[0][4:7].all() and got[1].all()


def test_rrt_straight_line_matches_jax(monkeypatch):
    """A free straight joint line (8 configurations at the 0.05 rad
    resolution): both planners take it and densify it the same way."""
    jenv, tenv = pair("AlignFr3Env-v1")
    monkeypatch.setattr(jrrt, "make_collision_checker", jax_checker)
    q0 = tenv.state.world.qpos[0].numpy()
    act = tenv.agent.arm_dof_ids
    q1 = q0.copy()
    q1[list(act)] += np.array([0.32, -0.2, 0.1, 0.2, 0.0, -0.1, 0.25],
                              np.float32)
    want = jrrt.rrt_connect(jenv, q0, q1, act)
    got = trrt.rrt_connect(tenv, q0, q1, act)
    assert want is not None and got is not None
    assert got.shape == want.shape == (CHECK_M, q0.shape[0])
    assert got.dtype == want.dtype
    assert np.abs(got - want).max() <= 1e-6


def test_rrt_finds_a_path_around_an_obstacle():
    """The spice rack stands where the TCP passes half way along the
    straight joint line: the line is blocked, RRT-Connect finds a path,
    and every densified configuration of it is free."""
    _, tenv = pair("AlignFr3Env-v1")
    planner = tmp.FR3UmiMotionPlanningSolver(tenv)
    act = list(tenv.agent.arm_dof_ids)
    q0 = tenv.state.world.qpos[0].clone()
    q1 = q0.clone()
    q1[act[0]] += 1.2
    mid = q0.clone()
    mid[act[0]] += 0.6
    w = tenv.state.world
    p_mid, _ = planner._fk(mid, w.root_pos[0], w.root_quat[0])
    a_pos = w.a_pos.clone()
    a_pos[0, 2] = p_mid - torch.tensor([0.0, 0.0, 0.08])
    tenv._state = tenv.state.replace(world=w.replace(a_pos=a_pos))
    check = trrt.make_collision_checker(tenv)
    args = (a_pos[0], w.a_quat[0], w.root_pos[0], w.root_quat[0])
    free, _ = trrt._edge_free(check, q0.numpy(), q1.numpy(), args)
    assert not free and not check(np.stack([q0.numpy(), q1.numpy()]),
                                  *args).any()
    path = trrt.rrt_connect(tenv, q0.numpy(), q1.numpy(), act, seed=0)
    assert path is not None
    np.testing.assert_array_equal(path[0], q0.numpy())
    np.testing.assert_allclose(path[-1], q1.numpy(), atol=1e-6)
    assert not check(path, *args).any()
    step = np.abs(np.diff(path, axis=0)).max()
    assert step <= 0.05 + 1e-6
    pair("AlignFr3Env-v1")


LAG = 0.9


def _kinematic_step(env, actions, is_jax):
    """env.step stand-in: the arm's qpos moves LAG of the way to the
    command (a tracking lag, as the PD-driven arm has), the gripper dofs
    := the gripper command, actors still; records the actions.

    With the arm exactly at each command, a move would start exactly at
    the previous target, and the reference's speed budgets make some
    waypoint counts exact integers there (0.06 m at 0.12 m/s and 20 Hz is
    10.0 waypoints): the ceiling would then turn on the last bit of the
    forward kinematics.  The lag leaves the TCP short of each target by
    far more than the packages' rounding."""
    arm = list(env.agent.arm_dof_ids)
    grip = list(env.agent.gripper_dof_ids)

    def step(action):
        a = np.asarray(action, np.float32).reshape(-1)
        actions.append(a)
        st = env.state
        q = np.array(st.world.qpos)
        q[:, arm] += np.float32(LAG) * (a[:-1] - q[:, arm])
        q[:, grip] = a[-1]
        if is_jax:
            env._state = st.replace(world=st.world.replace(
                qpos=jnp.asarray(q)), elapsed=st.elapsed + 1)
        else:
            env._state = st.replace(world=st.world.replace(
                qpos=torch.as_tensor(q)), elapsed=st.elapsed + 1)
        return None, None, None, None, {"success": np.zeros(1, bool)}

    return step


@pytest.mark.parametrize("env_id,solve", [
    ("StackFr3Env-v1", "solveStackFr3"),
    ("AlignXArmEnv-v1", "solveAlignXArm")])
def test_solution_actions_match_jax(env_id, solve, monkeypatch):
    """A whole scripted solution from one bridged reset, env.step replaced
    in both packages by the same kinematic stand-in: the action sequences
    match in length and within 1e-4, and both end the same way (with the
    actors still, the grasp check sees no rise and gives up after the
    retry)."""
    jenv, tenv = pair(env_id)
    jstate = jenv.state
    tfields = jax_state_fields(jstate)
    tmodel = tenv.agent.model

    def treset(seed=None, options=None):
        tenv._state = env_state_from_numpy(tfields, device="cpu")
        return {}, {}

    def jreset(seed=None, options=None):
        jenv._state = jstate
        return {}, {}

    jinit = jmp.MotionPlanningSolver.__init__

    def init_with_port_ik(self, env, *a, **kw):
        jinit(self, env, *a, **kw)

        def ik(tp, tq, q0, rp, rq):
            t = lambda x: torch.as_tensor(np.array(x))[None]  # noqa: E731
            q, conv = solve_ik(tmodel, self.ee_link, t(tp), t(tq), t(q0),
                               self.arm_dofs, root_pos=t(rp),
                               root_quat=t(rq))
            return jnp.asarray(q[0].numpy()), jnp.asarray(bool(conv[0]))
        self._ik = ik

    monkeypatch.setattr(jmp.MotionPlanningSolver, "__init__",
                        init_with_port_ik)
    jactions, tactions = [], []
    monkeypatch.setattr(jenv, "reset", jreset, raising=False)
    monkeypatch.setattr(tenv, "reset", treset, raising=False)
    monkeypatch.setattr(jenv, "step", _kinematic_step(jenv, jactions, True),
                        raising=False)
    monkeypatch.setattr(tenv, "step",
                        _kinematic_step(tenv, tactions, False), raising=False)
    want = getattr(jsol, solve)(jenv, seed=0)
    got = getattr(tsol, solve)(tenv, seed=0)
    assert len(tactions) == len(jactions) > 20
    assert np.abs(np.stack(tactions) - np.stack(jactions)).max() <= 1e-4
    assert (got == -1) == (want == -1)
    assert set(tsol.SOLUTIONS) == set(jsol.SOLUTIONS)
