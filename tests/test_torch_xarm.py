"""The port's xArm6 agent and its three tasks (Align, BananaRotation,
SpoonOnBoard) against the JAX package's: the agent's tables, the finger
gap of the gripper linkage as hard mimics (tests/test_xarm_agent.py's
contract), the episode layout from JAX-derived draws (bit for bit against
JAX's sampler op by op), one step from a bridged state (observation tree
to 1e-5, flags equal, reward to 1e-4, state to 1e-5), the root 3 cm up,
and the xArm closed loop with domain randomization when JAX is
unavailable."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gsworld_tpu import envs as jenvs
from gsworld_tpu.envs.agents.base import get_agent as jget_agent
from gsworld_tpu.physics.dynamics import slave_mimics as jslave
from gsworld_tpu.physics.kinematics import forward_kinematics as jfk
from gsworld_tpu_torch import constants
from gsworld_tpu_torch import envs as tenvs
from gsworld_tpu_torch.core.maths import axis_angle_to_quat, quat_multiply
from gsworld_tpu_torch.envs.agents.base import get_agent
from gsworld_tpu_torch.envs.agents.xarm6 import get_gripper_state
from gsworld_tpu_torch.physics.dynamics import slave_mimics
from gsworld_tpu_torch.physics.kinematics import forward_kinematics
from torch_physics_common import (
    one_torch_thread,  # noqa: F401 (autouse fixture)
    check_reset_layout,
    check_step,
    step_pair,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TASKS = ["AlignXArmEnv-v1", "BananaRotationXArmEnv-v1",
         "SpoonOnBoardXArmEnv-v1"]
UID = "xarm6_uf_gripper"
B = 2
_PAIRS = {}


def pair(env_id):
    if env_id not in _PAIRS:
        _PAIRS[env_id] = (jenvs.make(env_id, num_envs=B),
                          tenvs.make(env_id, num_envs=B, device="cpu"))
    return _PAIRS[env_id]


@pytest.mark.parametrize("uid", [UID, "xarm6_uf_gripper_wrist435"])
def test_agent_matches_jax(uid):
    ja, ta = jget_agent(uid), get_agent(uid)
    jm, tm = ja.model, ta.model
    assert tm.dof_names == jm.dof_names and tm.link_names == jm.link_names
    for f in ("mimic_parent", "mimic_mult", "mimic_offset", "qlimits",
              "parent", "jtype", "axis"):
        np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f), f)
    assert (tm.mimic_parent >= 0).sum() >= 4     # the linkage at least
    for f in ("ee_link", "base_link", "finger_links", "contact_links",
              "arm_dof_ids", "gripper_dof_ids", "finger_friction",
              "finger_open_axes", "default_control_mode"):
        assert getattr(ta, f) == getattr(ja, f), f
    assert set(ta.controllers) == set(ja.controllers)
    for mode in ja.controllers:
        jc, tc = ja.controller(mode), ta.controller(mode)
        assert jc.action_dim == tc.action_dim == 7
        for a, b in zip(jc.gains(), tc.gains()):
            np.testing.assert_array_equal(a, b)


def _gap(model, q, fk, fingers=("left_finger", "right_finger")):
    pos, _ = fk(model, q)
    ids = [model.link_names.index(f) for f in fingers]
    return float(np.linalg.norm(np.asarray(pos[ids[0]] - pos[ids[1]])))


def test_finger_gap_closes_monotonically():
    """Driving both knuckles (mimics slaved) shrinks the finger gap
    monotonically over [0, 0.85] by several cm, as JAX's does (1e-6)."""
    tm, jm = get_agent(UID).model, jget_agent(UID).model
    gaps, jgaps = [], []
    for v in np.linspace(0.0, 0.85, 6):
        q = np.zeros(tm.dof, np.float32)
        for j in ("drive_joint", "right_outer_knuckle_joint"):
            q[tm.dof_names.index(j)] = v
        qs, _ = slave_mimics(tm, torch.as_tensor(q), torch.zeros(tm.dof))
        gaps.append(_gap(tm, qs, forward_kinematics))
        jqs, _ = jslave(jm, jnp.asarray(q), jnp.zeros(jm.dof))
        jgaps.append(_gap(jm, jqs, jfk))
    gaps = np.asarray(gaps)
    assert (np.diff(gaps) < 0).all(), gaps
    assert gaps[0] - gaps[-1] > 0.03, gaps
    np.testing.assert_allclose(gaps, jgaps, atol=1e-6)


def test_closing_is_symmetric():
    m = get_agent(UID).model
    q = torch.zeros(m.dof)
    for j in ("drive_joint", "right_outer_knuckle_joint"):
        q[m.dof_names.index(j)] = 0.6
    qs, _ = slave_mimics(m, q, torch.zeros(m.dof))
    pos, _ = forward_kinematics(m, qs)
    base = pos[m.link_names.index("xarm_gripper_base_link")]
    lf = pos[m.link_names.index("left_finger")] - base
    rf = pos[m.link_names.index("right_finger")] - base
    assert abs(float(lf[2] - rf[2])) < 1e-3
    assert abs(float(lf.norm() - rf.norm())) < 1e-3


def test_gripper_closes_and_mimics_track():
    """An absolute finger action of 0.85 closes the drive joint past 0.5
    in 20 steps; every passive joint follows its drive to 1e-4."""
    env = tenvs.make("AlignXArmEnv-v1", num_envs=1, device="cpu")
    env.reset(seed=0)
    m = env.agent.model
    assert not get_gripper_state(env.state.world.qpos, m).any()
    a = np.zeros(env.action_dim, np.float32)
    a[-1] = 0.85
    for _ in range(20):
        env.step(a)
    q = env.state.world.qpos[0].numpy()
    assert q[m.dof_names.index("drive_joint")] > 0.5
    for passive, parent in (
            ("left_inner_knuckle_joint", "drive_joint"),
            ("left_finger_joint", "drive_joint"),
            ("right_inner_knuckle_joint", "right_outer_knuckle_joint"),
            ("right_finger_joint", "right_outer_knuckle_joint")):
        assert abs(q[m.dof_names.index(passive)]
                   - q[m.dof_names.index(parent)]) < 1e-4, passive
    assert get_gripper_state(env.state.world.qpos, m).all()
    assert constants.UFGRIPPER_CLOSED_THRESHOLD == 0.1


@pytest.mark.parametrize("env_id", TASKS)
def test_reset_layout_from_jax_draws(env_id):
    check_reset_layout(env_id, *pair(env_id), seed=3)


@pytest.mark.parametrize("env_id", TASKS)
def test_step_matches_jax(env_id):
    jenv, tenv = pair(env_id)
    jout, tout, fields = step_pair(jenv, tenv, seed=5, act_seed=6)
    np.testing.assert_array_equal(
        fields["world"]["root_pos"], np.float32([[0.0, 0.0, 0.03]] * B))
    check_step(jenv, tenv, jout, tout)
    assert tenv.actor_names == tuple(jenv.scene.actors.names)
    assert tenv.max_episode_steps == jenv.max_episode_steps


@pytest.mark.parametrize("env_id", TASKS + ["RealXArm6-v1"])
def test_reset_root_pose(env_id):
    env = tenvs.make(env_id, num_envs=B, device="cpu")
    obs, _ = env.reset(seed=4)
    z = 0.0 if env_id == "RealXArm6-v1" else 0.03
    want = torch.tensor([[0.0, 0.0, z]] * B)
    assert torch.equal(env.state.world.root_pos, want)
    assert set(obs["sensor_param"]) == {"wrist_cam", "right_cam"}
    np.testing.assert_array_equal(
        env.state.world.qpos[0].numpy(),
        np.asarray(constants.robot_task_init_qpos[UID], np.float32))


def test_banana_rotation_detected():
    env = tenvs.make("BananaRotationXArmEnv-v1", num_envs=1, device="cpu")
    env.reset(seed=0)
    w = env.state.world
    q45 = quat_multiply(axis_angle_to_quat(torch.tensor([0.0, 0, np.pi / 4])),
                        env._banana_init_q())
    a_quat = w.a_quat.clone()
    a_quat[:, 0] = q45
    env._state = env.state.replace(world=w.replace(a_quat=a_quat))
    info = env.evaluate(env._env_data(env.state))
    assert float(info["rotation_diff_degrees"][0]) == pytest.approx(45.0,
                                                                    abs=1e-3)
    assert bool(info["is_rotation_correct"][0])


def test_spoon_goal_in_task_state():
    env = tenvs.make("SpoonOnBoardXArmEnv-v1", num_envs=3, device="cpu")
    env.reset(seed=2)
    board = env.state.world.a_pos[:, 1]
    goal = env.state.task["goal_pos"]
    assert torch.equal(goal[:, :2], board[:, :2])
    assert torch.allclose(goal[:, 2], torch.tensor(0.022))
    # the spoon sits on its two blocks, 2/15 m apart along x
    p = env.state.world.a_pos
    torch.testing.assert_close(p[:, 3, 0] - p[:, 2, 0],
                               torch.full((3,), 0.4 / 3))


def test_xarm_closed_loop_runs_without_jax():
    """The xArm closed loop with domain randomization, and the xArm task
    through the CLI, in a subprocess where importing jax fails."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import torch
        from gsworld_tpu_torch.rollout.random_actions import build, main
        env, w = build("AlignXArmEnv-v1", 2, "xarm6_align", 120, 40, 64, 48,
                       synthetic_scale=0.003, obs_mode="rgb+segmentation",
                       max_entries=8192, device="cpu",
                       domain_randomization=True)
        obs, _ = w.reset(seed=0)
        assert set(env.state.task) == {"obj_color", "cam_pose_noise"}
        for _ in range(2):
            obs, r, term, trunc, info = w.step(env.action_space_sample())
        seg = obs["sensor_data"]["wrist_cam"]["segmentation"]
        assert seg.shape == (2, 48, 64, 1) and seg.dtype == torch.int16
        assert torch.isfinite(env.state.world.qpos).all()
        assert float(env.state.world.root_pos[0, 2]) > 0.029
        fps = main(["-e", "AlignXArmEnv-v1", "--cfg_name", "xarm6_align",
                    "-n", "1", "--ep_len", "1", "--width", "64",
                    "--height", "48", "--synthetic_scale", "0.003",
                    "--max_entries", "8192", "--device", "cpu"])
        assert fps > 0
        bad = [m for m in sys.modules
               if m == "gsworld_tpu" or m.startswith("gsworld_tpu.")
               or m == "flax" or m.startswith("flax.")]
        assert not bad, bad
        print("OK")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("OK")
