"""Motion-planning solvers: screw-motion interpolation + DLS IK (port of
gsworld_tpu/rollout/planner/motionplanner.py).

The planner is host-side orchestration: the end-effector pose is
interpolated along a constant twist, each waypoint is solved by
``physics/ik.py:solve_ik`` on the env's device (warm-started from the
previous waypoint), and the joint waypoints are followed with
``pd_joint_pos`` actions through ``env.step``.  Gripper commands: OPEN 1 /
CLOSED -1 for the FR3, OPEN 0 / CLOSED 0.85 for the xArm6.

Each waypoint's IK ends in one host read (its ``converged`` flag), so a
move of n waypoints costs n device round trips: the warm start makes the
waypoints sequential, as they are in the JAX package.  On a CUDA device
(with the env's ``graph``, the default) one waypoint's IK, 64 damped
steps of ~20 small kernels each, is captured once into a CUDA graph and
replayed per waypoint; eagerly the card spends ~140 ms a waypoint
launching them.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from gsworld_tpu_torch.core.maths import (
    axis_angle_to_quat,
    quat_conjugate,
    quat_multiply,
    quat_normalize,
)
from gsworld_tpu_torch.envs.base import GsBaseEnv
from gsworld_tpu_torch.physics.ik import ee_pose_fn, solve_ik
from gsworld_tpu_torch.utils.cuda_graph import FnGraph


def _f32(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float32)


def base_env(env) -> GsBaseEnv:
    """The GsBaseEnv under a wrapper chain (RecordEpisode, GSWorldWrapper):
    walks ``.env`` and stops at the first GsBaseEnv."""
    base = env
    while not isinstance(base, GsBaseEnv):
        base = base.env
    return base


def quat_slerp_screw(p0, q0, p1, q1, n: int):
    """Constant-twist (screw) interpolation: linear position + slerp by the
    exponential of the rotation, n waypoints including the endpoint, as
    (position, wxyz quat) float32 pairs.  The quaternion products run in
    f32 and the angle and axis in float64, as in the JAX package."""
    p0, p1 = np.asarray(p0, np.float64), np.asarray(p1, np.float64)
    q0 = np.asarray(q0, np.float64)
    q1 = np.asarray(q1, np.float64)
    q0 = q0 / np.linalg.norm(q0)
    q1 = q1 / np.linalg.norm(q1)
    if np.dot(q0, q1) < 0:
        q1 = -q1
    dq = quat_multiply(_f32(q1), quat_conjugate(_f32(q0))).numpy()
    w = np.clip(dq[0], -1, 1)
    angle = 2 * np.arccos(w)
    axis = dq[1:] / max(np.linalg.norm(dq[1:]), 1e-12)
    out = []
    for i in range(1, n + 1):
        s = i / n
        p = p0 + s * (p1 - p0)
        qi = quat_multiply(axis_angle_to_quat(_f32(axis * angle * s)),
                           _f32(q0)).numpy()
        out.append((p.astype(np.float32), qi.astype(np.float32)))
    return out


class MotionPlanningSolver:
    """Base solver driving a (wrapped) env through screw motions.  Plans
    for env 0, as the reference's single-env scripts do."""

    OPEN = 1.0
    CLOSED = -1.0
    joint_vel_limit = 0.9

    def __init__(self, env, debug: bool = False, vis: bool = False,
                 base_pose=None, print_env_info: bool = False,
                 joint_vel_limits=0.9, joint_acc_limits=0.9):
        self.env = env
        self.base_env = base = base_env(env)
        self.agent = base.agent
        self.model = base.agent.model
        self.control_freq = base.scene.control_freq
        self.arm_dofs = tuple(base.agent.arm_dof_ids)
        self.ee_link = base.agent.ee_link
        self.joint_vel_limit = float(np.min([joint_vel_limits, 2.0]))
        self.print_env_info = print_env_info
        self.gripper_state = self.OPEN
        self._fk = ee_pose_fn(self.model, self.ee_link)
        self._ik_graph = None
        self.elapsed_steps = 0

    # -------------------------------------------------------------- #

    def _state0(self):
        """(qpos, root_pos, root_quat) of env 0 as tensors on the env's
        device."""
        w = self.base_env.state.world
        return w.qpos[0], w.root_pos[0], w.root_quat[0]

    def _solve(self, target_pos, target_quat, q0, root_pos, root_quat):
        return solve_ik(self.model, self.ee_link, target_pos, target_quat,
                        q0, self.arm_dofs, root_pos=root_pos,
                        root_quat=root_quat)

    def _ik(self, target_pos, target_quat, q0, root_pos, root_quat):
        """One waypoint's IK from q0 (dof,) -> (qpos (dof,), converged
        0-d bool), both on the env's device."""
        dev = q0.device
        args = (_f32(target_pos).to(dev)[None],
                _f32(target_quat).to(dev)[None], q0[None], root_pos[None],
                root_quat[None])
        if dev.type == "cuda" and self.base_env.graph:
            if self._ik_graph is None:
                self._ik_graph = FnGraph(self._solve, dev, args,
                                         "the IK solve")
            q, conv = self._ik_graph(*args)
        else:
            q, conv = self._solve(*args)
        return q[0], conv[0]

    def tcp_pose(self):
        q, rp, rq = self._state0()
        p, quat = self._fk(q, rp, rq)
        return p.cpu().numpy(), quat.cpu().numpy()

    def _action(self, arm_qpos, gripper):
        """pd_joint_pos action: raw arm qpos + gripper command."""
        return np.concatenate([np.asarray(arm_qpos, np.float32),
                               [np.float32(gripper)]])

    def _arm(self, q):
        return q[list(self.arm_dofs)].cpu().numpy()

    def follow_path(self, waypoints, refine_steps: int = 0):
        """Execute joint waypoints via env.step.  The runaway guard trips
        at 4x the env's nominal episode cap (not at the cap itself), as in
        the JAX package: success is evaluated at episode end regardless of
        the truncated flag."""
        result = None
        limit = 4 * getattr(self.base_env, "max_episode_steps", 100)
        for wp in list(waypoints) + [waypoints[-1]] * refine_steps:
            action = self._action(wp, self.gripper_state)
            result = self.env.step(action)
            self.elapsed_steps += 1
            if self.elapsed_steps >= limit:
                break
        return result

    def move_to_pose_with_screw(self, target_pos, target_quat,
                                refine_steps: int = 0, dry_run: bool = False,
                                speed: float = 0.5):
        """Screw-interpolate the TCP to the target pose; IK each waypoint.
        Returns -1 on IK failure, the joint waypoints with ``dry_run``,
        else the last step's result.

        ``speed`` is the TCP linear speed budget in m/s: the waypoint
        count is dist / speed * control_freq (at least the rotation at
        ``joint_vel_limit`` rad/s), capped at 120."""
        # The JAX package retries "from a nudged start", but nothing
        # nudges: the second attempt repeats the first.  Kept for parity
        # (ROADMAP C18).
        for attempt in range(2):
            q0, rp, rq = self._state0()
            p_now, q_now = self.tcp_pose()
            dist = np.linalg.norm(np.asarray(target_pos) - p_now)
            dq = quat_multiply(quat_normalize(_f32(target_quat)),
                               quat_conjugate(quat_normalize(_f32(q_now))))
            ang = 2 * np.arccos(np.clip(abs(float(dq[0])), 0, 1))
            n = max(2, int(np.ceil(max(dist / speed,
                                       ang / self.joint_vel_limit)
                                   * self.control_freq)))
            n = min(n, 120)
            poses = quat_slerp_screw(p_now, q_now, target_pos, target_quat, n)
            qs = []
            q_cur = q0
            ok = True
            for (p, qt) in poses:
                q_cur, conv = self._ik(p, qt, q_cur, rp, rq)
                if not bool(conv):
                    if os.environ.get("GSW_TRACE", "0") == "1":
                        print(f"  [ik-fail      ] attempt={attempt} "
                              f"wp={len(qs)}/{n} p={np.round(p, 4)} "
                              f"from tcp={np.round(p_now, 4)}", flush=True)
                    ok = False
                    break
                qs.append(q_cur)
            if ok:
                qs = list(torch.stack(qs)[:, list(self.arm_dofs)]
                          .cpu().numpy())
                if dry_run:
                    return qs
                return self.follow_path(qs, refine_steps=refine_steps)
        return -1

    def move_to_pose_with_RRTConnect(self, target_pos, target_quat,
                                     refine_steps: int = 0,
                                     max_iters: int = 200, seed: int = 0):
        """IK the goal pose, then bidirectional RRT-Connect in joint space
        with batched collision checks (rrt.py)."""
        from gsworld_tpu_torch.rollout.planner.rrt import rrt_connect
        q0, rp, rq = self._state0()
        q_goal, conv = self._ik(target_pos, target_quat, q0, rp, rq)
        if not bool(conv):
            return -1
        path = rrt_connect(self.base_env, q0.cpu().numpy(),
                           q_goal.cpu().numpy(), self.arm_dofs,
                           max_iters=max_iters, seed=seed)
        if path is None:
            return -1
        qs = [p[list(self.arm_dofs)] for p in path]
        return self.follow_path(qs, refine_steps=refine_steps)

    def _hold_arm(self, steps: int):
        q0, _, _ = self._state0()
        arm = self._arm(q0)
        result = None
        for _ in range(steps):
            result = self.env.step(self._action(arm, self.gripper_state))
            self.elapsed_steps += 1
        return result

    def hold(self, steps: int = 10):
        """Hold the current arm configuration (a settle phase, so that the
        static success predicates can latch)."""
        return self._hold_arm(steps)

    def open_gripper(self, steps: int = 6):
        self.gripper_state = self.OPEN
        return self._hold_arm(steps)

    def close_gripper(self, steps: int = 6):
        self.gripper_state = self.CLOSED
        return self._hold_arm(steps)

    def set_gripper(self, value: float, steps: int = 6):
        """Drive the gripper to an intermediate command (e.g. a loose cage
        that releases the squeeze without fully opening)."""
        self.gripper_state = float(value)
        return self._hold_arm(steps)

    def close(self):
        pass


class FR3UmiMotionPlanningSolver(MotionPlanningSolver):
    """FR3: gripper OPEN 1 / CLOSED -1."""

    OPEN = 1.0
    CLOSED = -1.0


class XArmMotionPlanningSolver(MotionPlanningSolver):
    """xArm6: gripper OPEN 0 / CLOSED 0.85."""

    OPEN = 0.0
    CLOSED = 0.85
