"""Scripted task solutions: OBB-style grasp poses + phased pick-and-place
(port of gsworld_tpu/rollout/planner/solutions.py).

Each ``solve*(env, seed)`` resets ``env`` (any wrapper chain over a task
env) with ``seed``, plans with a MotionPlanningSolver and returns the last
step's result, or -1 when a plan fails.  Grasp geometry comes from the
known collider dimensions (the actors' support points) instead of mesh
OBBs.  ``GSW_TRACE=1`` prints each phase.
"""

from __future__ import annotations

import numpy as np

from gsworld_tpu_torch.core.maths import (
    axis_angle_to_quat,
    matrix_to_quat,
    quat_multiply,
    quat_to_matrix,
)
from gsworld_tpu_torch.rollout.planner.motionplanner import (
    FR3UmiMotionPlanningSolver,
    XArmMotionPlanningSolver,
    _f32,
    base_env,
)


def build_grasp_quat(approaching, closing):
    """Rotation with columns (ortho, closing, approaching) -> wxyz f32."""
    approaching = np.asarray(approaching, np.float64)
    closing = np.asarray(closing, np.float64)
    ortho = np.cross(closing, approaching)
    R = np.stack([ortho, closing, approaching], axis=1)
    return matrix_to_quat(_f32(R)).numpy()


TOPDOWN_Q = build_grasp_quat([0, 0, -1.0], [0, 1.0, 0])


def _actor_pos(env, name):
    base = base_env(env)
    return base.state.world.a_pos[0, base.actor_index[name]].cpu().numpy()


def _grasp_quat_for(env, name):
    """Top-down grasp quat with the closing axis from the actor's OBB —
    the reference's compute_grasp_info_by_obb (mani_skill panda utils,
    used by every solution, e.g. xarm6/solutions/rotate_banana.py:43-49):
    fingers close across the object's SHORTEST horizontal extent, so
    elongated objects (spoon, banana) are straddled instead of pinned
    along their long axis."""
    base = base_env(env)
    i = base.actor_index[name]
    pts = np.asarray(base.scene.actors.sup_pts[i])       # body frame
    q = base.state.world.a_quat[0, i].cpu()
    R = quat_to_matrix(q).numpy()                        # body -> world
    ext = pts.max(axis=0) - pts.min(axis=0)              # body extents
    best = None
    for k in range(3):
        d = R[:, k]
        horiz = np.array([d[0], d[1], 0.0])
        nh = float(np.linalg.norm(horiz))
        if nh < 0.3:           # axis mostly vertical: cannot close along it
            continue
        if best is None or ext[k] < best[0]:
            best = (float(ext[k]), horiz / nh)
    closing = best[1] if best is not None else np.array([0.0, 1.0, 0.0])
    return build_grasp_quat([0, 0, -1.0], closing)


def _trace(env, planner, tag, obj_name):
    """Phase tracing for solution debugging (GSW_TRACE=1)."""
    import os
    if os.environ.get("GSW_TRACE", "0") != "1":
        return
    base = base_env(env)
    o = _actor_pos(env, obj_name)
    tcp, _ = planner.tcp_pose()
    info = base.evaluate(base._env_data(base.state))
    el = int(base.state.elapsed[0])
    print(f"  [{tag:14s}] el={el:3d} obj={np.round(o, 3)} "
          f"tcp={np.round(tcp, 3)} "
          f"succ={bool(info['success'][0])}", flush=True)


def _move(planner, pos, quat, refine_steps: int = 0, speed: float = 0.5):
    """Screw move with an RRT-Connect fallback (the reference's mplib
    planner falls back the same way for unreachable screw paths,
    run_with_gs.py:136-149 counts them as retried plans)."""
    res = planner.move_to_pose_with_screw(pos, quat,
                                          refine_steps=refine_steps,
                                          speed=speed)
    if res == -1:
        res = planner.move_to_pose_with_RRTConnect(
            pos, quat, refine_steps=refine_steps)
    return res


def _grasp_attempt(env, planner, obj_name, grasp_z, hover, gq):
    """Align at hover -> descend -> close -> short lift; returns the
    measured object z-rise (negative/zero = missed or knocked)."""
    obj = _actor_pos(env, obj_name)
    grasp = obj + np.array([0, 0, grasp_z], np.float32)
    # settle xy AT HOVER before any descend: the reach arrives with up to
    # ~3 cm of PD tracking lag, and the UMI opening (8 cm) clears a DTC
    # can (7.4 cm) by only ~3 mm per side — an unsettled descend sweeps a
    # finger sideways through the can and tips it over
    if planner.move_to_pose_with_screw(grasp + [0, 0, hover], gq,
                                       refine_steps=5, speed=0.3) == -1:
        return None
    _trace(env, planner, "settle-xy", obj_name)
    if planner.move_to_pose_with_screw(grasp + [0, 0, 0.06], gq,
                                       refine_steps=2, speed=0.2) == -1:
        return None
    if planner.move_to_pose_with_screw(grasp, gq,
                                       refine_steps=2, speed=0.12) == -1:
        return None
    _trace(env, planner, "descend", obj_name)
    planner.close_gripper(steps=8)
    _trace(env, planner, "grasp", obj_name)
    z0 = _actor_pos(env, obj_name)[2]
    # carry phases at <= 0.2 m/s: the friction cone of the light can
    # against the UMI pads slips beyond ~0.25 m/s; the first cm of the
    # lift is the most slip-prone (contact equilibrium re-forms)
    if planner.move_to_pose_with_screw(grasp + [0, 0, 0.04], gq,
                                       speed=0.08, refine_steps=1) == -1:
        return None
    return _actor_pos(env, obj_name)[2] - z0


def pick_and_place(env, planner, obj_name: str, place_pos,
                   grasp_z: float = 0.02, hover: float = 0.10,
                   settle: int = 10, grasp_quat=None):
    """reach -> settle xy -> descend -> grasp (verified, one retry) ->
    lift -> transport -> release.

    ``place_pos`` is the target OBJECT-CENTER position: after the lift the
    TCP target is offset by the measured tcp-to-object vector, so the
    object (not the gripper) lands at ``place_pos`` — the reference's
    ``offset = goal_pose.p - obj.pose.p`` align move (franka/solutions/
    align.py:103-110).  The reference gates the lift on
    ``is_grasped_{i}`` (align.py:94-99); here the grasp check is the
    measured object z-rise over the first 4 cm of lift, with ONE retry
    from the object's post-knock position."""
    obj = _actor_pos(env, obj_name)
    grasp = obj + np.array([0, 0, grasp_z], np.float32)
    gq = TOPDOWN_Q if grasp_quat is None else np.asarray(grasp_quat,
                                                         np.float32)
    planner.open_gripper(steps=2)
    # two-stage reach: transit HORIZONTALLY at the current (post-release)
    # height, then descend vertically to hover.  A single diagonal screw
    # from above a placed object swings the open fingers down-and-across
    # the scene while still near the start — measured on Align seed 0:
    # the transit toward can 2 dragged the fingers through can 1 standing
    # on the rack and flung it off at 0.45 m/s / 12 rad/s.
    tcp_now, _ = planner.tcp_pose()
    z_keep = max(float(tcp_now[2]), float(grasp[2] + hover))
    if _move(planner, np.array([grasp[0], grasp[1], z_keep], np.float32),
             gq, speed=0.6) == -1:
        return -1
    if _move(planner, grasp + [0, 0, hover], gq, speed=0.6) == -1:
        return -1
    _trace(env, planner, "reach", obj_name)
    rise = _grasp_attempt(env, planner, obj_name, grasp_z, hover, gq)
    if rise is None:
        return -1
    if rise < 0.02:  # missed / knocked: retry once from the new position
        _trace(env, planner, "regrasp", obj_name)
        planner.open_gripper(steps=2)
        if grasp_quat is not None:
            # OBB-gripped objects may have rotated when knocked
            gq = _grasp_quat_for(env, obj_name)
        rise = _grasp_attempt(env, planner, obj_name, grasp_z, hover, gq)
        if rise is None:
            return -1
        if rise < 0.02:
            # twice-failed grasp: transporting nothing would burn the
            # episode budget and can knock other objects
            return -1
    obj = _actor_pos(env, obj_name)
    grasp = obj + np.array([0, 0, grasp_z - 0.04], np.float32)
    if planner.move_to_pose_with_screw(grasp + [0, 0, hover + 0.05],
                                       gq, speed=0.2) == -1:
        return -1
    _trace(env, planner, "lift", obj_name)
    # object-relative place: move the TCP so the OBJECT reaches place_pos
    tcp_now, _ = planner.tcp_pose()
    obj_now = _actor_pos(env, obj_name)
    off = tcp_now - obj_now
    # transport with extra z clearance, then LOWER before releasing —
    # dropping from transport height bounces the object off its support
    high = np.asarray(place_pos, np.float32) + off + [0, 0, 0.05]
    # up -> across -> down: a single diagonal carry clips objects already
    # placed near the goal (measured on Align seed 1: the carried can
    # passed 1 cm from can 1 standing on the rack at overlapping heights
    # and knocked it off).  Rise so the carried object's BOTTOM clears a
    # standing can top (~0.27), then transit horizontally.
    z_safe = max(float(tcp_now[2]), float(high[2]) + 0.09)
    if _move(planner, np.array([tcp_now[0], tcp_now[1], z_safe],
                               np.float32), gq, speed=0.2) == -1:
        return -1
    if _move(planner, np.array([high[0], high[1], z_safe], np.float32),
             gq, speed=0.2) == -1:
        return -1
    if _move(planner, high, gq, speed=0.15) == -1:
        return -1
    _trace(env, planner, "transport", obj_name)
    target_tcp = np.asarray(place_pos, np.float32) + off
    if planner.move_to_pose_with_screw(target_tcp, gq,
                                       refine_steps=2, speed=0.15) == -1:
        return -1
    _trace(env, planner, "lower", obj_name)
    res = planner.open_gripper(steps=4)
    res = planner.move_to_pose_with_screw(target_tcp + [0, 0, 0.10],
                                          gq, speed=0.5)
    if settle:
        res = planner.hold(steps=settle)  # let static predicates latch
    _trace(env, planner, "settle", obj_name)
    return res


def solveAlignFr3(env, seed=None, debug=False, vis=False):
    """franka/solutions/align.py:19-123: both cans onto the spice rack.

    Placement mirrors the reference (:103): the two cans land at
    goal_site * [0, +-0.05, 0.15 - 0.02 i] (rack local; the rack's
    rotz(-90deg) maps local y to world x), i.e. ON TOP of the solid rack
    box, spread so the second can does not hit the first."""
    env.reset(seed=seed)
    planner = FR3UmiMotionPlanningSolver(env, debug=debug, vis=vis)
    goal = _actor_pos(env, "spice_rack")
    res = -1
    for i, obj in enumerate(("dtc_green_can_fr3", "dtc_red_tomato_can_fr3")):
        spread = 0.05 if i == 0 else -0.05
        place = goal + np.array([spread, 0.0, 0.15 - 0.02 * i], np.float32)
        res = pick_and_place(env, planner, obj, place, grasp_z=0.03,
                             settle=0 if i == 0 else 10)
        if res == -1:
            return -1
    planner.close()
    return res


def solvePnpBoxFr3(env, seed=None, debug=False, vis=False):
    env.reset(seed=seed)
    planner = FR3UmiMotionPlanningSolver(env, debug=debug, vis=vis)
    goal = _actor_pos(env, "snack_box")
    # mustard bottle (half height 0.0955) onto the snack box (top 0.066)
    res = pick_and_place(env, planner, "006_mustard_bottle",
                         goal + np.array([0, 0, 0.16], np.float32),
                         grasp_z=0.05, hover=0.18)
    planner.close()
    return res


def solveStackFr3(env, seed=None, debug=False, vis=False):
    env.reset(seed=seed)
    planner = FR3UmiMotionPlanningSolver(env, debug=debug, vis=vis)
    goal = _actor_pos(env, "005_tomato_soup_can")
    # red can (half 0.05) on the soup can (top at goal_z + 0.051)
    res = pick_and_place(env, planner, "dtc_red_tomato_can_fr3",
                         goal + np.array([0, 0, 0.051 + 0.05 + 0.012],
                                         np.float32), grasp_z=0.03)
    planner.close()
    return res


def solvePourMustardFr3(env, seed=None, debug=False, vis=False):
    """grasp the bottle, move above the bread box, tilt (pour)."""
    env.reset(seed=seed)
    planner = FR3UmiMotionPlanningSolver(env, debug=debug, vis=vis)
    obj = _actor_pos(env, "006_mustard_bottle")
    goal = _actor_pos(env, "bread_slice")
    grasp = obj + np.array([0, 0, 0.04], np.float32)
    planner.open_gripper(steps=3)
    if planner.move_to_pose_with_screw(grasp + [0, 0, 0.15], TOPDOWN_Q) == -1:
        return -1
    if planner.move_to_pose_with_screw(grasp, TOPDOWN_Q, refine_steps=2,
                                       speed=0.15) == -1:
        return -1
    planner.close_gripper(steps=8)
    if planner.move_to_pose_with_screw(grasp + [0, 0, 0.2], TOPDOWN_Q,
                                       speed=0.2) == -1:
        return -1
    above = goal + np.array([0, 0, 0.25], np.float32)
    if planner.move_to_pose_with_screw(above, TOPDOWN_Q, speed=0.25) == -1:
        return -1
    tilt_q = quat_multiply(axis_angle_to_quat(_f32([np.pi / 2.5, 0.0, 0.0])),
                           _f32(TOPDOWN_Q)).numpy()
    res = planner.move_to_pose_with_screw(above, tilt_q, refine_steps=8)
    planner.close()
    return res


def solveAlignXArm(env, seed=None, debug=False, vis=False):
    env.reset(seed=seed)
    planner = XArmMotionPlanningSolver(env, debug=debug, vis=vis)
    goal = _actor_pos(env, "005_tomato_soup_can")
    # success needs xy within the soup-can radius (0.033): stack the green
    # can (half 0.065) on top of the soup can (top at goal_z + 0.051)
    res = pick_and_place(env, planner, "dtc_green_can",
                         goal + np.array([0, 0, 0.051 + 0.065 + 0.012],
                                         np.float32), grasp_z=0.03)
    planner.close()
    return res


def solveBananaRotationXArm(env, seed=None, debug=False, vis=False):
    """Grasp the banana across its short axis (OBB), lift, yaw by -60 deg
    (the reference's rotate pose, xarm6/solutions/rotate_banana.py:74-83),
    then TILT the banana about its long axis and stand it leaning on one
    end in the open finger cage before releasing.

    The lean is what satisfies the reference's is_at_table_height band
    (|z - obj_height| in [0.02, 0.05], rotate_banana.py:183-186): a banana
    resting flat has dz ~ 0, so success requires a rotated REST pose with
    the center 2-5 cm above the flat rest — i.e. leaning at ~30-40 deg
    from horizontal (the reference's drop-from-lift lands its curved mesh
    the same way)."""
    env.reset(seed=seed)
    planner = XArmMotionPlanningSolver(env, debug=debug, vis=vis)
    obj = _actor_pos(env, "011_banana")
    gq = _grasp_quat_for(env, "011_banana")
    grasp = obj + np.array([0, 0, 0.005], np.float32)
    planner.open_gripper(steps=3)
    if planner.move_to_pose_with_screw(grasp + [0, 0, 0.12], gq) == -1:
        return -1
    if planner.move_to_pose_with_screw(grasp, gq, refine_steps=2,
                                       speed=0.15) == -1:
        return -1
    planner.close_gripper(steps=8)
    if planner.move_to_pose_with_screw(grasp + [0, 0, 0.1], gq,
                                       speed=0.15) == -1:
        return -1
    # reference rotate pose: yaw -60 deg at lift height
    rot_q = quat_multiply(axis_angle_to_quat(_f32([0.0, 0.0, -np.pi / 3])),
                          _f32(gq)).numpy()
    if planner.move_to_pose_with_screw(grasp + [0, 0, 0.1], rot_q,
                                       speed=0.2) == -1:
        return -1
    # tilt ~35 deg about the (rotated) closing axis: the banana's long
    # axis pitches from horizontal so one end points down
    tcp_p, tcp_q = planner.tcp_pose()
    closing_w = quat_to_matrix(_f32(tcp_q)).numpy()[:, 1]
    tilt = quat_multiply(
        axis_angle_to_quat(_f32(closing_w * (35.0 * np.pi / 180))),
        _f32(tcp_q)).numpy()
    if planner.move_to_pose_with_screw(tcp_p, tilt, speed=0.15) == -1:
        return -1
    # lower until the low end touches and the center sits in the height
    # band (~0.055 for the 0.095 half-length box at 35 deg)
    tcp_p, _ = planner.tcp_pose()
    obj_now = _actor_pos(env, "011_banana")
    off_z = float(tcp_p[2] - obj_now[2])
    target = np.array([tcp_p[0], tcp_p[1], 0.055 + off_z], np.float32)
    if planner.move_to_pose_with_screw(target, tilt, speed=0.1,
                                       refine_steps=2) == -1:
        return -1
    # release the squeeze into a loose cage (banana leans on the lower
    # pad), then fully open and hold still
    planner.set_gripper(0.5 * (planner.CLOSED + planner.OPEN), steps=4)
    res = planner.open_gripper(steps=4)
    res = planner.hold(steps=12)
    planner.close()
    return res


def solveSpoonOnBoardXArm(env, seed=None, debug=False, vis=False):
    env.reset(seed=seed)
    planner = XArmMotionPlanningSolver(env, debug=debug, vis=vis)
    from gsworld_tpu_torch.envs.tasks.tabletop.xarm6.spoon_on_board import (
        BOARD_NAME,
        SPOON_NAME,
    )
    goal = _actor_pos(env, BOARD_NAME)
    # spoon (half z 0.012) onto the board top (board center + 0.006);
    # OBB grasp quat: the spoon's long axis lies along world y after its
    # rotz(90) init — fingers must straddle the short (2.2 cm) width
    res = pick_and_place(env, planner, SPOON_NAME,
                         goal + np.array([0, 0, 0.006 + 0.012 + 0.015],
                                         np.float32),
                         grasp_z=0.015, hover=0.12,
                         grasp_quat=_grasp_quat_for(env, SPOON_NAME))
    planner.close()
    return res


SOLUTIONS = {
    "AlignFr3Env-v1": solveAlignFr3,
    "PnpBoxFr3Env-v1": solvePnpBoxFr3,
    "StackFr3Env-v1": solveStackFr3,
    "PourMustardFr3Env-v1": solvePourMustardFr3,
    "AlignXArmEnv-v1": solveAlignXArm,
    "BananaRotationXArmEnv-v1": solveBananaRotationXArm,
    "SpoonOnBoardXArmEnv-v1": solveSpoonOnBoardXArm,
}
