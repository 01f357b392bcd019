"""FR3 + UMI gripper agent family (port of
gsworld_tpu/envs/agents/fr3_umi.py).

Gains and limits: arm kp=1e3, kd=1e2, force 100; gripper identical.
Controller set: pd_joint_pos, pd_joint_delta_pos, pd_ee_delta_pos,
pd_ee_delta_pose (the two end-effector modes resolve TCP deltas by the
damped-least-squares IK of physics/ik.py).  Grasp check:
contact force >= 0.5 N and angle between the finger-opening direction and
the contact force <= 85 deg.
"""

from __future__ import annotations

from benchmark.reference.gsw.envs.agents.base import (
    AgentSpec,
    get_agent,
    register_agent,
)
from benchmark.reference.gsw.envs.controllers import (
    CompositeController,
    EEGroupConfig,
    JointGroupConfig,
)
from benchmark.reference.gsw.physics.kinematics import build_articulation
from benchmark.reference.gsw.physics.spec_io import load_robot_spec

FR3_UIDS = ("fr3_umi", "fr3_umi_wrist435", "fr3_umi_wrist435_cam_mount")


def _fr3_agent(uid: str) -> AgentSpec:
    spec = load_robot_spec(uid)
    model = build_articulation(spec)
    arm_ids = tuple(model.dof_names.index(f"fr3_joint{i}")
                    for i in range(1, 8))
    grip_ids = tuple(model.dof_names.index(f"fr3_finger_joint{i}")
                     for i in (1, 2))
    gains = dict(stiffness=1e3, damping=1e2, force_limit=100.0)

    arm_pd_joint_pos = JointGroupConfig(
        dof_ids=arm_ids, lower=None, upper=None, normalize_action=False,
        **gains)
    arm_pd_joint_delta_pos = JointGroupConfig(
        dof_ids=arm_ids, lower=-0.1, upper=0.1, use_delta=True,
        normalize_action=True, **gains)
    gripper = JointGroupConfig(
        dof_ids=grip_ids, lower=-0.01, upper=0.04, mimic=True,
        normalize_action=True, **gains)
    arm_pd_ee_delta_pos = EEGroupConfig(
        dof_ids=arm_ids, ee_link="fr3_hand_tcp", use_rotation=False, **gains)
    arm_pd_ee_delta_pose = EEGroupConfig(
        dof_ids=arm_ids, ee_link="fr3_hand_tcp", use_rotation=True, **gains)

    controllers = {
        "pd_joint_delta_pos": CompositeController(
            groups=(arm_pd_joint_delta_pos, gripper), model=model),
        "pd_joint_pos": CompositeController(
            groups=(arm_pd_joint_pos, gripper), model=model),
        "pd_ee_delta_pos": CompositeController(
            groups=(arm_pd_ee_delta_pos, gripper), model=model),
        "pd_ee_delta_pose": CompositeController(
            groups=(arm_pd_ee_delta_pose, gripper), model=model),
    }
    return AgentSpec(
        uid=uid, spec=spec, model=model, controllers=controllers,
        default_control_mode="pd_joint_delta_pos",
        ee_link="fr3_hand_tcp", base_link="base",
        finger_links=("fr3_leftfinger", "fr3_rightfinger"),
        contact_links=("fr3_leftfinger", "fr3_rightfinger", "fr3_hand"),
        arm_dof_ids=arm_ids, gripper_dof_ids=grip_ids,
        finger_friction=2.0,
        # opening dirs: +y of left finger, -y of right finger
        finger_open_axes=((1, 1.0), (1, -1.0)),
    )


for _uid in FR3_UIDS:
    register_agent(_uid, lambda uid=_uid: _fr3_agent(uid))


def fr3_agent(uid: str = "fr3_umi") -> AgentSpec:
    """The registered FR3 agent ``uid`` (built once per process)."""
    if uid not in FR3_UIDS:
        raise KeyError(f"unknown FR3 agent uid {uid!r}; known: {FR3_UIDS}")
    return get_agent(uid)
