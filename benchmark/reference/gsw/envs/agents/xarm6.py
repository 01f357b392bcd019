"""xArm6 + UFactory gripper agent family (port of
gsworld_tpu/envs/agents/xarm6.py).

Gains: arm kp=1e4, kd=1e3, force 100; gripper kp=1e5, kd=2e3, force 0.1.
The gripper is a six-joint linkage closed by two point-to-point drives in
the reference simulator; in reduced coordinates every passive linkage
joint follows its side's knuckle drive one to one (the axes in the spec
carry the signs), so here they are hard mimics of ``drive_joint`` and
``right_outer_knuckle_joint``.  One absolute action in [0, 0.85] drives
both knuckles (the mimic finger controller).

Departure from GSWorld's ``xarm6_uf_gripper.py``: the two loop-closing
drives are hard mimics here, so the linkage cannot open against a
knuckle's drive.  A random action's gripper channel, drawn in [-1, 1)
as every channel is, is clipped to the knuckles' limits [0, 0.85], where
ManiSkill's ``action_space.sample()`` draws in [0, 0.85].
"""

from __future__ import annotations

from benchmark.reference.gsw import constants
from benchmark.reference.gsw.envs.agents.base import AgentSpec, register_agent
from benchmark.reference.gsw.envs.controllers import (
    CompositeController,
    JointGroupConfig,
)
from benchmark.reference.gsw.physics.kinematics import build_articulation
from benchmark.reference.gsw.physics.spec_io import MimicSpec, load_robot_spec

XARM_UIDS = ("xarm6_uf_gripper", "xarm6_uf_gripper_wrist435")

# passive linkage joint -> the knuckle drive it follows
_MIMICS = {
    "left_inner_knuckle_joint": "drive_joint",
    "left_finger_joint": "drive_joint",
    "right_inner_knuckle_joint": "right_outer_knuckle_joint",
    "right_finger_joint": "right_outer_knuckle_joint",
}


def _xarm_agent(uid: str) -> AgentSpec:
    spec = load_robot_spec(uid)
    for j in spec.joints:
        if j.name in _MIMICS:
            j.mimic = MimicSpec(_MIMICS[j.name], 1.0)
    model = build_articulation(spec)
    arm_ids = tuple(model.dof_names.index(f"joint{i}") for i in range(1, 7))
    finger_ids = (model.dof_names.index("drive_joint"),
                  model.dof_names.index("right_outer_knuckle_joint"))
    arm = dict(stiffness=1e4, damping=1e3, force_limit=100.0)

    arm_pd_joint_pos = JointGroupConfig(
        dof_ids=arm_ids, lower=None, upper=None, normalize_action=False,
        **arm)
    arm_pd_joint_delta_pos = JointGroupConfig(
        dof_ids=arm_ids, lower=-0.1, upper=0.1, use_delta=True,
        normalize_action=True, **arm)
    # one absolute action drives both knuckles; the mimics are slaved
    finger_mimic = JointGroupConfig(
        dof_ids=finger_ids, lower=None, upper=None, mimic=True,
        normalize_action=False, stiffness=1e5, damping=2e3, force_limit=0.1)

    controllers = {
        "pd_joint_delta_pos": CompositeController(
            groups=(arm_pd_joint_delta_pos, finger_mimic), model=model),
        "pd_joint_pos": CompositeController(
            groups=(arm_pd_joint_pos, finger_mimic), model=model),
    }
    return AgentSpec(
        uid=uid, spec=spec, model=model, controllers=controllers,
        default_control_mode="pd_joint_delta_pos",
        ee_link="xarm_hand_tcp", base_link="link_base",
        finger_links=("left_finger", "right_finger"),
        contact_links=("left_finger", "right_finger",
                       "xarm_gripper_base_link"),
        arm_dof_ids=arm_ids, gripper_dof_ids=finger_ids,
        finger_friction=2.0,          # the pads' high-friction material
        finger_open_axes=((1, 1.0), (1, -1.0)),
    )


for _uid in XARM_UIDS:
    register_agent(_uid, lambda uid=_uid: _xarm_agent(uid))


def get_gripper_state(qpos, model):
    """True where the gripper is closed: ``drive_joint`` beyond
    ``UFGRIPPER_CLOSED_THRESHOLD``."""
    di = model.dof_names.index("drive_joint")
    return qpos[..., di] > constants.UFGRIPPER_CLOSED_THRESHOLD
