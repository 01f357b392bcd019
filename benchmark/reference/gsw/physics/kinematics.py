"""Articulated kinematics: static tree description + batched FK
(port of gsworld_tpu/physics/kinematics.py).

The tree compiles to per-link numpy tables in topological order; forward
kinematics is a chain of quaternion pose compositions over a leading
batch axis.  Runs in f32, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from benchmark.reference.gsw.core.maths import (
    axis_angle_to_quat,
    pose_multiply,
    quat_multiply,
    quat_rotate,
)
from benchmark.reference.gsw.physics.spec_io import (
    JOINT_FIXED,
    JOINT_REVOLUTE,
    RobotSpec,
)


def _np_mat_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> wxyz quaternion with w >= 0 (host side)."""
    tr = R[0, 0] + R[1, 1] + R[2, 2]
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                      (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        q = np.array([(R[2, 1] - R[1, 2]) / s, 0.25 * s,
                      (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s])
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        q = np.array([(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s,
                      0.25 * s, (R[1, 2] + R[2, 1]) / s])
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        q = np.array([(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s,
                      (R[1, 2] + R[2, 1]) / s, 0.25 * s])
    q = q / np.linalg.norm(q)
    return q if q[0] >= 0 else -q


@dataclasses.dataclass(frozen=True)
class ArticulationModel:
    """Static articulation in topological order (index 0 = root link,
    parent[i] < i).  qpos follows URDF document order of movable joints,
    so the qpos tables in the calibration data apply verbatim."""

    name: str
    link_names: Tuple[str, ...]
    parent: np.ndarray           # (L,) int32, -1 for the root
    jtype: np.ndarray            # (L,) int32 joint type to the parent
    origin_pos: np.ndarray       # (L, 3) f32
    origin_quat: np.ndarray      # (L, 4) f32 wxyz
    axis: np.ndarray             # (L, 3) f32
    dof_index: np.ndarray        # (L,) int32, -1 for fixed joints
    dof_names: Tuple[str, ...]
    dof_link: np.ndarray         # (dof,) int32 link driven by each dof
    qlimits: np.ndarray          # (dof, 2) f32
    effort: np.ndarray           # (dof,) f32
    velocity: np.ndarray         # (dof,) f32
    damping: np.ndarray          # (dof,) f32
    friction: np.ndarray         # (dof,) f32
    mimic_parent: np.ndarray     # (dof,) int32, -1 = free
    mimic_mult: np.ndarray       # (dof,) f32
    mimic_offset: np.ndarray     # (dof,) f32
    mass: np.ndarray             # (L,) f32
    com_pos: np.ndarray          # (L, 3) f32
    inertia: np.ndarray          # (L, 3, 3) f32 about the COM, link frame

    @property
    def num_links(self) -> int:
        return len(self.link_names)

    @property
    def dof(self) -> int:
        return len(self.dof_names)

    def link_id(self, name: str) -> int:
        return self.link_names.index(name)


def build_articulation(spec: RobotSpec) -> ArticulationModel:
    """Compile a RobotSpec into an ArticulationModel (DFS topological
    order following URDF child order; qpos in document order)."""
    child2joint = {j.child: j for j in spec.joints}
    children: Dict[str, list] = {}
    for j in spec.joints:
        children.setdefault(j.parent, []).append(j.child)
    roots = [n for n in spec.link_names if n not in child2joint]
    if len(roots) != 1:
        raise ValueError(f"expected one root link, got {roots}")
    order = []
    stack = [roots[0]]
    while stack:
        ln = stack.pop(0)
        order.append(ln)
        stack = children.get(ln, []) + stack
    index = {n: i for i, n in enumerate(order)}

    movable = [j for j in spec.joints if j.jtype != JOINT_FIXED]
    dof_names = tuple(j.name for j in movable)
    dof_of_joint = {n: i for i, n in enumerate(dof_names)}

    L = len(order)
    parent = np.full(L, -1, np.int32)
    jtype = np.zeros(L, np.int32)
    origin_pos = np.zeros((L, 3), np.float32)
    origin_quat = np.tile(np.array([1, 0, 0, 0], np.float32), (L, 1))
    axis = np.tile(np.array([1, 0, 0], np.float32), (L, 1))
    dof_index = np.full(L, -1, np.int32)
    mass = np.zeros(L, np.float32)
    com_pos = np.zeros((L, 3), np.float32)
    inertia = np.zeros((L, 3, 3), np.float32)
    link_by_name = {l.name: l for l in spec.links}
    for i, ln in enumerate(order):
        link = link_by_name[ln]
        mass[i] = link.mass
        com_pos[i] = link.com_pos
        # rotate the inertia into the link frame: I_link = R I R^T
        inertia[i] = link.com_rot @ link.inertia @ link.com_rot.T
        j = child2joint.get(ln)
        if j is None:
            continue
        parent[i] = index[j.parent]
        jtype[i] = j.jtype
        origin_pos[i] = j.origin_pos
        origin_quat[i] = _np_mat_to_quat(j.origin_rot)
        axis[i] = j.axis
        if j.jtype != JOINT_FIXED:
            dof_index[i] = dof_of_joint[j.name]

    nd = len(movable)
    qlimits = np.zeros((nd, 2), np.float32)
    effort = np.zeros(nd, np.float32)
    velocity = np.zeros(nd, np.float32)
    damping = np.zeros(nd, np.float32)
    friction = np.zeros(nd, np.float32)
    dof_link = np.zeros(nd, np.int32)
    mimic_parent = np.full(nd, -1, np.int32)
    mimic_mult = np.ones(nd, np.float32)
    mimic_offset = np.zeros(nd, np.float32)
    for k, j in enumerate(movable):
        qlimits[k] = [j.limit_lower, j.limit_upper]
        effort[k] = j.effort if np.isfinite(j.effort) else 1e9
        velocity[k] = j.velocity if np.isfinite(j.velocity) else 1e9
        damping[k] = j.damping
        friction[k] = j.friction
        dof_link[k] = index[j.child]
        if j.mimic is not None:
            mimic_parent[k] = dof_of_joint[j.mimic.joint]
            mimic_mult[k] = j.mimic.multiplier
            mimic_offset[k] = j.mimic.offset
    if not all(parent[i] < i for i in range(1, L)):
        raise ValueError("kinematic tree is not topologically sorted")
    return ArticulationModel(
        name=spec.name, link_names=tuple(order), parent=parent, jtype=jtype,
        origin_pos=origin_pos, origin_quat=origin_quat, axis=axis,
        dof_index=dof_index, dof_names=dof_names, dof_link=dof_link,
        qlimits=qlimits, effort=effort, velocity=velocity, damping=damping,
        friction=friction, mimic_parent=mimic_parent, mimic_mult=mimic_mult,
        mimic_offset=mimic_offset, mass=mass, com_pos=com_pos,
        inertia=inertia)


def model_tensors(model: ArticulationModel, device) -> Dict[str, torch.Tensor]:
    """The model's numpy tables as tensors on ``device``: built once per
    (model, device) and kept on the model, so a step copies nothing from
    the host.  Floats are f32, index tables int64."""
    cache = model.__dict__.setdefault("_tensors", {})
    device = torch.device(device)
    if device not in cache:
        out = {}
        for f in dataclasses.fields(model):
            v = getattr(model, f.name)
            if isinstance(v, np.ndarray):
                dt = torch.float32 if v.dtype.kind == "f" else torch.long
                out[f.name] = torch.as_tensor(v, dtype=dt, device=device)
        cache[device] = out
    return cache[device]


def forward_kinematics(model: ArticulationModel, qpos: torch.Tensor,
                       root_pos=None, root_quat=None):
    """Batched FK: qpos (..., dof) -> (link_pos (..., L, 3),
    link_quat (..., L, 4)) in the frame of the root pose (default
    identity)."""
    batch = qpos.shape[:-1]
    kw = dict(dtype=qpos.dtype, device=qpos.device)
    if root_pos is None:
        root_pos = torch.zeros(batch + (3,), **kw)
    if root_quat is None:
        # filled on the device: no host copy, so a CUDA graph captures it
        root_quat = torch.zeros(batch + (4,), **kw)
        root_quat[..., 0] = 1.0
    mt = model_tensors(model, qpos.device)
    origin_pos = mt["origin_pos"].to(qpos.dtype)
    origin_quat = mt["origin_quat"].to(qpos.dtype)
    axis = mt["axis"].to(qpos.dtype)

    pos = [root_pos.expand(batch + (3,))]
    quat = [root_quat.expand(batch + (4,))]
    for i in range(1, model.num_links):
        op, oq = origin_pos[i], origin_quat[i]
        di = int(model.dof_index[i])
        if int(model.jtype[i]) == JOINT_FIXED or di < 0:
            p_local, q_local = op, oq
        elif int(model.jtype[i]) == JOINT_REVOLUTE:
            jq = axis_angle_to_quat(axis[i] * qpos[..., di, None])
            p_local, q_local = op, quat_multiply(oq, jq)
        else:                                            # prismatic
            p_local = op + quat_rotate(oq, axis[i] * qpos[..., di, None])
            q_local = oq
        pi = int(model.parent[i])
        p, q = pose_multiply(pos[pi], quat[pi], p_local, q_local)
        pos.append(p.expand(batch + (3,)))
        quat.append(q.expand(batch + (4,)))
    return torch.stack(pos, dim=-2), torch.stack(quat, dim=-2)


def apply_mimic(model: ArticulationModel, qpos: torch.Tensor):
    """Overwrite mimic dofs from their parents: q_m = mult * q_p + offset."""
    mt = model_tensors(model, qpos.device)
    mp = mt["mimic_parent"]
    mult = mt["mimic_mult"].to(qpos.dtype)
    off = mt["mimic_offset"].to(qpos.dtype)
    parent_q = qpos[..., mp.clamp_min(0)]
    return torch.where(mp >= 0, mult * parent_q + off, qpos)
