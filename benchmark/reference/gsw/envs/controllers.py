"""Joint-space PD controllers: action -> PD drive targets (port of
gsworld_tpu/envs/controllers.py).

``pd_joint_pos``, ``pd_joint_delta_pos`` and the mimic gripper controller.
A controller maps a (possibly normalized) action to per-dof PD position
targets; the PD gains themselves live in the physics scene (world.py).

The EE-space controllers (``pd_ee_delta_pos``, ``pd_ee_delta_pose``)
resolve normalized TCP deltas to arm joint targets by damped-least-squares
IK over the Jacobian of the pose error (``physics/ik.py``), a fixed number
of iterations with no host read, so the step stays capturable.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from benchmark.reference.gsw.core.maths import axis_angle_to_quat, quat_to_matrix
from benchmark.reference.gsw.physics import ik
from benchmark.reference.gsw.physics.kinematics import (
    ArticulationModel,
    model_tensors,
)


@dataclasses.dataclass(frozen=True)
class JointGroupConfig:
    """One controlled joint group (arm or gripper)."""

    dof_ids: Tuple[int, ...]       # indices into the articulation qpos
    lower: Optional[float]         # action bound (None: joint limits)
    upper: Optional[float]
    use_delta: bool = False
    normalize_action: bool = True
    mimic: bool = False            # single action replicated to all dofs
    stiffness: float = 1e3
    damping: float = 1e2
    force_limit: float = 100.0

    @property
    def action_dim(self) -> int:
        return 1 if self.mimic else len(self.dof_ids)


@dataclasses.dataclass(frozen=True)
class EEGroupConfig:
    """End-effector delta controller (pd_ee_delta_pos / pd_ee_delta_pose):
    normalized deltas on the TCP pose, resolved to arm joint targets by
    damped-least-squares IK over the FK Jacobian."""

    dof_ids: Tuple[int, ...]          # arm dofs the IK solves over
    ee_link: str
    use_rotation: bool = False        # False: pos-only (3 actions)
    pos_lower: float = -0.1
    pos_upper: float = 0.1
    rot_lower: float = -0.1
    rot_upper: float = 0.1
    stiffness: float = 1e3
    damping: float = 1e2
    force_limit: float = 100.0
    ik_iters: int = 12

    @property
    def action_dim(self) -> int:
        return 6 if self.use_rotation else 3


@dataclasses.dataclass(frozen=True)
class CompositeController:
    """Ordered joint groups; actions are concatenated group actions."""

    groups: Tuple                      # JointGroupConfig | EEGroupConfig
    model: ArticulationModel

    @property
    def action_dim(self) -> int:
        return sum(g.action_dim for g in self.groups)

    def gains(self):
        """(kp, kd, force_limit) arrays over the full dof vector."""
        nd = self.model.dof
        kp = np.zeros(nd, np.float32)
        kd = np.zeros(nd, np.float32)
        fl = np.zeros(nd, np.float32)
        for g in self.groups:
            for d in g.dof_ids:
                kp[d], kd[d], fl[d] = g.stiffness, g.damping, g.force_limit
        return kp, kd, fl

    def compute_targets(self, qpos, prev_target, action,
                        root_pos=None, root_quat=None):
        """Map an action (..., action_dim) to PD targets (..., dof).

        Uncontrolled dofs hold their previous target (mimic dofs are
        slaved in the dynamics layer anyway).
        """
        mt = model_tensors(self.model, qpos.device)
        lo_j, hi_j = mt["qlimits"][:, 0], mt["qlimits"][:, 1]
        target = prev_target
        ofs = 0
        for g in self.groups:
            a = action[..., ofs:ofs + g.action_dim]
            ofs += g.action_dim
            # the group's dof ids as a tensor, made once per device
            key = ("dof_ids", g.dof_ids)
            if key not in mt:
                mt[key] = torch.as_tensor(g.dof_ids, dtype=torch.long,
                                          device=qpos.device)
            ids = mt[key]
            if isinstance(g, EEGroupConfig):
                q_sol = self._ee_solution(g, qpos, a, root_pos, root_quat)
                target = target.index_copy(-1, ids, q_sol[..., ids])
                continue
            if g.mimic:
                a = a.expand(a.shape[:-1] + (len(g.dof_ids),))
            if g.use_delta:
                lo = g.lower if g.lower is not None else -0.1
                hi = g.upper if g.upper is not None else 0.1
                if g.normalize_action:
                    # clip to [-1, 1] BEFORE rescaling
                    a = lo + (a.clamp(-1.0, 1.0) + 1.0) * 0.5 * (hi - lo)
                else:
                    a = a.clamp(lo, hi)
                new = qpos[..., ids] + a
            else:
                lo = g.lower if g.lower is not None else lo_j[ids]
                hi = g.upper if g.upper is not None else hi_j[ids]
                if g.normalize_action:
                    a = lo + (a.clamp(-1.0, 1.0) + 1.0) * 0.5 * (hi - lo)
                new = torch.clamp(a, lo, hi)
            target = target.index_copy(
                -1, ids, torch.clamp(new, lo_j[ids], hi_j[ids]))
        return target

    def _ee_solution(self, g: EEGroupConfig, qpos, a, root_pos, root_quat):
        """Joint solution (B, dof) of an end-effector delta action ``a``
        (B, 3 or 6): clipped to [-1, 1] and scaled, the TCP target is
        p + dp and, in pose mode, ``axis_angle_to_quat(drot) (x) q``;
        then ``g.ik_iters`` IK steps from ``qpos``."""
        chain = ik.ik_chain(self.model, g.ee_link, qpos.device)
        T_root = ik.root_transform(root_pos, root_quat, qpos.shape[:-1],
                                   qpos.device)
        fk0 = ik.chain_fk(chain, qpos, T_root)
        a = a.clamp(-1.0, 1.0)
        dp = (g.pos_lower + (a[..., :3] + 1.0) * 0.5
              * (g.pos_upper - g.pos_lower))
        p_t, R_t = fk0[0][:, :3, 3] + dp, fk0[0][:, :3, :3]
        if g.use_rotation:
            drot = (g.rot_lower + (a[..., 3:6] + 1.0) * 0.5
                    * (g.rot_upper - g.rot_lower))
            R_t = quat_to_matrix(axis_angle_to_quat(drot)) @ R_t
        return ik.dls_iterations(chain, qpos, p_t, R_t, T_root, g.dof_ids,
                                 g.ik_iters, first_fk=fk0)
