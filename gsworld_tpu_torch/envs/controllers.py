"""Joint-space PD controllers: action -> PD drive targets (port of
gsworld_tpu/envs/controllers.py).

``pd_joint_pos``, ``pd_joint_delta_pos`` and the mimic gripper controller.
A controller maps a (possibly normalized) action to per-dof PD position
targets; the PD gains themselves live in the physics scene (world.py).

The EE-space controllers (pd_ee_delta_pos/pose) resolve TCP deltas by
damped-least-squares IK, which lives in ``physics/ik.py``; that module is
not ported yet, so those modes raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from gsworld_tpu_torch.physics.kinematics import (
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
            if isinstance(g, EEGroupConfig):
                raise NotImplementedError(
                    "end-effector control modes (pd_ee_delta_pos, "
                    "pd_ee_delta_pose) need the IK of physics/ik.py, which "
                    "is not ported yet")
            # the group's dof ids as a tensor, made once per device
            key = ("dof_ids", g.dof_ids)
            if key not in mt:
                mt[key] = torch.as_tensor(g.dof_ids, dtype=torch.long,
                                          device=qpos.device)
            ids = mt[key]
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
