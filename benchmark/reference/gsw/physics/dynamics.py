"""Articulated rigid-body dynamics in reduced (joint) coordinates (port of
gsworld_tpu/physics/dynamics.py), with the env axis B written out.

  * world-frame spatial algebra with the (omega, v_at_origin) twist
    convention; motion subspaces S_i are recomputed from FK each substep;
  * mass matrix via CRBA, bias forces (Coriolis, centrifugal + gravity)
    via RNEA with qddot = 0, both as dense contractions over the static
    ancestor mask;
  * PD joint drives with stiffness/damping and force limits, integrated
    implicitly in the damping term for stability at 120 Hz;
  * mimic dofs are hard-slaved (q_m = mult*q_p + offset) and their drive
    torques folded onto the parent dof.

Everything is f32 and static-shaped; no function asks the host for a
value, so a step can be captured into a CUDA graph.  The static tables
are tensors built once per (model, device) by :func:`dyn_tensors`.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from benchmark.reference.gsw.core.maths import quat_to_matrix
from benchmark.reference.gsw.physics.kinematics import (
    ArticulationModel,
    forward_kinematics,
    model_tensors,
)
from benchmark.reference.gsw.physics.spec_io import JOINT_REVOLUTE

GRAVITY = (0.0, 0.0, -9.81)

cross = torch.linalg.cross


def _skew(v):
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], -1),
        torch.stack([z, zero, -x], -1),
        torch.stack([-y, x, zero], -1),
    ], -2)


class KinState(NamedTuple):
    """Per-substep kinematic quantities derived from qpos."""

    link_pos: torch.Tensor   # (B, L, 3)
    link_quat: torch.Tensor  # (B, L, 4)
    S: torch.Tensor          # (B, dof, 6) motion subspace [omega; v_origin]
    com_w: torch.Tensor      # (B, L, 3) world COM per link
    Iw: torch.Tensor         # (B, L, 3, 3) world rotational inertia about COM


def _ancestor_dofs(model: ArticulationModel) -> np.ndarray:
    """Static (L, dof) bool: dof j is on the path from root to link i."""
    L, nd = model.num_links, model.dof
    anc = np.zeros((L, nd), bool)
    for i in range(L):
        k = i
        while k >= 0:
            d = model.dof_index[k]
            if d >= 0:
                anc[i, d] = True
            k = model.parent[k]
    return anc


def mimic_basis(model: ArticulationModel) -> np.ndarray:
    """Static (dof, dof) mimic reduction basis T: independent dof columns
    are unit vectors; a follower dof's row carries ``mult`` in its parent's
    column and its own column is zero.  Projecting the dynamics through T
    (M_r = T^T M T, tau_r = T^T tau) makes PD drives and contact impulses
    consistent with the hard mimic constraint."""
    nd = model.dof
    T = np.eye(nd)
    mp = model.mimic_parent
    for f in range(nd):
        if mp[f] >= 0:
            T[f, f] = 0.0
            T[f, mp[f]] = model.mimic_mult[f]
    return T


def dyn_tensors(model: ArticulationModel, device) -> Dict[str, torch.Tensor]:
    """``model_tensors`` plus the derived static tables of this module
    (ancestor mask, mimic basis, clamped masses, ...), built once per
    (model, device)."""
    mt = model_tensors(model, device)
    if "anc" not in mt:
        f32 = dict(dtype=torch.float32, device=mt["axis"].device)
        mt["anc"] = torch.as_tensor(_ancestor_dofs(model), **f32)
        mt["mass_pos"] = torch.as_tensor(np.maximum(model.mass, 1e-6), **f32)
        mt["axis_dof"] = mt["axis"][mt["dof_link"]]
        mt["is_rev"] = torch.as_tensor(
            model.jtype[model.dof_link] == JOINT_REVOLUTE,
            device=f32["device"])[:, None]
        mt["mimic_T"] = torch.as_tensor(mimic_basis(model), **f32)
        mt["follower"] = torch.as_tensor(model.mimic_parent >= 0, **f32)
        mt["is_mimic"] = mt["mimic_parent"] >= 0
        mt["mimic_src"] = mt["mimic_parent"].clamp_min(0)
        mt["eye_dof"] = torch.eye(model.dof, **f32)
        mt["eye3"] = torch.eye(3, **f32)
        mt["neg_gravity"] = -torch.tensor(GRAVITY, **f32)
    return mt


def compute_kinematics(model: ArticulationModel, qpos, root_pos=None,
                       root_quat=None) -> KinState:
    """qpos (B, dof), root pose (B, 3), (B, 4) -> KinState."""
    mt = dyn_tensors(model, qpos.device)
    link_pos, link_quat = forward_kinematics(model, qpos, root_pos, root_quat)
    R = quat_to_matrix(link_quat)                          # (B, L, 3, 3)
    com_w = link_pos + torch.einsum("nlij,lj->nli", R, mt["com_pos"])
    Iw = torch.einsum("nlij,ljk,nlmk->nlim", R, mt["inertia"], R)

    # motion subspace per dof, in world frame at the world origin
    dof_link = mt["dof_link"]
    jp = link_pos[:, dof_link]                             # joint frame pos
    jR = R[:, dof_link]
    axis_w = torch.einsum("ndij,dj->ndi", jR, mt["axis_dof"])
    is_rev = mt["is_rev"]
    S_ang = torch.where(is_rev, axis_w, 0.0)
    S_lin = torch.where(is_rev, cross(jp, axis_w), axis_w)
    S = torch.cat([S_ang, S_lin], dim=-1)                  # (B, dof, 6)
    return KinState(link_pos=link_pos, link_quat=link_quat, S=S,
                    com_w=com_w, Iw=Iw)


def _spatial_inertia(model: ArticulationModel, kin: KinState):
    """World-frame 6x6 spatial inertia per link (about the world origin)."""
    mt = dyn_tensors(model, kin.S.device)
    m = mt["mass_pos"][:, None, None]                      # avoid singular M
    cx = _skew(kin.com_w)
    mI3 = (m * mt["eye3"]).expand(cx.shape)
    top_left = kin.Iw - m * (cx @ cx)
    top_right = m * cx
    top = torch.cat([top_left, top_right], dim=-1)
    bot = torch.cat([-top_right, mI3], dim=-1)
    return torch.cat([top, bot], dim=-2)                   # (B, L, 6, 6)


def mass_matrix(model: ArticulationModel, kin: KinState):
    """CRBA in world coordinates as one dense contraction:
    M[a, b] = sum_l (anc_l . S)_a^T I_l (anc_l . S)_b."""
    Isp = _spatial_inertia(model, kin)                     # (B, L, 6, 6)
    anc = dyn_tensors(model, kin.S.device)["anc"]          # (L, dof)
    X = anc[None, :, :, None] * kin.S[:, None]             # (B, L, dof, 6)
    return torch.einsum("nlai,nlij,nlcj->nac", X, Isp, X)


def _cross_m(a, b):
    # motion cross: [wa x wb ; va x wb + wa x vb]
    wa, va = a[..., :3], a[..., 3:]
    wb, vb = b[..., :3], b[..., 3:]
    return torch.cat([cross(wa, wb), cross(va, wb) + cross(wa, vb)], dim=-1)


def _cross_f(a, h):
    # force cross: [wa x hw + va x hv ; wa x hv]
    wa, va = a[..., :3], a[..., 3:]
    hw, hv = h[..., :3], h[..., 3:]
    return torch.cat([cross(wa, hw) + cross(va, hv), cross(wa, hv)], dim=-1)


def bias_forces(model: ArticulationModel, kin: KinState, qvel,
                gravity=None):
    """RNEA with qddot = 0 as a handful of dense batched contractions.

    With the static ancestor mask anc (L, dof), the recursions flatten:
      V_l = sum_d anc[l,d] S_d qd_d
      A_l = a_root + sum_d anc[l,d] (V_{link(d)} x_m S_d qd_d)
      F_l = I_l A_l + V_l x* (I_l V_l)
      tau_d = S_d . sum_l anc[l,d] F_l
    ``gravity`` is a (3,) tensor; default (0, 0, -9.81).
    """
    mt = dyn_tensors(model, qvel.device)
    Isp = _spatial_inertia(model, kin)                     # (B, L, 6, 6)
    S = kin.S                                              # (B, dof, 6)
    anc = mt["anc"]

    Sq = S * qvel[..., None]                               # (B, dof, 6)
    V = torch.einsum("ld,ndi->nli", anc, Sq)               # (B, L, 6)
    c = _cross_m(V[:, mt["dof_link"]], Sq)                 # (B, dof, 6)
    a_root = torch.cat([
        torch.zeros(3, dtype=S.dtype, device=S.device),
        mt["neg_gravity"] if gravity is None else -gravity])
    A = a_root + torch.einsum("ld,ndi->nli", anc, c)       # (B, L, 6)

    IA = torch.einsum("nlij,nlj->nli", Isp, A)
    IV = torch.einsum("nlij,nlj->nli", Isp, V)
    F = IA + _cross_f(V, IV)                               # (B, L, 6)
    return torch.einsum("ld,nli,ndi->nd", anc, F, S)


def _inv(A):
    """Batched inverse with no error check (a check reads a device value
    on the host)."""
    return torch.linalg.inv_ex(A).inverse


def implicit_pd_velocity(model: ArticulationModel, M, bias, qpos, qvel,
                         q_target, kp, kd, force_limit, h: float,
                         tau_external=None):
    """Force-limited implicit PD velocity update.

    The total drive force kp(q*-q) - kd qd is clamped to +-limit.  A naive
    implicit formulation keeps full kd damping in the system matrix, which
    freezes joints whose required force far exceeds the limit.  So: solve
    once with full gains, estimate the implied drive force, scale each
    dof's (kp, kd) by min(1, limit/|force|), and re-solve.

    Mimic dofs are eliminated through the reduction basis T: the returned
    impulse response is P = T (T^T A T)^-1 T^T, so generalized forces on
    followers fold onto their parents and resulting velocities always
    satisfy qvel_f = mult * qvel_p.

    kp, kd, force_limit: (dof,) tensors.  Returns (qvel_new (B, dof),
    Minv_eff (B, dof, dof)) with Minv_eff = P, the impulse response used
    by the contact solver.
    """
    mt = dyn_tensors(model, qpos.device)
    T = mt["mimic_T"]
    has_mimic = bool((model.mimic_parent >= 0).any())
    damping = mt["damping"]

    def project_inv(A):
        if not has_mimic:
            return _inv(A)
        Ar = T.T @ A @ T + torch.diag(mt["follower"])  # follower cols zero
        return T @ _inv(Ar) @ T.T

    def solve(kp_e, kd_e):
        tau = kp_e * (q_target - qpos) - kd_e * qvel
        tau = torch.clamp(tau, -force_limit, force_limit)
        if tau_external is not None:
            tau = tau + tau_external
        damp = kd_e + damping
        A = M + h * torch.diag_embed(damp)
        Minv = project_inv(A)
        # joint damping also opposes the *current* velocity, not only the
        # velocity change: (M + h(kd+d)) dv = h (tau - d qvel - bias)
        tau_t = tau - damping * qvel
        qv = qvel + (Minv @ (h * (tau_t - bias))[..., None])[..., 0]
        return qv, Minv

    qv1, _ = solve(kp, kd)
    tau_impl = kp * (q_target - qpos) - kd * qv1
    scale = torch.clamp_max(force_limit / tau_impl.abs().clamp_min(1e-9),
                            1.0)
    return solve(kp * scale, kd * scale)


def slave_mimics(model: ArticulationModel, qpos, qvel):
    if not (model.mimic_parent >= 0).any():
        return qpos, qvel
    mt = dyn_tensors(model, qpos.device)
    src, is_m = mt["mimic_src"], mt["is_mimic"]
    mult = mt["mimic_mult"]
    qpos = torch.where(is_m, mult * qpos[..., src] + mt["mimic_offset"], qpos)
    qvel = torch.where(is_m, mult * qvel[..., src], qvel)
    return qpos, qvel


def integrate_joints(model: ArticulationModel, qpos, qvel, h: float):
    """Velocity limits, semi-implicit Euler, joint-limit stops (inward
    velocity zeroed at the stops) and the mimic slaving."""
    mt = dyn_tensors(model, qpos.device)
    vmax = mt["velocity"]
    lo, hi = mt["qlimits"][:, 0], mt["qlimits"][:, 1]
    qvel = torch.clamp(qvel, -vmax, vmax)
    qpos = torch.clamp(qpos + h * qvel, lo, hi)
    qvel = torch.where((qpos <= lo) & (qvel < 0), 0.0, qvel)
    qvel = torch.where((qpos >= hi) & (qvel > 0), 0.0, qvel)
    return slave_mimics(model, qpos, qvel)


def step_articulation_free(model: ArticulationModel, qpos, qvel, q_target,
                           kp, kd, force_limit, h: float,
                           tau_external=None, root_pos=None, root_quat=None,
                           gravity=None):
    """One contact-free articulation substep (implicit-damping Euler).

    Solves (M + h*diag(kd + joint_damping)) dv = h * (tau_pd + tau_ext - bias)
    then integrates.  Returns (qpos', qvel', kin_state_before_integration).
    """
    kin = compute_kinematics(model, qpos, root_pos, root_quat)
    M = mass_matrix(model, kin)
    bias = bias_forces(model, kin, qvel, gravity)
    qvel_new, _ = implicit_pd_velocity(
        model, M, bias, qpos, qvel, q_target, kp, kd, force_limit, h,
        tau_external=tau_external)
    qpos_new, qvel_new = integrate_joints(model, qpos, qvel_new, h)
    return qpos_new, qvel_new, kin
