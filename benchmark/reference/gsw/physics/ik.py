"""Differential inverse kinematics: damped least squares over the Jacobian
of the 6-D pose error (port of gsworld_tpu/physics/ik.py).

The JAX package differentiates the pose error with ``jacfwd``.  Here the
Jacobian is written out, so an iteration runs one forward kinematics pass
and no autodiff, and the solve stays capturable in a CUDA graph (no host
read, no data-dependent loop exit, no routine that checks on the host):

* forward kinematics runs over the chain from the root to ``ee_link``
  only, as 4x4 products: the fixed joints fold into one constant
  transform before each movable joint and one after the last;
* the geometric Jacobian of joint j with world axis w_j through o_j is
  (w_j x (p - o_j), w_j) for a revolute joint and (w_j, 0) for a
  prismatic one;
* the rotation rows chain it through the rotation-vector map of the
  error quaternion dq = q_t (x) q^-1 (sign-flipped to w >= 0): a joint
  turning the end effector by w_j moves dq by -0.5 dq (x) (0, w_j), and
  rotvec = (angle / s) v with angle = 2 acos(w), s = sqrt(1 - w^2),
  or 2 v below 1e-6 rad, as the JAX error function defines it;
* ``J J^T + damping I`` (6x6, SPD) is solved by ``cholesky_ex`` and two
  triangular solves, where the JAX package takes LU: both agree to f32
  rounding.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as Fn

from benchmark.reference.gsw.core.maths import (
    quat_conjugate,
    quat_multiply,
    quat_normalize,
    quat_to_matrix,
    tf_from_pq,
)
from benchmark.reference.gsw.physics.kinematics import (
    ArticulationModel,
    forward_kinematics,
)
from benchmark.reference.gsw.physics.spec_io import JOINT_FIXED, JOINT_REVOLUTE


def ee_pose_fn(model: ArticulationModel, ee_link: str):
    """f(qpos, root_pos=None, root_quat=None) -> (pos (..., 3), quat
    (..., 4)) of ``ee_link`` from the model's full forward kinematics."""
    ee_id = model.link_id(ee_link)

    def f(qpos, root_pos=None, root_quat=None):
        pos, quat = forward_kinematics(model, qpos, root_pos, root_quat)
        return pos[..., ee_id, :], quat[..., ee_id, :]

    return f


def pose_error(p, q, p_t, q_t):
    """6-D pose error (position, rotation vector) from the current pose
    (p, q) to the target (p_t, q_t)."""
    dq = quat_multiply(q_t, quat_conjugate(quat_normalize(q)))
    dq = torch.where(dq[..., :1] < 0, -dq, dq)
    w = dq[..., 0].clamp(-1.0, 1.0)
    angle = 2.0 * torch.arccos(w)
    s = torch.sqrt((1.0 - w * w).clamp_min(1e-12))
    axis = dq[..., 1:] / s[..., None]
    rotvec = torch.where(angle[..., None] < 1e-6, 2.0 * dq[..., 1:],
                         axis * angle[..., None])
    return torch.cat([p_t - p, rotvec], dim=-1)


def _skew4(a):
    K = np.zeros((4, 4))
    K[:3, :3] = [[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]]
    return K


def _local_tf(model: ArticulationModel, i: int) -> np.ndarray:
    """Origin transform of link ``i`` in its parent's frame (float64)."""
    w, x, y, z = model.origin_quat[i].astype(np.float64)
    T = np.eye(4)
    T[:3, :3] = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)],
                 [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)],
                 [2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)]]
    T[:3, 3] = model.origin_pos[i]
    return T


# rows of the Shepperd candidates as linear maps of (1, m00 .. m22): case
# k's quadruple is 4 q_k q (unnormalised), seeded by its own component
_SHEPPERD = np.zeros((10, 4, 4), np.float32)      # (input, case, component)
for _case, _rows in enumerate([
        [{0: 1, 1: 1, 5: 1, 9: 1}, {8: 1, 6: -1}, {3: 1, 7: -1},
         {4: 1, 2: -1}],
        [{8: 1, 6: -1}, {0: 1, 1: 1, 5: -1, 9: -1}, {2: 1, 4: 1},
         {3: 1, 7: 1}],
        [{3: 1, 7: -1}, {2: 1, 4: 1}, {0: 1, 1: -1, 5: 1, 9: -1},
         {6: 1, 8: 1}],
        [{4: 1, 2: -1}, {3: 1, 7: 1}, {6: 1, 8: 1},
         {0: 1, 1: -1, 5: -1, 9: 1}]]):
    for _comp, _terms in enumerate(_rows):
        for _inp, _c in _terms.items():
            _SHEPPERD[_inp, _case, _comp] = _c


class _Chain:
    """Tables of the chain from the root to ``ee_link`` on one device:
    for each movable joint j on it, the constant transform C_j from the
    previous movable joint's frame (or the root) to its origin, the
    generators of its motion (skew K_j, K_j^2 of a revolute axis;
    translation P_j of a prismatic one) and its dof; the constant tail
    from the last movable joint to the end effector."""

    def __init__(self, model: ArticulationModel, ee_link: str, device):
        path = []
        i = model.link_id(ee_link)
        while i > 0:
            path.append(i)
            i = int(model.parent[i])
        path.reverse()
        C, K, K2, P, axes, rev, dofs = [], [], [], [], [], [], []
        acc = np.eye(4)
        for i in path:
            acc = acc @ _local_tf(model, i)
            jt, di = int(model.jtype[i]), int(model.dof_index[i])
            if jt == JOINT_FIXED or di < 0:
                continue
            a = model.axis[i].astype(np.float64)
            Kj = _skew4(a) if jt == JOINT_REVOLUTE else np.zeros((4, 4))
            Pj = np.zeros((4, 4))
            if jt != JOINT_REVOLUTE:
                Pj[:3, 3] = a
            C.append(acc)
            K.append(Kj)
            K2.append(Kj @ Kj)
            P.append(Pj)
            axes.append(a)
            rev.append(jt == JOINT_REVOLUTE)
            dofs.append(di)
            acc = np.eye(4)
        if not dofs:
            raise ValueError(f"no movable joint between the root and "
                             f"{ee_link!r}")
        f32 = dict(dtype=torch.float32, device=device)
        t = lambda v: torch.as_tensor(np.asarray(v), **f32)   # noqa: E731
        self.n = len(dofs)
        self.dofs = tuple(dofs)
        self.dof_index = torch.as_tensor(dofs, dtype=torch.long,
                                         device=device)
        self.C, self.K, self.K2 = t(C), t(K), t(K2)
        self.P = t(P) if not all(rev) else None
        self.axis = t(axes)[..., None]                        # (n, 3, 1)
        self.rev = t(rev)[:, None]                            # (n, 1)
        self.tail = t(acc)
        self.eye4 = torch.eye(4, **f32)
        self.eye6 = torch.eye(6, **f32)
        self.shepperd = t(_SHEPPERD).reshape(10, 16)
        self.qlimits = torch.as_tensor(model.qlimits, **f32)
        self.select = {}               # active dofs -> (ids, lo, hi, S)

    def active(self, active_dofs: Sequence[int]):
        """(ids, lower, upper, S) of ``active_dofs``: S (n, na) maps the
        chain's joints to them (None when they are the chain's dofs in
        order)."""
        key = tuple(int(d) for d in active_dofs)
        if key not in self.select:
            dev = self.C.device
            ids = torch.as_tensor(key, dtype=torch.long, device=dev)
            S = None
            if key != self.dofs:
                S = torch.zeros((self.n, len(key)), dtype=torch.float32,
                                device=dev)
                for j, d in enumerate(self.dofs):
                    if d in key:
                        S[j, key.index(d)] = 1.0
            self.select[key] = (ids, self.qlimits[ids, 0],
                                self.qlimits[ids, 1], S)
        return self.select[key]


def ik_chain(model: ArticulationModel, ee_link: str, device) -> _Chain:
    """The chain tables of (model, ee_link), built once per device and
    kept on the model, as ``model_tensors`` keeps its tables."""
    cache = model.__dict__.setdefault("_ik_chains", {})
    key = (ee_link, torch.device(device))
    if key not in cache:
        cache[key] = _Chain(model, ee_link, key[1])
    return cache[key]


def root_transform(root_pos, root_quat, batch, device):
    """(B, 4, 4) world pose of the root, identity where not given."""
    f32 = dict(dtype=torch.float32, device=device)
    if root_pos is None:
        root_pos = torch.zeros(batch + (3,), **f32)
    if root_quat is None:
        root_quat = torch.tensor([1.0, 0.0, 0.0, 0.0], **f32)
    return tf_from_pq(root_pos.expand(batch + (3,)),
                      root_quat.expand(batch + (4,)))


def chain_fk(chain: _Chain, qpos, T_root):
    """Forward kinematics along the chain: qpos (B, dof), T_root (B, 4, 4)
    -> (end effector (B, 4, 4), each movable joint's frame (B, n, 4, 4)).
    Joint j's origin is on its axis, so its frame's translation is o_j
    and its rotation times the axis is w_j."""
    qc = qpos[..., chain.dof_index][..., None, None]          # (B, n, 1, 1)
    M = chain.eye4 + torch.sin(qc) * chain.K + (1.0 - torch.cos(qc)) * chain.K2
    if chain.P is not None:
        M = M + qc * chain.P
    L = chain.C @ M
    T, frames = T_root, []
    for j in range(chain.n):
        T = T @ L[:, j]
        frames.append(T)
    return T @ chain.tail, torch.stack(frames, dim=1)


def _quat_of_matrix(chain: _Chain, R):
    """Unit wxyz quaternion with w >= 0 of rotation matrices (B, 3, 3):
    the four Shepperd candidates as one product, the one seeded by the
    largest of (trace, m00, m11, m22) taken, as
    ``core.maths.matrix_to_quat`` takes it."""
    x = Fn.pad(R.reshape(R.shape[0], 9), (1, 0), value=1.0)
    cands = (x @ chain.shepperd).reshape(-1, 4, 4)
    case = torch.diagonal(cands, dim1=-2, dim2=-1).argmax(dim=-1)
    q = torch.gather(cands, 1, case[:, None, None].expand(-1, 1, 4))[:, 0]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return torch.where(q[:, :1] < 0, -q, q)


def error_and_jacobian(chain: _Chain, T_ee, frames, p_t, R_t,
                       S: Optional[torch.Tensor] = None):
    """The pose error e (B, 6) of the end effector T_ee against the
    target (p_t (B, 3), R_t (B, 3, 3)) and its Jacobian (B, 6, na) with
    respect to the chain's joints (mapped to the active dofs by S)."""
    p, R = T_ee[:, :3, 3], T_ee[:, :3, :3]
    dq = _quat_of_matrix(chain, R_t @ R.transpose(-1, -2))
    w, v = dq[:, 0].clamp(-1.0, 1.0), dq[:, 1:]
    angle = 2.0 * torch.arccos(w)
    s = torch.sqrt((1.0 - w * w).clamp_min(1e-12))
    k = angle / s
    small = (angle < 1e-6)[:, None]
    rotvec = torch.where(small, 2.0 * v, v * k[:, None])
    e = torch.cat([p_t - p, rotvec], dim=-1)

    omega = (frames[..., :3, :3] @ chain.axis)[..., 0]       # (B, n, 3)
    o = frames[..., :3, 3]
    # position rows: e = p_t - p, so minus the geometric Jacobian
    lever = torch.linalg.cross(omega, p[:, None] - o, dim=-1)
    Jp = (lever * chain.rev + omega * (1.0 - chain.rev)
          if chain.P is not None else lever)
    # rotation rows: d dq = -0.5 dq (x) (0, w_j) through the rotvec map
    dw = 0.5 * (v[:, None] * omega).sum(-1, keepdim=True)    # (B, n, 1)
    dv = -0.5 * (w[:, None, None] * omega
                 + torch.linalg.cross(v[:, None].expand_as(omega), omega,
                                      dim=-1))
    dk = (-2.0 + angle * w / s) / (s * s)                    # d(angle/s)/dw
    Jr = torch.where(small[:, None], 2.0 * dv,
                     k[:, None, None] * dv + v[:, None] * (dk[:, None, None]
                                                           * dw))
    if chain.P is not None:
        Jr = Jr * chain.rev
    J = torch.cat([-Jp, Jr], dim=-1).transpose(-1, -2)        # (B, 6, n)
    if S is not None:
        J = J @ S
    return e, J


def dls_iterations(chain: _Chain, q_init, p_t, R_t, T_root, active_dofs,
                   iters: int, damping: float = 1e-3, step: float = 1.0,
                   first_fk=None):
    """``iters`` damped-least-squares steps from q_init (B, dof) towards
    (p_t, R_t), clipped to the active dofs' limits -> qpos (B, dof).
    ``first_fk`` is chain_fk of q_init where the caller already ran it."""
    ids, lo, hi, S = chain.active(active_dofs)
    eye = damping * chain.eye6
    q = q_init
    T_ee, frames = first_fk or chain_fk(chain, q, T_root)
    for it in range(iters):
        if it:
            T_ee, frames = chain_fk(chain, q, T_root)
        e, J = error_and_jacobian(chain, T_ee, frames, p_t, R_t, S)
        L = torch.linalg.cholesky_ex(J @ J.transpose(-1, -2) + eye).L
        y = torch.linalg.solve_triangular(L, e[..., None], upper=False)
        x = torch.linalg.solve_triangular(L.transpose(-1, -2), y,
                                          upper=True)
        # e measures the remaining displacement (J = -J_fk): descend -J^T x
        dq = -(J.transpose(-1, -2) @ x)[..., 0]
        qa = torch.clamp(q[..., ids] + step * dq, lo, hi)
        q = q.index_copy(-1, ids, qa)
    return q


def solve_ik(model: ArticulationModel, ee_link: str, target_pos,
             target_quat, q_init, active_dofs: Tuple[int, ...],
             root_pos=None, root_quat=None, iters: int = 64,
             damping: float = 1e-3, step: float = 1.0,
             pos_tol: float = 1e-4, rot_tol: float = 1e-3):
    """Damped least-squares IK on the selected dofs, batched over the
    leading axis of ``q_init`` (B, dof) and the targets (B, 3), (B, 4).

    Returns (qpos (B, dof), converged (B,) bool): converged from the
    error after the last step."""
    q_init = q_init.to(torch.float32)
    batch = q_init.shape[:-1]
    chain = ik_chain(model, ee_link, q_init.device)
    T_root = root_transform(root_pos, root_quat, batch, q_init.device)
    R_t = quat_to_matrix(quat_normalize(target_quat)).expand(batch + (3, 3))
    p_t = target_pos.expand(batch + (3,))
    q = dls_iterations(chain, q_init, p_t, R_t, T_root, active_dofs, iters,
                       damping, step)
    T_ee, frames = chain_fk(chain, q, T_root)
    e, _ = error_and_jacobian(chain, T_ee, frames, p_t, R_t)
    converged = ((torch.linalg.norm(e[:, :3], dim=-1) < pos_tol * 10)
                 & (torch.linalg.norm(e[:, 3:], dim=-1) < rot_tol * 10))
    return q, converged

