"""Quaternion / rotation / SE(3) math (port of gsworld_tpu/core/maths.py).

Conventions as in the JAX package: quaternions are wxyz, 4x4 transforms
act on column vectors, every function broadcasts over leading axes.
Float32 products here run in full f32 on the card
(``torch.backends.cuda.matmul.allow_tf32`` is False by default).
"""

from __future__ import annotations

import torch


def quat_normalize(q, eps: float = 1e-12):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(eps)


def quat_multiply(a, b):
    """Hamilton product of wxyz quaternions."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_conjugate(q):
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quat_inverse(q, eps: float = 1e-12):
    """Inverse of wxyz quaternions of any norm: conjugate / |q|^2."""
    return quat_conjugate(q) / (q * q).sum(-1, keepdim=True).clamp_min(eps)


def quat_rotate(q, v):
    """Rotate vectors v (..., 3) by unit quaternions q (..., 4)."""
    qw = q[..., :1]
    qv = q[..., 1:]
    qv, v = torch.broadcast_tensors(qv, v)
    t = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v + qw * t + torch.linalg.cross(qv, t, dim=-1)


def quat_to_matrix(q):
    """Unit wxyz quaternion (..., 4) -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m):
    """Rotation matrix (..., 3, 3) -> unit wxyz quaternion, w >= 0.

    Shepperd-style: of the four candidate quadruples, the one seeded by
    the largest of (trace, m00, m11, m22)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    cands = torch.stack([
        torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1),
        torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10,
                     m02 + m20], dim=-1),
        torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22,
                     m12 + m21], dim=-1),
        torch.stack([m10 - m01, m02 + m20, m12 + m21,
                     1.0 - m00 - m11 + m22], dim=-1),
    ], dim=-1)                                  # (..., 4 comps, 4 cases)
    case = torch.stack([tr, m00, m11, m22], dim=-1).argmax(dim=-1)
    idx = case[..., None, None].expand(case.shape + (4, 1))
    q = quat_normalize(torch.gather(cands, -1, idx)[..., 0])
    return torch.where(q[..., :1] < 0, -q, q)


def axis_angle_to_quat(axis_angle):
    """Axis-angle (..., 3) -> wxyz quaternion; sqrt(max(sq, tiny)) keeps
    the gradient finite at zero angle."""
    sq = torch.sum(axis_angle * axis_angle, dim=-1, keepdim=True)
    angle = torch.sqrt(sq.clamp_min(1e-24))
    half = 0.5 * angle
    k = torch.where(angle < 1e-8, 0.5 - angle * angle / 48.0,
                    torch.sin(half) / angle.clamp_min(1e-30))
    return torch.cat([torch.cos(half), axis_angle * k], dim=-1)


def quat_compose_preserving_norm(q_rot, q):
    """quat_multiply(q_rot, q / |q|) * |q| (possibly unnormalized q)."""
    norm = torch.linalg.norm(q, dim=-1, keepdim=True)
    return quat_multiply(q_rot, q / norm.clamp_min(1e-12)) * norm


def make_tf(R, t):
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros(batch + (1, 4), dtype=top.dtype, device=top.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def tf_from_pq(p, q):
    """Position (..., 3) + wxyz quat (..., 4) -> (..., 4, 4)."""
    return make_tf(quat_to_matrix(q), p)


def tf_inverse_rigid(T):
    """Inverse of a rigid 4x4 (rotation + translation only)."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return make_tf(Rt, -(Rt @ T[..., :3, 3:4])[..., 0])


def tf_apply(T, p):
    """Apply 4x4 transforms (..., 4, 4) to points (..., 3)."""
    return (T[..., :3, :3] @ p[..., :, None])[..., 0] + T[..., :3, 3]


def pose_multiply(p1, q1, p2, q2):
    """Compose (p, q_wxyz) poses: pose1 o pose2."""
    return p1 + quat_rotate(q1, p2), quat_multiply(q1, q2)


def pose_inverse(p, q):
    """Inverse of a (p, unit q_wxyz) pose."""
    qi = quat_conjugate(q)
    return -quat_rotate(qi, p), qi


def extract_rigid_transform(M):
    """Uniformly scaled rigid 4x4 (..., 4, 4) -> (rigid 4x4, scale, R, t)
    by the polar decomposition of the 3x3 block: SVD A = U S Vh, scale =
    mean singular value, R = U Vh, translation as it is."""
    A = M[..., :3, :3]
    t = M[..., :3, 3]
    U, S, Vh = torch.linalg.svd(A)
    R = U @ Vh
    return make_tf(R, t), S.mean(-1), R, t


def extract_rigid_transform_fast(M):
    """Uniform-scaled rotation 4x4 -> (rigid 4x4, scale, R, t): scale =
    det(A)^(1/3), R = A / scale refined by two Newton orthogonalisation
    steps R <- 1.5 R - 0.5 R R^T R."""
    A = M[..., :3, :3]
    t = M[..., :3, 3]
    det = torch.linalg.det(A)
    scale = torch.sign(det) * det.abs().pow(1.0 / 3.0)
    R = A / scale[..., None, None]
    for _ in range(2):
        R = 1.5 * R - 0.5 * (R @ R.transpose(-1, -2) @ R)
    return make_tf(R, t), scale, R, t


def euler2mat(x, y, z):
    """Intrinsic XYZ euler angles (scalar tensors) -> rotation matrix
    Rz @ Ry @ Rx."""
    x, y, z = (torch.as_tensor(v, dtype=torch.float32) for v in (x, y, z))
    cx, sx = torch.cos(x), torch.sin(x)
    cy, sy = torch.cos(y), torch.sin(y)
    cz, sz = torch.cos(z), torch.sin(z)
    one, zero = torch.ones_like(cx), torch.zeros_like(cx)
    Rx = torch.stack([one, zero, zero, zero, cx, -sx, zero, sx, cx]
                     ).reshape(3, 3)
    Ry = torch.stack([cy, zero, sy, zero, one, zero, -sy, zero, cy]
                     ).reshape(3, 3)
    Rz = torch.stack([cz, -sz, zero, sz, cz, zero, zero, zero, one]
                     ).reshape(3, 3)
    return Rz @ Ry @ Rx


def matrix_to_euler_xyz(R):
    """Rotation matrix (..., 3, 3) -> XYZ euler angles (a, b, c) with
    R = Rx(a) @ Ry(b) @ Rz(c) (the pour check's tilt convention)."""
    b = torch.arcsin(R[..., 0, 2].clamp(-1.0, 1.0))
    a = torch.atan2(-R[..., 1, 2], R[..., 2, 2])
    c = torch.atan2(-R[..., 0, 1], R[..., 0, 0])
    return torch.stack([a, b, c], dim=-1)


def quat_angle_between(q1, q2):
    """Angle between two orientations in degrees, from |w| of their
    relative rotation."""
    q1 = quat_normalize(q1)
    q2 = quat_normalize(q2)
    w = torch.sum(q1 * q2, dim=-1).abs()
    return torch.rad2deg(2.0 * torch.arccos(w.clamp(0.0, 1.0)))


def inverse_sigmoid(x):
    """log(x / (1 - x)): the reference's scale/opacity logit transform."""
    return torch.log(x / (1.0 - x))


def compute_angle_between(a, b, eps: float = 1e-8):
    """Angle in radians between batched vectors (..., 3)."""
    na = torch.linalg.norm(a, dim=-1)
    nb = torch.linalg.norm(b, dim=-1)
    cos = torch.sum(a * b, dim=-1) / (na * nb).clamp_min(eps)
    return torch.arccos(cos.clamp(-1.0, 1.0))
