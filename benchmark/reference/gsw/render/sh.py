"""Spherical-harmonics colour, degree <= 3 (port of
gsworld_tpu/render/sh.py).  Output is ``max(SH(dir) + 0.5, 0)``."""

from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)
_N_ACTIVE = {0: 0, 1: 3, 2: 8, 3: 15}


def sh_basis(dirs, degree: int = 3):
    """(..., 15) SH basis values (degrees 1..3) for unit directions."""
    x, y, z = dirs.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    b = [
        -C1 * y, C1 * z, -C1 * x,
        C2[0] * xy, C2[1] * yz, C2[2] * (2.0 * zz - xx - yy),
        C2[3] * xz, C2[4] * (xx - yy),
        C3[0] * y * (3.0 * xx - yy), C3[1] * xy * z,
        C3[2] * y * (4.0 * zz - xx - yy),
        C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
        C3[4] * x * (4.0 * zz - xx - yy),
        C3[5] * z * (xx - yy), C3[6] * x * (xx - 3.0 * yy),
    ]
    n = _N_ACTIVE[degree]
    zero = torch.zeros_like(x)
    return torch.stack(b[:n] + [zero] * (15 - n), dim=-1)


def eval_sh(sh0, shN, dirs, degree: int = 3):
    """sh0 (N, 3), shN (N, 45) channel-major, dirs (..., N, 3) unit view
    directions -> (..., N, 3) RGB clamped to >= 0."""
    result = C0 * sh0
    if degree >= 1:
        sh = shN.reshape(shN.shape[:-1] + (3, 15))
        basis = sh_basis(dirs, degree)                     # (..., N, 15)
        result = result + torch.sum(basis[..., None, :] * sh, dim=-1)
    return torch.clamp_min(result + 0.5, 0.0)
