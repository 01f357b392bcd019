"""Gaussian projection: world -> screen 2D statistics, the EWA splatting
preprocess (port of gsworld_tpu/render/project.py).

View transform, perspective projection, EWA 2D covariance with the 0.3
dilation, conic, opacity-aware radius, tile rect with the centered D-cap,
SH colour, near-plane cull at ``cfg.znear_cull``.  Written in scalar
components; leading batch axes of the Gaussians and the camera broadcast
(e.g. Gaussians (B, 1, N) against cameras (B, C)).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.gsw.core.maths import quat_normalize
from benchmark.reference.gsw.gs.transform import PosedGaussians
from benchmark.reference.gsw.render.camera import GSCamera, RasterConfig
from benchmark.reference.gsw.render.sh import eval_sh


class Projected(NamedTuple):
    mean2d: torch.Tensor   # (..., N, 2) pixel coords
    depth: torch.Tensor    # (..., N) view z; inf where culled
    conic: torch.Tensor    # (..., N, 3) inverse 2D covariance (A, B, C)
    color: torch.Tensor    # (..., N, 3) SH colour
    opacity: torch.Tensor  # (..., N) sigmoid(logit)
    radius: torch.Tensor   # (..., N) int32 pixel radius (0 = culled)
    rect: torch.Tensor     # (..., N, 4) int32 tile rect (x0, y0, x1, y1), exclusive


def project_gaussians(g: PosedGaussians, cam: GSCamera, cfg: RasterConfig,
                      sh0, shN) -> Projected:
    """Project world-space Gaussians through camera(s).  ``sh0`` (N, 3) and
    ``shN`` (N, 45) are the scene's static SH tables."""
    W2C = cam.world_view
    r = [[W2C[..., i, j, None] for j in range(3)] for i in range(3)]
    tv = [W2C[..., i, 3, None] for i in range(3)]
    mx, my, mz = g.means.unbind(-1)
    px = r[0][0] * mx + r[0][1] * my + r[0][2] * mz + tv[0]
    py = r[1][0] * mx + r[1][1] * my + r[1][2] * mz + tv[1]
    pz = r[2][0] * mx + r[2][1] * my + r[2][2] * mz + tv[2]
    depth = pz
    valid = depth > cfg.znear_cull
    # A culled Gaussian's projection is never used, but near the camera
    # plane (depth ~ 0) its 1/z terms overflow, and in the backward its
    # zero gradient times an infinite local derivative is NaN, which Adam
    # writes into the Gaussian.  It is computed at depth 1 instead (the
    # JAX package divides by the depth itself).
    pz = torch.where(valid, pz, torch.ones_like(pz))

    tanfovx = cam.tanfovx[..., None]
    tanfovy = cam.tanfovy[..., None]
    inv_w = 1.0 / (pz + 1e-7)
    ndc_x = (px / tanfovx) * inv_w
    ndc_y = (py / tanfovy) * inv_w
    mean2d = torch.stack([((ndc_x + 1.0) * cfg.width - 1.0) * 0.5,
                          ((ndc_y + 1.0) * cfg.height - 1.0) * 0.5], dim=-1)

    # 3D covariance Sigma = R diag(s^2) R^T
    qw, qx, qy, qz = quat_normalize(g.quats).unbind(-1)
    R00 = 1 - 2 * (qy * qy + qz * qz)
    R01 = 2 * (qx * qy - qw * qz)
    R02 = 2 * (qx * qz + qw * qy)
    R10 = 2 * (qx * qy + qw * qz)
    R11 = 1 - 2 * (qx * qx + qz * qz)
    R12 = 2 * (qy * qz - qw * qx)
    R20 = 2 * (qx * qz - qw * qy)
    R21 = 2 * (qy * qz + qw * qx)
    R22 = 1 - 2 * (qx * qx + qy * qy)
    s0, s1, s2 = torch.exp(2.0 * g.log_scales).unbind(-1)
    S00 = R00 * R00 * s0 + R01 * R01 * s1 + R02 * R02 * s2
    S11 = R10 * R10 * s0 + R11 * R11 * s1 + R12 * R12 * s2
    S22 = R20 * R20 * s0 + R21 * R21 * s1 + R22 * R22 * s2
    S01 = R00 * R10 * s0 + R01 * R11 * s1 + R02 * R12 * s2
    S02 = R00 * R20 * s0 + R01 * R21 * s1 + R02 * R22 * s2
    S12 = R10 * R20 * s0 + R11 * R21 * s1 + R12 * R22 * s2

    # EWA: T = J Rv rows, cov2d = T Sigma T^T
    focal_x = cfg.width / (2.0 * tanfovx)
    focal_y = cfg.height / (2.0 * tanfovy)
    tz = pz
    limx = 1.3 * tanfovx
    limy = 1.3 * tanfovy
    tx = torch.minimum(torch.maximum(px / tz, -limx), limx) * tz
    ty = torch.minimum(torch.maximum(py / tz, -limy), limy) * tz
    inv_z = 1.0 / tz
    j00 = focal_x * inv_z
    j02 = -(focal_x * tx) * inv_z * inv_z
    j11 = focal_y * inv_z
    j12 = -(focal_y * ty) * inv_z * inv_z
    t0x = j00 * r[0][0] + j02 * r[2][0]
    t0y = j00 * r[0][1] + j02 * r[2][1]
    t0z = j00 * r[0][2] + j02 * r[2][2]
    t1x = j11 * r[1][0] + j12 * r[2][0]
    t1y = j11 * r[1][1] + j12 * r[2][1]
    t1z = j11 * r[1][2] + j12 * r[2][2]

    def quad(ax, ay, az, bx, by, bz):
        return (ax * (S00 * bx + S01 * by + S02 * bz)
                + ay * (S01 * bx + S11 * by + S12 * bz)
                + az * (S02 * bx + S12 * by + S22 * bz))

    c00 = quad(t0x, t0y, t0z, t0x, t0y, t0z) + 0.3
    c11 = quad(t1x, t1y, t1z, t1x, t1y, t1z) + 0.3
    c01 = quad(t0x, t0y, t0z, t1x, t1y, t1z)
    det = c00 * c11 - c01 * c01
    valid = valid & (det != 0.0)
    det_safe = torch.where(det == 0.0, torch.ones_like(det), det)
    conic = torch.stack([c11, -c01, c00], dim=-1) / det_safe[..., None]

    opacity = 1.0 / (1.0 + torch.exp(-g.logit_opacities))
    opacity = opacity.expand(depth.shape)

    # opacity-aware radius: alpha = opac exp(-r^2 / 2 sigma^2) falls below
    # 1/255 beyond sigma sqrt(2 ln(255 opac)); capped at 3 sigma
    mid = 0.5 * (c00 + c11)
    lam1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    r2 = 2.0 * torch.log(torch.clamp_min(255.0 * opacity, 1e-6))
    valid = valid & (r2 > 0.0)
    rscale = torch.sqrt(torch.clamp(r2, 0.0, 9.0))
    radius = torch.ceil(rscale * torch.sqrt(lam1)).to(torch.int32)

    # tile rect: [min, max) clamped to the grid
    t = cfg.tile
    gx, gy = cfg.tiles_x, cfg.tiles_y
    rf = radius.to(torch.float32)
    m2x, m2y = mean2d.unbind(-1)

    def tile_floor(v, hi):
        return torch.clamp(torch.floor(v / t), 0, hi).to(torch.int32)

    x0 = tile_floor(m2x - rf, gx)
    y0 = tile_floor(m2y - rf, gy)
    x1 = tile_floor(m2x + rf + t - 1, gx)
    y1 = tile_floor(m2y + rf + t - 1, gy)

    # centered D-cap: a rect larger than D tiles shrinks to a <= D-tile
    # window centered on the splat mean
    D = cfg.max_tiles_per_gaussian
    w_t = x1 - x0
    h_t = y1 - y0
    area = w_t * h_t
    over = area > D
    s = torch.sqrt(D / area.clamp_min(1).to(torch.float32))
    w2 = torch.floor(w_t * s).clamp_min(1).to(torch.int32)
    h2 = torch.minimum((D // w2.clamp_min(1)).clamp_min(1), h_t)
    w2 = torch.minimum(D // h2.clamp_min(1), w_t)
    cx = torch.minimum(torch.maximum((m2x / t).to(torch.int32), x0), x1 - 1)
    cy = torch.minimum(torch.maximum((m2y / t).to(torch.int32), y0), y1 - 1)
    x0n = torch.minimum(torch.maximum(cx - (w2 - 1) // 2, x0), x1 - w2)
    y0n = torch.minimum(torch.maximum(cy - (h2 - 1) // 2, y0), y1 - h2)
    x0 = torch.where(over, x0n, x0)
    y0 = torch.where(over, y0n, y0)
    x1 = torch.where(over, x0n + w2, x1)
    y1 = torch.where(over, y0n + h2, y1)
    valid = valid & ((x1 - x0) * (y1 - y0) > 0)
    radius = torch.where(valid, radius, torch.zeros_like(radius))
    rect = torch.stack([x0, y0, x1, y1], dim=-1)
    rect = torch.where(valid[..., None], rect, torch.zeros_like(rect))

    dirs = g.means - cam.cam_center[..., None, :]
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True).clamp_min(
        1e-12)
    color = eval_sh(sh0, shN, dirs, cfg.sh_degree)

    depth = torch.where(valid, depth, torch.full_like(depth, float("inf")))
    return Projected(mean2d=mean2d, depth=depth, conic=conic, color=color,
                     opacity=opacity, radius=radius, rect=rect)
