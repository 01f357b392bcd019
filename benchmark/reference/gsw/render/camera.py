"""Camera model, raster configuration and the ManiSkill -> GS camera
bridge (port of gsworld_tpu/render/camera.py).

GS camera convention (Inria ``scene.cameras.Camera``): ``world_view`` is
the rigid world->camera transform in the GS frame (+x right, +y down, +z
forward); the projection is symmetric, from FoVx/FoVy only (the
principal point of the real intrinsics is dropped, as the reference
does); the rasterizer culls at view depth 0.05.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from benchmark.reference.gsw.core.maths import tf_inverse_rigid

DEFAULT_ZNEAR = 0.01
DEFAULT_ZFAR = 100.0
GS_NEAR_CULL = 0.05


class GSCamera(NamedTuple):
    """Camera tensors; leading batch axes allowed (W/H live in
    RasterConfig)."""

    world_view: torch.Tensor  # (..., 4, 4) rigid world->cam (GS frame)
    cam_center: torch.Tensor  # (..., 3)
    tanfovx: torch.Tensor     # (...)
    tanfovy: torch.Tensor     # (...)


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Static rasterizer configuration.  Field names and defaults follow
    the JAX RasterConfig for the fields the port honours."""

    width: int = 640
    height: int = 480
    tile: int = 32
    max_tiles_per_gaussian: int = 64   # D: duplication cap in binning
    max_entries: int = 1 << 19         # E: per-frame (tile, Gaussian) budget
    sh_degree: int = 3
    znear_cull: float = GS_NEAR_CULL
    znear: float = DEFAULT_ZNEAR
    zfar: float = DEFAULT_ZFAR
    bg: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # exact per-tile alpha cull in the emit kernel (lossless)
    cull_alpha: bool = True

    @property
    def tiles_x(self) -> int:
        return -(-self.width // self.tile)

    @property
    def tiles_y(self) -> int:
        return -(-self.height // self.tile)

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y


def projection_matrix(tanfovx, tanfovy, znear=DEFAULT_ZNEAR,
                      zfar=DEFAULT_ZFAR):
    """Symmetric perspective matrix, z_sign=+1 (Inria convention)."""
    tanfovx = torch.as_tensor(tanfovx, dtype=torch.float32)
    tanfovy = torch.as_tensor(tanfovy, dtype=torch.float32)
    P = torch.zeros(tanfovx.shape + (4, 4), dtype=torch.float32,
                    device=tanfovx.device)
    P[..., 0, 0] = 1.0 / tanfovx
    P[..., 1, 1] = 1.0 / tanfovy
    P[..., 2, 2] = zfar / (zfar - znear)
    P[..., 2, 3] = -(zfar * znear) / (zfar - znear)
    P[..., 3, 2] = 1.0
    return P


def make_camera(world_view, tanfovx, tanfovy) -> GSCamera:
    world_view = torch.as_tensor(world_view, dtype=torch.float32)
    kw = dict(dtype=torch.float32, device=world_view.device)
    return GSCamera(
        world_view=world_view,
        cam_center=tf_inverse_rigid(world_view)[..., :3, 3],
        tanfovx=torch.as_tensor(tanfovx, **kw),
        tanfovy=torch.as_tensor(tanfovy, **kw))


def _homogeneous(ext):
    if ext.shape[-2] == 4:
        return ext
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=ext.dtype,
                          device=ext.device).expand(ext.shape[:-2] + (1, 4))
    return torch.cat([ext, bottom], dim=-2)


def camera_from_opencv(extrinsic_w2c, K, width: int, height: int
                       ) -> GSCamera:
    """GS camera from an OpenCV world->cam extrinsic + intrinsics (no
    sim->real remap); FoV from fx, fy only."""
    ext = _homogeneous(torch.as_tensor(extrinsic_w2c, dtype=torch.float32))
    K = torch.as_tensor(K, dtype=torch.float32, device=ext.device)
    return make_camera(ext, width / (2.0 * K[..., 0, 0]),
                       height / (2.0 * K[..., 1, 1]))


def cam_maniskill2gs(extrinsic_cv, K, width: int, height: int,
                     rigid_sim2real, scale_sim2real) -> GSCamera:
    """Bridge a sim camera (OpenCV extrinsic in the sim world frame) into
    the GS frame: cam2world, scale the position by the sim->real scale,
    apply the rigid sim->real alignment, invert.  Broadcasts over leading
    axes of ``extrinsic_cv``."""
    ext = _homogeneous(torch.as_tensor(extrinsic_cv, dtype=torch.float32))
    kw = dict(dtype=torch.float32, device=ext.device)
    sim_cam2world = tf_inverse_rigid(ext)
    scale = torch.ones(4, 4, **kw)
    scale[:3, 3] = float(scale_sim2real)
    real_world2cam = tf_inverse_rigid(
        torch.as_tensor(rigid_sim2real, **kw) @ (sim_cam2world * scale))
    K = torch.as_tensor(K, **kw)
    return make_camera(real_world2cam, width / (2.0 * K[..., 0, 0]),
                       height / (2.0 * K[..., 1, 1]))
