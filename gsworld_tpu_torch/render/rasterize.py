"""Render dispatch: project -> bin -> composite (port of
gsworld_tpu/render/rasterize.py:render, the segment-compositor path).

Leading axes of the Gaussians and cameras broadcast and are flattened
into one frame axis, so every frame (envs x cameras) goes through one
emit launch, one sort and one compositor launch.  The stages are marked
with ``record_function`` ranges (``gsw.*``) that torch.profiler reads; they
cost nothing when no profiler runs.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from gsworld_tpu_torch.gs.transform import PosedGaussians
from gsworld_tpu_torch.render.binning import bin_entries_fused
from gsworld_tpu_torch.render.camera import GSCamera, RasterConfig
from gsworld_tpu_torch.render.project import Projected, project_gaussians
from gsworld_tpu_torch.render.rasterize_cuda import composite_tiles


def project_frames(g: PosedGaussians, cam: GSCamera, cfg: RasterConfig, sh0,
                   shN):
    """Project, then flatten the broadcast leading axes into one frame
    axis -> (contiguous Projected (F, N, ...), leading shape)."""
    proj = project_gaussians(g, cam, cfg, sh0, shN)
    lead = proj.depth.shape[:-1]
    return Projected(*(x.reshape((-1,) + x.shape[len(lead):]).contiguous()
                       for x in proj)), lead


def render(g: PosedGaussians, cam: GSCamera, cfg: RasterConfig, sh0, shN,
           semantics=None):
    """Forward render -> dict with ``rgb`` (..., H, W, 3) in [0, 1],
    ``T`` (..., H, W) final transmittance, ``seg`` (..., H, W) int32 (when
    ``semantics`` (N,) is given, else None) and ``overflow`` (...)."""
    with record_function("gsw.project"):
        flat, lead = project_frames(g, cam, cfg, sh0, shN)
    with record_function("gsw.bin"):
        bins = bin_entries_fused(flat, cfg)
    with record_function("gsw.composite"):
        sem = (semantics.to(torch.int32).contiguous()
               if semantics is not None else None)
        img, T_img, seg = composite_tiles(
            bins.starts, bins.gaussian, flat.mean2d, flat.conic,
            flat.opacity, flat.color, sem,
            width=cfg.width, height=cfg.height, tile=cfg.tile, bg=cfg.bg)
    hw = (cfg.height, cfg.width)
    return dict(rgb=img.reshape(lead + hw + (3,)), T=T_img.reshape(lead + hw),
                seg=seg.reshape(lead + hw) if seg is not None else None,
                overflow=bins.overflow.reshape(lead))
