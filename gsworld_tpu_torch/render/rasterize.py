"""Render dispatch: project -> bin -> composite (port of
gsworld_tpu/render/rasterize.py:render, the segment-compositor path, and of
its differentiable branch ``_composite_pallas_diff``).

Leading axes of the Gaussians and cameras broadcast and are flattened
into one frame axis, so every frame (envs x cameras) goes through one
emit launch, one sort and one compositor launch.

Without semantics the render is differentiable with respect to the
projected floats through :class:`CompositeFunction` (forward: the
compositor, which also returns the sorted entries' records; backward: the
backward kernel on those records, then a sum per Gaussian in slot order,
so the backward repeats itself bit for bit).
Binning is integer plumbing and runs on detached tensors, as the JAX
package's ``stop_gradient`` does; the segmentation path is not
differentiable.
"""

from __future__ import annotations

import torch

from gsworld_tpu_torch.gs.transform import PosedGaussians
from gsworld_tpu_torch.render.binning import (EntryBins, bin_entries_fused,
                                              slot_runs)
from gsworld_tpu_torch.render.camera import GSCamera, RasterConfig
from gsworld_tpu_torch.render.project import Projected, project_frames
from gsworld_tpu_torch.render.rasterize_cuda import (
    composite_bwd,
    composite_tiles,
    sum_entry_rows,
)


class CompositeFunction(torch.autograd.Function):
    """Differentiable compositor over frame-batched floats (F, N, ...).

    ``apply(mean2d, conic, opacity, color, bins, cfg)`` -> (img (F, H, W,
    3), T (F, H, W)), ``bins`` the frames' ``EntryBins``.  The backward
    returns per-frame gradients shaped like the inputs; autograd sums
    frames that share a scene."""

    @staticmethod
    def forward(ctx, mean2d, conic, opacity, color, bins: EntryBins,
                cfg: RasterConfig):
        img, T_img, _, records = composite_tiles(
            bins.starts, bins.gaussian, mean2d, conic, opacity, color, None,
            width=cfg.width, height=cfg.height, tile=cfg.tile, bg=cfg.bg)
        ctx.cfg = cfg
        ctx.save_for_backward(mean2d, conic, opacity, color, bins.starts,
                              bins.gaussian, bins.ends, bins.order,
                              bins.perm, img, T_img, records)
        return img, T_img

    @staticmethod
    def backward(ctx, img_ct, T_ct):
        (mean2d, conic, opacity, color, starts, gaussian, ends, order, perm,
         img, T_img, records) = ctx.saved_tensors
        cfg = ctx.cfg
        rows = composite_bwd(
            starts, gaussian, mean2d, conic, opacity, color, img, T_img,
            img_ct.contiguous(), T_ct.contiguous(), width=cfg.width,
            height=cfg.height, tile=cfg.tile, records=records)
        acc = sum_entry_rows(rows, perm, *slot_runs(ends, order))
        return (acc[..., 0:2], acc[..., 2:5], acc[..., 8], acc[..., 5:8],
                None, None)


def bin_detached(flat: Projected, cfg: RasterConfig) -> EntryBins:
    """Bin frame-batched projections outside the autograd graph."""
    with torch.no_grad():
        return bin_entries_fused(Projected(*(x.detach() for x in flat)), cfg)


def render_projected(flat: Projected, cfg: RasterConfig, semantics=None):
    """Bin and composite frame-batched projections (F, N, ...) ->
    (img (F, H, W, 3), T (F, H, W), seg (F, H, W) or None, bins)."""
    bins = bin_detached(flat, cfg)
    if semantics is None:
        img, T_img = CompositeFunction.apply(
            flat.mean2d, flat.conic, flat.opacity, flat.color, bins,
            cfg)
        return img, T_img, None, bins
    with torch.no_grad():
        img, T_img, seg, _ = composite_tiles(
            bins.starts, bins.gaussian, flat.mean2d, flat.conic,
            flat.opacity, flat.color,
            semantics.to(torch.int32).contiguous(),
            width=cfg.width, height=cfg.height, tile=cfg.tile, bg=cfg.bg)
    return img, T_img, seg, bins


def render(g: PosedGaussians, cam: GSCamera, cfg: RasterConfig, sh0, shN,
           semantics=None, color_tint=None):
    """Forward render -> dict with ``rgb`` (..., H, W, 3) in [0, 1],
    ``T`` (..., H, W) final transmittance, ``seg`` (..., H, W) int32 (when
    ``semantics`` (N,) is given, else None) and ``overflow`` (...).
    ``rgb`` and ``T`` are differentiable when ``semantics`` is None.

    ``color_tint`` (per frame and Gaussian, broadcast to (..., N, 3), e.g.
    (B, 1, N, 3) for B envs x C cameras) multiplies the projected colours
    before binning: the per-object colour randomization.  The compositor
    reads the tinted colours as it reads any."""
    flat, lead = project_frames(g, cam, cfg, sh0, shN, color_tint)
    img, T_img, seg, bins = render_projected(flat, cfg, semantics)
    hw = (cfg.height, cfg.width)
    return dict(rgb=img.reshape(lead + hw + (3,)), T=T_img.reshape(lead + hw),
                seg=seg.reshape(lead + hw) if seg is not None else None,
                overflow=bins.overflow.reshape(lead))


def render_uint8(g: PosedGaussians, cam: GSCamera, cfg: RasterConfig, sh0,
                 shN):
    """Render to uint8 (..., H, W, 3): ``clip(rgb * 255, 0, 255)``
    truncated, the wrapper's image contract."""
    rgb = render(g, cam, cfg, sh0, shN)["rgb"]
    return torch.clamp(rgb * 255.0, 0, 255).to(torch.uint8)
