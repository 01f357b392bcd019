"""Tile binning: depth-ordered per-tile entry ranges via duplicate + sort
(port of the depth mode of gsworld_tpu/render/binning.py:bin_entries_fused).

Per frame:
  1. depth argsort of the Gaussians (culled ones carry depth = inf and
     sink to the end; the sort is stable, so equal depths rank by id);
  2. entry counts ``cnt = min(tile-rect area, D)`` on the pre-cull rect;
     the E budget keeps the longest depth-ordered prefix whose inclusive
     count sum is <= E (farthest-first drop); the kept flag goes back to
     Gaussian order, where the inclusive running sum of the kept counts
     gives each Gaussian its slots;
  3. the emit kernel (csrc/emit.cu) writes one 64-bit key per slot,
     ``(frame, tile) << 32 | depth bits``, and the Gaussian id; entries
     that the exact alpha cull drops get the sentinel tile T and keep
     their slots;
  4. one radix sort of the keys (``torch.sort``) groups entries per
     (frame, tile) in depth order;
  5. per-tile segment starts by ``torch.searchsorted``.

The slots' order only decides which Gaussians the budget keeps, and that
is settled in step 2: depth order within a tile comes from the key sort,
and entries with equal keys (equal depth in one tile) keep slot order,
which is id order whether slots follow the stable depth ranking or the
ids themselves.  Gaussian order lets the kernel stream its inputs.

``overflow`` counts entries lost to the D cap plus those lost to the E
budget.  All frames (envs x cameras) run batched.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.gsw.render.camera import RasterConfig
from benchmark.reference.gsw.render.project import Projected
from benchmark.reference.gsw.render.rasterize_cuda import emit_entries


class EntryBins(NamedTuple):
    gaussian: torch.Tensor  # (F, E) int32 Gaussian id per sorted entry
    starts: torch.Tensor    # (F, T+1) int32 per-tile segment starts
    overflow: torch.Tensor  # (F,) int64 entries dropped by the D / E caps
    # what a fixed-order sum per Gaussian needs (rasterize_cuda.
    # sum_entry_rows): the slot layout and the key sort's permutation
    ends: torch.Tensor      # (F, N) int32 inclusive slot ends in Gaussian
    #                         order: Gaussian g owns ends[g-1] .. ends[g]-1
    perm: torch.Tensor      # (F, E) int64 sorted position -> f * E + slot


class EmitPlan(NamedTuple):
    """Everything before the emit kernel: its keyword arguments and the
    frame's overflow count (D-cap loss + E-budget loss)."""

    args: dict
    overflow: torch.Tensor  # (F,) int64


def _cumsum_rows(x: torch.Tensor, dtype=torch.int64) -> torch.Tensor:
    """Inclusive running sum along the last axis of the integers ``x``
    (F, N), as one flat scan over all rows less each row's base.
    ``torch.cumsum`` scans a flat tensor at memory speed, but takes a slow
    kernel for the last axis of several rows (0.29-0.39 ms against
    0.011 ms for 8 x 222k on an NVIDIA H100 80GB HBM3, 700 W:
    tools/emit_times.py)."""
    F, N = x.shape
    if F == 1:
        return torch.cumsum(x, dim=-1, dtype=dtype)
    flat = torch.cumsum(x.reshape(-1), dim=0).view(F, N)           # int64
    base = torch.nn.functional.pad(flat[:-1, -1], (1, 0))
    return torch.sub(flat, base[:, None],
                     out=torch.empty((F, N), dtype=dtype, device=x.device))


def plan_emit(proj: Projected, cfg: RasterConfig) -> EmitPlan:
    """Pre-cull entry counts, the E budget in depth order and the slot
    ends in Gaussian order of frame-batched projections (F, N)."""
    D = cfg.max_tiles_per_gaussian
    E = cfg.max_entries
    valid = (proj.radius > 0) & torch.isfinite(proj.depth)
    rect = proj.rect.to(torch.int32).contiguous()
    area = ((rect[..., 2] - rect[..., 0]) * (rect[..., 3] - rect[..., 1])
            ).clamp_min(0)
    area = torch.where(valid, area, torch.zeros_like(area))
    cnt = area.clamp_max(D)

    order = torch.sort(torch.where(valid, proj.depth, torch.full_like(
        proj.depth, float("inf"))), dim=-1, stable=True).indices
    csum = _cumsum_rows(torch.gather(cnt, 1, order))
    # a rank is kept while the running sum fits: a prefix of the ranking
    kept = torch.empty_like(valid).scatter_(1, order, csum <= E)
    ends = _cumsum_rows(cnt * kept, torch.int32)
    args = dict(
        ends=ends, rect=rect, mean2d=proj.mean2d.contiguous(),
        conic=proj.conic.contiguous(), opacity=proj.opacity.contiguous(),
        depth=proj.depth.contiguous(), E=E, gx=cfg.tiles_x, T=cfg.num_tiles,
        tile=cfg.tile, cull_alpha=cfg.cull_alpha)
    overflow = area.sum(dim=-1) - ends[:, -1]
    return EmitPlan(args=args, overflow=overflow)


def sort_entries(keys: torch.Tensor, gid: torch.Tensor, T: int):
    """Radix-sort the (F, E) emit keys; -> (sorted Gaussian ids (F, E),
    per-tile starts (F, T+1) int32, the sort's permutation (F, E) int64:
    sorted position -> f * E + slot, so ``gid.reshape(-1)[perm]`` is the
    sorted ids)."""
    F, E = keys.shape
    dev = keys.device
    keys_s, perm = torch.sort(keys.reshape(-1), stable=True)
    gaussian = gid.reshape(-1)[perm].reshape(F, E)
    fr = torch.arange(F, device=dev, dtype=torch.int64)
    bounds = (fr[:, None] * (T + 1)
              + torch.arange(T + 1, device=dev, dtype=torch.int64)) << 32
    starts = (torch.searchsorted(keys_s, bounds.reshape(-1)).reshape(F, T + 1)
              - fr[:, None] * E).to(torch.int32)
    return gaussian, starts, perm.reshape(F, E)


def bin_entries_fused(proj: Projected, cfg: RasterConfig) -> EntryBins:
    """Bin frame-batched projected Gaussians (F, N) into per-tile entry
    ranges."""
    plan = plan_emit(proj, cfg)
    keys, gid = emit_entries(**plan.args)
    gaussian, starts, perm = sort_entries(keys, gid, cfg.num_tiles)
    return EntryBins(gaussian=gaussian, starts=starts, overflow=plan.overflow,
                     ends=plan.args["ends"], perm=perm)
