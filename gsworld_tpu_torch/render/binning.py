"""Tile binning: depth-ordered per-tile entry ranges via duplicate + sort
(port of the depth mode of gsworld_tpu/render/binning.py:bin_entries_fused).

Per frame:
  1. depth argsort of the Gaussians (culled ones carry depth = inf and
     sink to the end; the sort is stable, so equal depths rank by id);
  2. entry counts ``cnt = min(tile-rect area, D)`` on the pre-cull rect;
     the E budget keeps the longest prefix of the ranking whose inclusive
     count sum is <= E (farthest-first drop); that running sum, held at
     the kept total past the prefix, gives each rank its slots, so the
     slots follow the depth ranking;
  3. the emit kernel (csrc/emit.cu) writes one 32-bit key per slot,
     ``f * (T + 1) + tile``, and the Gaussian id; entries that the exact
     alpha cull drops get the sentinel tile T and keep their slots;
  4. one stable radix sort of the keys' low bits (csrc/sort_tiles.cu:
     ``bit_length(F * (T + 1) - 1)`` of them, 16 at 128 frames of 300
     tiles) groups entries per (frame, tile) and keeps slot order within
     a tile, which is depth order, ties by id;
  5. per-tile segment starts by ``torch.searchsorted``.

This is the order the sort of 64-bit keys ``(frame, tile) << 32 | depth
bits`` over slots in Gaussian order gave, bit for bit: valid depths lie
past the near plane, so above 0, where float order is bit order, and
equal keys kept slot order, which was id order.

``overflow`` counts entries lost to the D cap plus those lost to the E
budget.  All frames (envs x cameras) run batched.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gsworld_tpu_torch.render.camera import RasterConfig
from gsworld_tpu_torch.render.project import Projected
from gsworld_tpu_torch.render.rasterize_cuda import emit_entries, sort_tiles


class EntryBins(NamedTuple):
    gaussian: torch.Tensor  # (F, E) int32 Gaussian id per sorted entry
    starts: torch.Tensor    # (F, T+1) int32 per-tile segment starts
    overflow: torch.Tensor  # (F,) int64 entries dropped by the D / E caps
    # what a fixed-order sum per Gaussian needs (rasterize_cuda.
    # sum_entry_rows, through slot_runs): the slot layout and the key
    # sort's permutation
    ends: torch.Tensor      # (F, N) int32 inclusive slot ends in rank
    #                         order: rank r owns ends[r-1] .. ends[r]-1
    order: torch.Tensor     # (F, N) int32 Gaussian id of each depth rank
    perm: torch.Tensor      # (F, E) int32 sorted position -> f * E + slot


class EmitPlan(NamedTuple):
    """Everything before the emit kernel: its keyword arguments and the
    frame's overflow count (D-cap loss + E-budget loss)."""

    args: dict
    overflow: torch.Tensor  # (F,) int64


def _cumsum_rows(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int64 running sum along the last axis of the integers
    ``x`` (F, N), as one flat scan over all rows less each row's base.
    ``torch.cumsum`` scans a flat tensor at memory speed, but takes a slow
    kernel for the last axis of several rows (0.29-0.39 ms against
    0.011 ms for 8 x 222k on an NVIDIA H100 80GB HBM3, 700 W:
    tools/emit_times.py)."""
    F, N = x.shape
    if F == 1:
        return torch.cumsum(x, dim=-1, dtype=torch.int64)
    flat = torch.cumsum(x.reshape(-1), dim=0, dtype=torch.int64).view(F, N)
    return flat - torch.nn.functional.pad(flat[:-1, -1], (1, 0))[:, None]


def plan_emit(proj: Projected, cfg: RasterConfig) -> EmitPlan:
    """Pre-cull entry counts, the stable depth ranking and the E budget's
    slot ends in rank order of frame-batched projections (F, N)."""
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
    # a rank is kept while the running sum fits: a prefix of the ranking,
    # whose last sum is the total; the ranks past it end at the total
    fit = torch.searchsorted(csum, csum.new_full((len(csum), 1), E),
                             right=True)
    last = torch.gather(csum, 1, (fit - 1).clamp_min(0))
    total = torch.where(fit > 0, last, 0)                       # (F, 1)
    ends = torch.minimum(csum, total).to(torch.int32)
    args = dict(
        ends=ends, order=order.to(torch.int32), rect=rect,
        mean2d=proj.mean2d.contiguous(), conic=proj.conic.contiguous(),
        opacity=proj.opacity.contiguous(), E=E, gx=cfg.tiles_x,
        T=cfg.num_tiles, tile=cfg.tile, cull_alpha=cfg.cull_alpha)
    overflow = area.sum(dim=-1) - total[:, 0]
    return EmitPlan(args=args, overflow=overflow)


def slot_runs(ends: torch.Tensor, order: torch.Tensor):
    """Each Gaussian's run of slots from the rank-order slot ends ``ends``
    and the ranking ``order`` (F, N) int32 -> (first, end) (F, N) int32 in
    Gaussian order: Gaussian g owns slots first[g] .. end[g] - 1 (none
    when culled or dropped by the budget)."""
    first = torch.nn.functional.pad(ends[:, :-1], (1, 0))
    idx = order.long()
    return (torch.empty_like(first).scatter_(1, idx, first),
            torch.empty_like(ends).scatter_(1, idx, ends))


def sort_entries(keys: torch.Tensor, gid: torch.Tensor, T: int):
    """Sort the (F, E) emit keys; -> (sorted Gaussian ids (F, E), per-tile
    starts (F, T+1) int32, the sort's permutation (F, E) int32: sorted
    position -> f * E + slot, so ``gid.reshape(-1)[perm]`` is the sorted
    ids).  The keys lie below F * (T + 1), so the sort orders only the
    bits that can differ."""
    F, E = keys.shape
    dev = keys.device
    keys_s, perm = sort_tiles(keys, max((F * (T + 1) - 1).bit_length(), 1))
    gaussian = torch.index_select(gid.reshape(-1), 0, perm).view(F, E)
    bounds = torch.arange(F * (T + 1), device=dev, dtype=torch.int32)
    fE = torch.arange(F, device=dev, dtype=torch.int32)[:, None] * E
    starts = torch.searchsorted(keys_s, bounds, out_int32=True).view(
        F, T + 1) - fE
    return gaussian, starts, perm.view(F, E)


def bin_entries_fused(proj: Projected, cfg: RasterConfig) -> EntryBins:
    """Bin frame-batched projected Gaussians (F, N) into per-tile entry
    ranges."""
    plan = plan_emit(proj, cfg)
    keys, gid = emit_entries(**plan.args)
    gaussian, starts, perm = sort_entries(keys, gid, cfg.num_tiles)
    return EntryBins(gaussian=gaussian, starts=starts, overflow=plan.overflow,
                     ends=plan.args["ends"], order=plan.args["order"],
                     perm=perm)
