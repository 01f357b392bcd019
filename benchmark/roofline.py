"""The yardstick of the roofline shares: the published H100 peaks, the
least time of a piece of work, and the compositors' work counted from
their inputs.

The work is counted by the benchmark's own plain walk (the reference's
projection, binning under the configuration's caps tile, D and E, and
front-to-back walk), never from a kernel's launch shapes or capacity
buffers: the same inputs give the same work whatever implements it.

Rates: one H100 SXM at its 700 W limit (NVIDIA's data sheet): f32 lane
instructions (67 TFLOP/s counts an FMA as two), MUFU operations (exp,
reciprocal: 16 per SM and clock) and HBM bytes, per second.  A card set
below 700 W runs slower than these; the result line's ``device`` and
PERF.md give the power limit beside every share.
"""

from __future__ import annotations

from typing import Dict, Tuple

F32_RATE = 3.35e13          # 132 SMs x 128 lanes x 1.98 GHz
MUFU_RATE = 4.18e12         # 132 SMs x 16 x 1.98 GHz
HBM_RATE = 3.35e12
# f32 instructions per (pixel, entry) pair the compositors must do (each
# product and sum an instruction of its own; expf ~6 plus one MUFU.EX2,
# an IEEE divide ~6 plus one MUFU.RCP).  Only the work no walk can avoid
# is charged: every blended pair's test, exp and blend, and one box test
# per live entry.
OPS_TEST = 12       # dx, dy, the exponent, its > 0 test
OPS_EXP = 9         # expf, the opacity product and clamp, the alpha test
OPS_BLEND_FWD = 12  # the stop test, the weight, colour sums, segmentation
OPS_BLEND_BWD = 51  # the stop test, the suffix sum, nine gradient terms
OPS_CULL = 95       # one entry's box-max exponent test (two divides)
MUFU_CULL = 2
ENTRY_BYTES = 40    # per live entry: Gaussian id + 9 floats read once
SEM_BYTES = 4       # + its semantic id, when segmenting
ROW_BYTES = 36      # the backward's 9-float row per entry, written once
FWD_PIXEL_BYTES = 16  # RGB + T written (+ SEM_BYTES of segmentation)
BWD_PIXEL_BYTES = 32  # RGB, T and their cotangents read


def bound_of(ops: float, mufu: float, nbytes: float
             ) -> Tuple[float, str, Dict[str, float]]:
    """The least time (s) of ``ops`` f32 instructions, ``mufu`` MUFU
    operations and ``nbytes`` HBM bytes on one H100, and what binds it:
    -> (seconds, "operations" or "bytes", {resource: seconds})."""
    parts = {"f32": ops / F32_RATE, "mufu": mufu / MUFU_RATE,
             "bytes": nbytes / HBM_RATE}
    worst = max(parts, key=parts.get)
    return parts[worst], ("bytes" if worst == "bytes" else "operations"), \
        parts


def composite_work(bins_starts, walked) -> Dict[str, int]:
    """The work of frames from their per-tile starts (F, T+1) and the
    plain walk's counts (a dict of (F, H, W) tensors): blended pairs,
    live entries (entries the binning kept in a tile) and pixels."""
    return {"blended": int(walked["blended"].sum()),
            "live": int(bins_starts[:, -1].sum()),
            "pixels": int(walked["blended"].numel())}


def add_work(a: Dict[str, int], b: Dict[str, int]) -> Dict[str, int]:
    return {k: a.get(k, 0) + b.get(k, 0) for k in set(a) | set(b)}


def composite_fwd_bound(work: Dict[str, int], segment: bool):
    """The forward compositor's bound on ``work``: the blended pairs'
    tests, exps and blends, one box test per live entry, each live entry
    read once and each pixel written once."""
    pairs, live = work["blended"], work["live"]
    ent = ENTRY_BYTES + (SEM_BYTES if segment else 0)
    px = FWD_PIXEL_BYTES + (SEM_BYTES if segment else 0)
    return bound_of((OPS_TEST + OPS_EXP + OPS_BLEND_FWD) * pairs
                    + OPS_CULL * live, pairs + MUFU_CULL * live,
                    live * ent + work["pixels"] * px)


def composite_bwd_bound(work: Dict[str, int]):
    """The backward compositor's bound on ``work``: the blended pairs'
    tests, exps, divides and gradient terms, one box test per live entry,
    each live entry read and its row written once, each pixel's colour,
    transmittance and their cotangents read once."""
    pairs, live = work["blended"], work["live"]
    return bound_of((OPS_TEST + OPS_EXP + OPS_BLEND_BWD) * pairs
                    + OPS_CULL * live, 2 * pairs + MUFU_CULL * live,
                    live * (ENTRY_BYTES + ROW_BYTES)
                    + work["pixels"] * BWD_PIXEL_BYTES)


def count_frames(proj, cfg):
    """Work of frame-batched projections ``proj`` (the reference's
    Projected, (F, N, ...)) under the raster config ``cfg``: the
    reference's binning, then its walk."""
    from benchmark.reference.gsw.render.binning import bin_entries_fused
    from benchmark.reference.gsw.render.rasterize_cuda import walk_counts
    bins = bin_entries_fused(proj, cfg)
    walked = walk_counts(bins.starts, bins.gaussian, proj.mean2d, proj.conic,
                         proj.opacity, width=cfg.width, height=cfg.height,
                         tile=cfg.tile)
    return composite_work(bins.starts, walked)
