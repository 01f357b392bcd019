"""The structure of the compositor kernels (csrc/composite.cu,
csrc/composite_bwd.cu), checked on the CPU through plain PyTorch copies
of their pieces in gsworld_tpu_torch.render.rasterize_cuda:

  (a) the sub-tile cull predicate (``subtile_keep_reference``, the
      kernels' f32 order) never drops an entry that some pixel of the
      sub-tile accepts, on seeded random splats and on splats placed at
      the alpha threshold, and drops what lies clearly below it;
  (b) compositing sub-tile by sub-tile over the culled entry lists equals
      the plain compositor over whole tiles exactly (RGB, T,
      segmentation);
  (c) the backward's rows summed over the sub-tiles equal the un-split
      rows to 1e-6 relative;
  (d) the record gather copies the fields it names.

The kernels themselves are held against the plain versions on the card by
chip_smoke.py.
"""

import numpy as np
import torch

from gsworld_tpu_torch.render import rasterize_cuda as rc
from gsworld_tpu_torch.render.camera import RasterConfig
from gsworld_tpu_torch.render.project import Projected
from gsworld_tpu_torch.render.rasterize import bin_detached

SUB = rc.SUB_TILE


def _conics(rng, n, sig_lo, sig_hi):
    """Positive definite conics of sigmas in [sig_lo, sig_hi] px at random
    angles, (n, 3) as (A, B, C) of power = -(A dx^2 + C dy^2) / 2 - B dx dy,
    and the larger sigma of each."""
    s = rng.uniform(sig_lo, sig_hi, (n, 2))
    th = rng.uniform(0, np.pi, n)
    c, sn = np.cos(th), np.sin(th)
    cxx = c * c * s[:, 0] ** 2 + sn * sn * s[:, 1] ** 2
    cyy = sn * sn * s[:, 0] ** 2 + c * c * s[:, 1] ** 2
    cxy = c * sn * (s[:, 0] ** 2 - s[:, 1] ** 2)
    det = cxx * cyy - cxy * cxy
    return np.stack([cyy / det, -cxy / det, cxx / det], -1), s.max(-1)


def _records(mean, conic, op):
    n = len(op)
    rec = np.zeros((n, rc.RECORD_FIELDS), np.float32)
    rec[:, 0:2], rec[:, 2:5], rec[:, 5] = mean, conic, op
    return _set_opacity(torch.as_tensor(rec), rec[:, 5])


def _set_opacity(rec, op):
    """Opacity and its log (the record's cull field), as the gather
    writes them."""
    rec[:, 5] = torch.as_tensor(op)
    rec[:, 10] = torch.log(rec[:, 5].clamp_min(1e-12))
    return rec


def _accepts(rec, x0, y0, size):
    """Per record, whether some pixel of the size x size box at (x0, y0)
    accepts it, with the compositors' f32 operations: power <= 0 and
    min(0.99, opacity e^power) >= 1/255."""
    ys, xs = torch.meshgrid(torch.arange(size, dtype=torch.float32) + y0,
                            torch.arange(size, dtype=torch.float32) + x0,
                            indexing="ij")
    px, py = xs.reshape(1, -1), ys.reshape(1, -1)
    mx, my, A, B, C, op = (rec[:, k:k + 1] for k in range(6))
    dx, dy = mx - px, my - py
    power = -0.5 * (A * dx * dx + C * dy * dy) - B * dx * dy
    alpha = torch.clamp_max(op * torch.exp(power), rc.ALPHA_MAX)
    ok = (power <= 0.0) & (alpha >= torch.tensor(rc.ALPHA_MIN,
                                                  dtype=torch.float32))
    return ok.any(dim=1), power.max(dim=1).values


def test_cull_never_drops_an_accepted_entry():
    """(a) 20,000 random splats around a 16x16 sub-tile (sigmas 0.3-40
    px, elongation up to ~100:1, opacities 1e-4 to 1), and 4,000 placed at
    the threshold: opacity set so that the box's best pixel sits at alpha
    = 1/255 times (1 + k 2^-23), k in -8..8.  The predicate keeps every
    entry that a pixel accepts; its margin (CULL_ABS = 1e-3 in log alpha
    plus CULL_REL = 4e-6 of the exponent's terms) may keep a few that no
    pixel accepts, and it drops every entry whose best pixel lies more
    than twice that margin below the threshold."""
    rng = np.random.default_rng(0)
    x0, y0 = 32.0, 16.0
    n = 20000
    conic, _ = _conics(rng, n, 0.3, 40.0)
    mean = rng.uniform([x0 - 60, y0 - 60], [x0 + SUB + 60, y0 + SUB + 60],
                       (n, 2))
    op = 10.0 ** rng.uniform(-4, 0, n)
    rec = _records(mean, conic, op)
    ok, pmax = _accepts(rec, x0, y0, SUB)
    keep = rc.subtile_keep_reference(rec, x0, x0 + SUB - 1, y0, y0 + SUB - 1)
    assert not (ok & ~keep).any(), int((ok & ~keep).sum())
    assert 0.2 < float(ok.float().mean()) < 0.8      # both sides drawn
    # what lies clearly below the threshold is dropped
    A, B, C = rec[:, 2], rec[:, 3], rec[:, 4]
    ax = torch.maximum((x0 - rec[:, 0]).abs(),
                       (x0 + SUB - 1 - rec[:, 0]).abs())
    ay = torch.maximum((y0 - rec[:, 1]).abs(),
                       (y0 + SUB - 1 - rec[:, 1]).abs())
    M = A * ax * ax + C * ay * ay + 2 * B.abs() * ax * ay
    below = pmax + torch.log(rec[:, 5]) < rc.LOG_ALPHA_MIN - 2 * (
        rc.CULL_ABS + rc.CULL_REL * M)
    assert below.sum() > n // 4
    assert not (keep & below).any()

    # at the threshold: the best pixel's alpha within 8 ulps of 1/255
    m = 4000
    conic, _ = _conics(rng, m, 0.5, 20.0)
    mean = rng.uniform([x0 - 20, y0 - 20], [x0 + SUB + 20, y0 + SUB + 20],
                       (m, 2))
    rec = _records(mean, conic, np.ones(m))
    _, pmax = _accepts(rec, x0, y0, SUB)
    k = torch.as_tensor(rng.integers(-8, 9, m), dtype=torch.float64)
    op = (np.float32(rc.ALPHA_MIN) / torch.exp(pmax.double())
          * (1 + k * 2.0 ** -23)).float()
    rec = _set_opacity(rec, op.clamp_max(1.0))
    ok, _ = _accepts(rec, x0, y0, SUB)
    keep = rc.subtile_keep_reference(rec, x0, x0 + SUB - 1, y0, y0 + SUB - 1)
    assert ok.sum() > m // 4 and (~ok).sum() > m // 4
    assert not (ok & ~keep).any(), int((ok & ~keep).sum())
    # those not pushed past opacity 1 lie within the margin: all kept
    assert keep[op < 1.0].all() and (op < 1.0).sum() > m // 2


def _frame(n, seed, width=64, height=48, tile=32):
    """``n`` random splats in one frame (1, n, ...), binned at ``tile``;
    colours partly above the clamp, semantic ids 0-9 (ties possible)."""
    rng = np.random.default_rng(seed)
    conic, sig = _conics(rng, n, 1.0, 6.0)
    mean = rng.uniform([-4, -4], [width + 4, height + 4], (n, 2))
    r = np.ceil(3 * sig)
    gx, gy = -(-width // tile), -(-height // tile)
    rect = np.stack([np.clip(np.floor((mean[:, 0] - r) / tile), 0, gx),
                     np.clip(np.floor((mean[:, 1] - r) / tile), 0, gy),
                     np.clip(np.floor((mean[:, 0] + r + tile - 1) / tile), 0,
                             gx),
                     np.clip(np.floor((mean[:, 1] + r + tile - 1) / tile), 0,
                             gy)], -1)
    t = lambda x, dt=torch.float32: torch.as_tensor(x[None], dtype=dt)  # noqa
    proj = Projected(mean2d=t(mean), depth=t(rng.uniform(1, 5, n)),
                     conic=t(conic), color=t(rng.uniform(0, 4.5, (n, 3))),
                     opacity=t(rng.uniform(0.05, 0.95, n)),
                     radius=t(r, torch.int32), rect=t(rect, torch.int32))
    cfg = RasterConfig(width=width, height=height, tile=tile,
                       max_entries=4096)
    sem = torch.as_tensor(rng.integers(0, 10, n), dtype=torch.int32)
    return proj, bin_detached(proj, cfg), cfg, sem


def _subtile_lists(proj, bins, cfg, sem):
    """The kernels' walk lists: per (tile, 16x16 sub-tile), the tile's
    entries that survive the sub-tile cull, in order, laid out as the
    entry stream of a 16-pixel tiling of the same frame.  -> (starts16,
    gaussian16, index of each listed entry in the whole-tile stream,
    entries dropped)."""
    W, H, tile = cfg.width, cfg.height, cfg.tile
    ns = tile // SUB
    gx, gx16, gy16 = -(-W // tile), -(-W // SUB), -(-H // SUB)
    rec = rc.pack_records_reference(bins.starts, bins.gaussian, proj.mean2d,
                                    proj.conic, proj.opacity, proj.color,
                                    sem)[0]
    starts = bins.starts[0].long()
    lists = [[] for _ in range(gx16 * gy16)]
    dropped = 0
    for t in range(cfg.num_tiles):
        j = torch.arange(int(starts[t]), int(starts[t + 1]))
        for sy in range(ns):
            for sx in range(ns):
                X = (t % gx) * ns + sx
                Y = (t // gx) * ns + sy
                if Y >= gy16 or X >= gx16:
                    continue               # a sub-tile beyond the image
                x0, y0 = float(X * SUB), float(Y * SUB)
                keep = rc.subtile_keep_reference(
                    rec[j], x0, x0 + SUB - 1, y0, y0 + SUB - 1)
                lists[Y * gx16 + X] = j[keep]
                dropped += int((~keep).sum())
    counts = torch.tensor([len(x) for x in lists])
    starts16 = torch.cat([torch.zeros(1, dtype=torch.long),
                          torch.cumsum(counts, 0)]).to(torch.int32)[None]
    idx = torch.cat(lists).long()
    return starts16, bins.gaussian[0][idx][None], idx, dropped


def test_subtile_walk_equals_the_whole_tile_walk():
    """(b) Each 16x16 sub-tile walks only its culled list, and the frame
    comes out equal to the plain compositor's over whole 32x32 tiles, bit
    for bit: a dropped entry is one that every pixel of its sub-tile
    skips.  (Every list fits one step of the plain compositor, 64
    entries, so both runs group their products alike.)"""
    for seed in (0, 1, 2):
        proj, bins, cfg, sem = _frame(60, seed)
        assert int((bins.starts[0, 1:] - bins.starts[0, :-1]).max()) \
            <= rc.PLAIN_CHUNK
        starts16, g16, _, dropped = _subtile_lists(proj, bins, cfg, sem)
        assert dropped > 0
        args = (proj.mean2d, proj.conic, proj.opacity, proj.color, sem)
        kw = dict(width=cfg.width, height=cfg.height, bg=(0.1, 0.2, 0.3))
        whole = rc.composite_tiles_reference(bins.starts, bins.gaussian,
                                             *args, tile=cfg.tile, **kw)
        split = rc.composite_tiles_reference(starts16, g16, *args, tile=SUB,
                                             **kw)
        for name, a, b in zip(("rgb", "T", "seg"), whole, split):
            assert torch.equal(a, b), (seed, name)
        assert (whole[2] >= 0).any() and (whole[1] < 1).any()


def test_subtile_backward_rows_sum_to_the_whole_tile_rows():
    """(c) The backward over the sub-tiles' culled lists, each row added
    back to the entry it came from (as the kernel's four sub-tile blocks
    add into one row), equals the backward over whole tiles to 1e-6 of
    each field's largest value (the sums over pixels run in another
    order)."""
    for seed in (3, 4):
        proj, bins, cfg, sem = _frame(60, seed)
        starts16, g16, idx, _ = _subtile_lists(proj, bins, cfg, sem)
        args = (proj.mean2d, proj.conic, proj.opacity, proj.color)
        kw = dict(width=cfg.width, height=cfg.height)
        img, T, _ = rc.composite_tiles_reference(
            bins.starts, bins.gaussian, *args, None, tile=cfg.tile,
            bg=(0.1, 0.2, 0.3), **kw)
        rng = np.random.default_rng(seed)
        f32 = torch.float32
        g_img = torch.as_tensor(rng.normal(size=img.shape), dtype=f32)
        g_T = torch.as_tensor(rng.normal(size=T.shape), dtype=f32)
        whole = rc.composite_bwd_reference(bins.starts, bins.gaussian, *args,
                                           img, T, g_img, g_T, tile=cfg.tile,
                                           **kw)[0]
        split = rc.composite_bwd_reference(starts16, g16, *args, img, T,
                                           g_img, g_T, tile=SUB, **kw)[0]
        summed = torch.zeros_like(whole).index_add_(0, idx,
                                                    split[:len(idx)])
        for sl in (slice(0, 2), slice(2, 5), slice(5, 8), slice(8, 9)):
            scale = float(whole[:, sl].abs().max())
            assert scale > 0
            assert float((summed[:, sl] - whole[:, sl]).abs().max()) \
                <= 1e-6 * scale, (seed, sl)


def test_record_gather_copies_its_fields():
    """(d) Live entries' records hold the sorted entry's mean, conic,
    opacity, colour clamped to [0, COLOR_MAX], semantic id bits (-1
    without semantics) and log(max(opacity, 1e-12)), with a zero pad;
    slots past the live entries are zero."""
    proj, bins, cfg, sem = _frame(60, 5)
    live = int(bins.starts[0, -1])
    g = bins.gaussian[0, :live].long()
    for semantics in (sem, None):
        rec = rc.pack_records_reference(bins.starts, bins.gaussian,
                                        proj.mean2d, proj.conic, proj.opacity,
                                        proj.color, semantics)
        assert rec.shape == (1, cfg.max_entries, rc.RECORD_FIELDS)
        r = rec[0, :live]
        assert torch.equal(r[:, 0:2], proj.mean2d[0, g])
        assert torch.equal(r[:, 2:5], proj.conic[0, g])
        assert torch.equal(r[:, 5], proj.opacity[0, g])
        assert torch.equal(r[:, 6:9], proj.color[0, g].clamp(0, rc.COLOR_MAX))
        want = sem[g] if semantics is not None else torch.full_like(g, -1)
        assert torch.equal(r[:, 9].contiguous().view(torch.int32),
                           want.to(torch.int32))
        assert torch.equal(r[:, 10],
                           torch.log(proj.opacity[0, g].clamp_min(1e-12)))
        assert not r[:, 11].any() and not rec[0, live:].any()
