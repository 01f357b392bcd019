"""The structure of the emit kernel (csrc/emit.cu) and of the key sort
(csrc/sort_tiles.cu), checked on the CPU through the plain PyTorch
copies of their pieces in gsworld_tpu_torch.render.rasterize_cuda and
render.binning:

  (a) the slot-to-owner search (``emit_owner_reference``: the first rank
      whose inclusive end lies past the slot) against ``numpy.repeat`` of
      the counts per depth rank, with ranks without entries in the
      middle, totals of 0 and of exactly E, runs of full rects and
      several frames;
  (b) ``plan_emit``'s depth ranking and rank-order slot ends against a
      literal numpy reckoning of the budget (the longest prefix of the
      stable depth ranking that fits), where the budget binds and where
      it does not;
  (c) the plain emit against a literal walk of every ranked Gaussian's
      rect, row by row, with the alpha cull off and on;
  (d) the binning's outputs (``gaussian`` up to ``starts[:, T]``,
      ``starts``, ``overflow``) bit for bit against a literal of the
      binning the port had before its slots followed the depth ranking:
      slots in Gaussian order and one stable sort of the 64-bit keys
      ``(f (T+1) + tile) << 32 | depth bits``, exact depth ties, keys of
      more than 8 bits and a binding budget included;
  (e) ``sort_entries`` at the key widths of one frame, two, 128 and more
      frames against numpy's stable argsort and a count per (frame,
      tile), on random keys and with every slot at the sentinel.

The kernels themselves are held against the plain versions on the card
by chip_smoke.py.  Inputs are made with numpy from a seed.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gsworld_tpu_torch.render import rasterize_cuda as rc
from gsworld_tpu_torch.render.binning import (
    bin_entries_fused,
    plan_emit,
    sort_entries,
)
from gsworld_tpu_torch.render.camera import RasterConfig
from gsworld_tpu_torch.render.project import Projected

D = 64


def _count_cases():
    """name -> (counts (F, N), E)."""
    rng = np.random.default_rng(0)
    mid = rng.integers(1, 9, (1, 60))
    mid[0, 20:35] = 0                       # a run without entries
    mid[0, 40] = 0
    edges = rng.integers(1, 5, (1, 40))
    edges[0, :7] = 0                        # none at the start
    edges[0, -9:] = 0                       # nor at the end
    full = np.full((1, 50), 3)
    full[0, 10:25] = D                      # a run of full rects
    exact = rng.integers(0, 6, (1, 70))
    frames = rng.integers(0, 7, (4, 80))
    frames[1] = 0                           # one frame without entries
    frames[2, 30:] = 0
    return {
        "zeros_in_the_middle": (mid, 1024),
        "zeros_at_both_ends": (edges, 256),
        "runs_of_full_rects": (full, 2048),
        "total_is_zero": (np.zeros((1, 30), np.int64), 64),
        "total_is_E": (exact, int(exact.sum())),
        "one_gaussian": (np.array([[5]]), 8),
        "four_frames": (frames, 512),
    }


@pytest.mark.parametrize("case", sorted(_count_cases()))
def test_owner_search_matches_repeat(case):
    """Counts per depth rank; the owner of a slot is a rank."""
    cnt, E = _count_cases()[case]
    F, N = cnt.shape
    ends = torch.as_tensor(np.cumsum(cnt, axis=1).astype(np.int32))
    owner = rc.emit_owner_reference(ends, E).numpy()
    assert owner.shape == (F, E)
    for f in range(F):
        want = np.full(E, N)
        rep = np.repeat(np.arange(N), cnt[f])
        want[:len(rep)] = rep
        np.testing.assert_array_equal(owner[f], want)
        # an owner always has entries: equal ends are skipped
        assert (cnt[f][owner[f][owner[f] < N]] > 0).all()


def _projected(seed, F=1, n=300, width=160, height=96, tile=16, ties=False,
               culled_every=5):
    """Seeded projections (F, n) with rects of 1 to more than D tiles,
    Gaussians without a rect, culled ones, and (``ties``) depths drawn
    from a few values so that many are exactly equal."""
    rng = np.random.default_rng(seed)
    gx, gy = -(-width // tile), -(-height // tile)
    mean = rng.uniform([-8, -8], [width + 8, height + 8], (F, n, 2))
    sig = rng.uniform(0.6, 14.0, (F, n, 2))
    sig[:, ::11] *= 4.0                             # some cover > D tiles
    th = rng.uniform(0, np.pi, (F, n))
    c, s = np.cos(th), np.sin(th)
    cxx = c * c * sig[..., 0] ** 2 + s * s * sig[..., 1] ** 2
    cyy = s * s * sig[..., 0] ** 2 + c * c * sig[..., 1] ** 2
    cxy = c * s * (sig[..., 0] ** 2 - sig[..., 1] ** 2)
    det = cxx * cyy - cxy * cxy
    conic = np.stack([cyy / det, -cxy / det, cxx / det], -1)
    radius = np.ceil(3.0 * sig.max(-1)).astype(np.int32)
    depth = (rng.integers(1, 6, (F, n)) * 0.5 if ties
             else rng.uniform(0.5, 6.0, (F, n)))
    lo = np.floor((mean - radius[..., None]) / tile).astype(np.int64)
    hi = np.floor((mean + radius[..., None]) / tile).astype(np.int64) + 1
    rect = np.stack([np.clip(lo[..., 0], 0, gx), np.clip(lo[..., 1], 0, gy),
                     np.clip(hi[..., 0], 0, gx), np.clip(hi[..., 1], 0, gy)],
                    -1)
    culled = np.arange(n) % culled_every == 0
    radius[:, culled] = 0
    depth[:, culled] = np.inf
    rect[:, culled] = 0
    mean[:, culled] = np.inf                        # a poisoned row
    proj = Projected(
        mean2d=torch.as_tensor(mean, dtype=torch.float32),
        depth=torch.as_tensor(depth, dtype=torch.float32),
        conic=torch.as_tensor(conic, dtype=torch.float32),
        color=torch.as_tensor(rng.uniform(0, 1, (F, n, 3)),
                              dtype=torch.float32),
        opacity=torch.as_tensor(rng.uniform(0.02, 0.95, (F, n)),
                                dtype=torch.float32),
        radius=torch.as_tensor(radius),
        rect=torch.as_tensor(rect, dtype=torch.int32))
    return proj, RasterConfig(width=width, height=height, tile=tile,
                              max_tiles_per_gaussian=D, max_entries=8192)


def _with_budget(cfg, E):
    return dataclasses.replace(cfg, max_entries=E)


def _areas(proj):
    r = proj.rect.numpy().astype(np.int64)
    area = np.clip((r[..., 2] - r[..., 0]) * (r[..., 3] - r[..., 1]), 0, None)
    valid = (proj.radius.numpy() > 0) & np.isfinite(proj.depth.numpy())
    return np.where(valid, area, 0), valid


def _budget_oracle(proj, E):
    """Kept counts per Gaussian (F, N), overflow (F,) and the stable depth
    ranking (F, N), by a literal walk of the ranking."""
    area, valid = _areas(proj)
    depth = np.where(valid, proj.depth.numpy(), np.inf)
    F, N = area.shape
    kept = np.zeros((F, N), np.int64)
    order = np.zeros((F, N), np.int64)
    for f in range(F):
        order[f] = sorted(range(N), key=lambda i: (depth[f, i], i))
        run = 0
        for g in order[f]:
            c = min(area[f, g], D)
            run += c
            if run > E:
                break                               # a prefix is kept
            kept[f, g] = c
    return kept, area.sum(-1) - kept.sum(-1), order


@pytest.mark.parametrize("budget", ["loose", "binding", "nothing_fits",
                                    "fits_exactly"])
def test_plan_ends_follow_the_depth_budget(budget):
    proj, cfg = _projected(3, F=3, ties=True)
    area, _ = _areas(proj)
    asked = np.minimum(area, D).sum(-1)
    E = {"loose": int(asked.max()) + 100, "binding": int(asked.min()) // 2,
         "nothing_fits": 0, "fits_exactly": int(asked[1])}[budget]
    plan = plan_emit(proj, _with_budget(cfg, E))
    kept, overflow, order = _budget_oracle(proj, E)
    ends = plan.args["ends"]
    assert ends.dtype == torch.int32 and plan.overflow.dtype == torch.int64
    assert plan.args["order"].dtype == torch.int32
    np.testing.assert_array_equal(plan.args["order"].numpy(), order)
    # slots follow the ranking; past the kept prefix ends hold the total
    np.testing.assert_array_equal(
        ends.numpy(), np.cumsum(np.take_along_axis(kept, order, 1), axis=1))
    np.testing.assert_array_equal(plan.overflow.numpy(), overflow)
    assert int(ends[:, -1].max()) <= E
    if budget == "binding":
        assert (overflow > (area - np.minimum(area, D)).sum(-1)).all()
    if budget == "fits_exactly":
        assert int(ends[1, -1]) == E


def _emit_oracle(a):
    """Literal emit: every ranked Gaussian walks its rect row by row from
    its first slot (the work of one thread of the kernel's first form)."""
    ends, order = a["ends"].numpy(), a["order"].numpy()
    F, N = ends.shape
    E, T, gx, tile = a["E"], a["T"], a["gx"], a["tile"]
    keys = np.empty((F, E), np.int64)
    gid = np.full((F, E), -1, np.int32)
    rect = a["rect"].numpy()
    for f in range(F):
        keys[f] = f * (T + 1) + T
        for r in range(N):
            g = order[f, r]
            first = ends[f, r - 1] if r else 0
            x0, y0, x1, _ = (int(v) for v in rect[f, g])
            w = max(x1 - x0, 1)
            for d in range(int(ends[f, r] - first)):
                tx, ty = x0 + d % w, y0 + d // w
                t = ty * gx + tx
                if a["cull_alpha"]:
                    pw = rc._box_max_power(
                        a["mean2d"][f, g, 0], a["mean2d"][f, g, 1],
                        *a["conic"][f, g], torch.tensor(tx), torch.tensor(ty),
                        tile)
                    lop = torch.log(a["opacity"][f, g].clamp_min(1e-12))
                    if not bool(pw + lop >= rc.LOG_ALPHA_MIN):
                        t = T
                keys[f, first + d] = f * (T + 1) + t
                gid[f, first + d] = g
    return keys, gid


@pytest.mark.parametrize("cull_alpha", [False, True])
def test_plain_emit_matches_literal_walk(cull_alpha):
    proj, cfg = _projected(5, F=2, n=90, width=96, height=64)
    cfg = dataclasses.replace(cfg, cull_alpha=cull_alpha, max_entries=700)
    plan = plan_emit(proj, cfg)
    a = plan.args
    assert int(a["ends"][:, -1].min()) > 0
    assert int(plan.overflow.min()) > 0             # the budget binds
    keys, gid = rc.emit_entries(**a)                # CPU: the plain version
    want_keys, want_gid = _emit_oracle(a)
    assert keys.dtype == gid.dtype == torch.int32
    np.testing.assert_array_equal(gid.numpy(), want_gid)
    np.testing.assert_array_equal(keys.numpy(), want_keys)
    tiles = keys.numpy() % (cfg.num_tiles + 1)
    live = gid.numpy() >= 0
    assert (tiles[~live] == cfg.num_tiles).all()
    if cull_alpha:
        assert (tiles[live] == cfg.num_tiles).any()     # some were culled
        assert (tiles[live] < cfg.num_tiles).any()
    else:
        assert (tiles[live] < cfg.num_tiles).all()


# ---- the binning the port had: slots in Gaussian order, 64-bit keys --- #

def parent_layout_bins(proj, cfg):
    """The binning as the port had it before its slots followed the depth
    ranking, written out literally: each Gaussian's kept entries (the
    budget's literal walk) in Gaussian order, its rect row-major, the
    alpha cull on the same box function, keys ``(f (T+1) + tile) << 32 |
    depth bits`` (the sentinel's depth bits those of +inf) and one stable
    sort of them -> (gaussian (F, E), starts (F, T+1), overflow (F,),
    slot ends (F, N) in Gaussian order, the sort's permutation (F, E):
    sorted position -> f E + slot)."""
    E, T, gx, tile = cfg.max_entries, cfg.num_tiles, cfg.tiles_x, cfg.tile
    kept, overflow, _ = _budget_oracle(proj, E)
    F, N = kept.shape
    ends = np.cumsum(kept, axis=1)
    dbits = proj.depth.numpy().view(np.int32).astype(np.int64)
    rect = proj.rect.numpy().astype(np.int64)
    keys = np.empty((F, E), np.int64)
    gid = np.full((F, E), -1, np.int32)
    for f in range(F):
        keys[f] = ((f * (T + 1) + T) << 32) | 0x7F800000
        g = np.repeat(np.arange(N), kept[f])
        d = np.arange(len(g)) - (ends[f] - kept[f])[g]
        w = np.maximum(rect[f, g, 2] - rect[f, g, 0], 1)
        tx, ty = rect[f, g, 0] + d % w, rect[f, g, 1] + d // w
        t = ty * gx + tx
        if cfg.cull_alpha:
            m, c = proj.mean2d[f, g], proj.conic[f, g]
            pw = rc._box_max_power(m[:, 0], m[:, 1], c[:, 0], c[:, 1],
                                   c[:, 2], torch.as_tensor(tx),
                                   torch.as_tensor(ty), tile)
            lop = torch.log(proj.opacity[f, g].clamp_min(1e-12))
            t = np.where((pw + lop >= rc.LOG_ALPHA_MIN).numpy(), t, T)
        keys[f, :len(g)] = ((f * (T + 1) + t) << 32) | dbits[f, g]
        gid[f, :len(g)] = g
    keys_s, perm = torch.sort(torch.as_tensor(keys).reshape(-1), stable=True)
    gaussian = torch.as_tensor(gid).reshape(-1)[perm].reshape(F, E)
    bounds = ((np.arange(F)[:, None] * (T + 1) + np.arange(T + 1)) << 32)
    starts = (np.searchsorted(keys_s.numpy(), bounds.reshape(-1))
              .reshape(F, T + 1) - np.arange(F)[:, None] * E)
    return (gaussian, torch.as_tensor(starts.astype(np.int32)),
            torch.as_tensor(overflow), ends, perm.reshape(F, E))


@pytest.mark.parametrize("case", ["plain", "depth_ties", "budget_binds",
                                  "ties_and_budget", "cull_off",
                                  "wide_keys_ties_and_budget"])
def test_binning_equals_rank_order_layout(case):
    ties = "ties" in case
    F = 6 if case.startswith("wide_keys") else 3
    proj, cfg = _projected(7, F=F, ties=ties)
    if "budget" in case:
        cfg = _with_budget(cfg, 1500)
    if case == "cull_off":
        cfg = dataclasses.replace(cfg, cull_alpha=False)
    T = cfg.num_tiles
    if case.startswith("wide_keys"):
        assert (F * (T + 1) - 1).bit_length() > 8
    bins = bin_entries_fused(proj, cfg)
    gaussian, starts, overflow, _, _ = parent_layout_bins(proj, cfg)
    np.testing.assert_array_equal(bins.starts.numpy(), starts.numpy())
    np.testing.assert_array_equal(bins.overflow.numpy(), overflow.numpy())
    assert bins.overflow.dtype == overflow.dtype == torch.int64
    for f in range(starts.shape[0]):
        n = int(starts[f, T])
        assert n > 0
        np.testing.assert_array_equal(bins.gaussian[f, :n].numpy(),
                                      gaussian[f, :n].numpy())
    if "budget" in case:
        assert int(bins.overflow.min()) > 0
    if ties:
        # equal depths met in one tile, where only the id decides
        d = proj.depth.numpy()
        met = 0
        for t in range(T):
            g = bins.gaussian[0, int(starts[0, t]):int(starts[0, t + 1])]
            dd = d[0][g.numpy()]
            same = dd[1:] == dd[:-1]
            met += int(same.sum())
            assert (np.diff(g.numpy())[same] > 0).all()
        assert met > 0


# ---- the key sort at each width -------------------------------------- #

@pytest.mark.parametrize("frames,tiles,sentinel", [
    (1, 300, False), (2, 300, False), (128, 300, False), (256, 300, False),
    (512, 300, False), (2, 300, True), (128, 300, True)])
def test_sort_entries_matches_stable_argsort(frames, tiles, sentinel):
    """``sort_entries`` on keys of bit_length(F (T+1) - 1) = 9, 10, 16, 17
    and 18 bits: the sorted ids are numpy's stable argsort of the keys read
    through the ids, the permutation is that argsort, and the starts are
    the running count of keys per (frame, tile); with every slot at its
    frame's sentinel, every tile is empty and the order is the slots'."""
    E = 48
    T = tiles
    rng = np.random.default_rng(frames + 7 * sentinel)
    f = np.arange(frames)[:, None]
    if sentinel:
        tile = np.full((frames, E), T)
    else:
        # few tiles, so that equal keys are common; the sentinel among them
        tile = rng.choice(np.array([0, 1, 5, T // 2, T - 1, T]), (frames, E))
    keys = (f * (T + 1) + tile).astype(np.int32)
    gid = rng.integers(-1, 1000, (frames, E)).astype(np.int32)
    gaussian, starts, perm = sort_entries(torch.as_tensor(keys),
                                          torch.as_tensor(gid), T)
    want = np.argsort(keys.reshape(-1), kind="stable")
    assert perm.dtype == starts.dtype == torch.int32
    np.testing.assert_array_equal(perm.reshape(-1).numpy(), want)
    np.testing.assert_array_equal(gaussian.reshape(-1).numpy(),
                                  gid.reshape(-1)[want])
    counts = np.stack([np.bincount(tile[i], minlength=T + 1)
                       for i in range(frames)])
    np.testing.assert_array_equal(
        starts.numpy(), np.cumsum(counts, axis=1) - counts)
    if sentinel:
        assert not starts.numpy().any()
