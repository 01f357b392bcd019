"""The roofline's work counts, on a frame counted by hand: one 16x16
tile, three wide Gaussians, nearest first.  The first two (alpha 0.5)
blend at every pixel (transmittance 1, then 0.5); the third (alpha 0.001,
under 1/255) is walked but blends nowhere."""

import pytest
import torch

from benchmark import roofline as R
from benchmark.reference.gsw.render.rasterize_cuda import walk_counts


def frame():
    starts = torch.tensor([[0, 3]], dtype=torch.int32)
    gaussian = torch.tensor([[0, 1, 2]], dtype=torch.int32)
    mean2d = torch.full((1, 3, 2), 8.0)
    conic = torch.tensor([[[1e-8, 0.0, 1e-8]] * 3])
    opacity = torch.tensor([[0.5, 0.5, 0.001]])
    return starts, gaussian, mean2d, conic, opacity


def test_pairs_entries_and_pixels_by_hand():
    starts, gaussian, mean2d, conic, opacity = frame()
    walked = walk_counts(starts, gaussian, mean2d, conic, opacity, width=16,
                         height=16, tile=16)
    work = R.composite_work(starts, walked)
    assert work == {"blended": 2 * 256, "live": 3, "pixels": 256}


def test_bounds_by_hand():
    work = {"blended": 512, "live": 3, "pixels": 256}
    fwd_s, _, parts = R.composite_fwd_bound(work, segment=True)
    assert parts["bytes"] == pytest.approx((3 * 44 + 256 * 20) / R.HBM_RATE)
    assert parts["f32"] == pytest.approx((33 * 512 + 95 * 3) / R.F32_RATE)
    assert parts["mufu"] == pytest.approx((512 + 2 * 3) / R.MUFU_RATE)
    assert fwd_s == max(parts.values())
    bwd_s, by, parts = R.composite_bwd_bound(work)
    assert parts["bytes"] == pytest.approx((3 * 76 + 256 * 32) / R.HBM_RATE)
    assert parts["f32"] == pytest.approx((72 * 512 + 95 * 3) / R.F32_RATE)
    assert parts["mufu"] == pytest.approx((2 * 512 + 2 * 3) / R.MUFU_RATE)
    assert by == ("bytes" if bwd_s == parts["bytes"] else "operations")


def test_work_ignores_the_entry_capacity():
    """The same frame in a larger entry buffer is the same work: a bound
    never charges unused slots."""
    starts, gaussian, mean2d, conic, opacity = frame()
    padded = torch.cat([gaussian, torch.full((1, 61), -1,
                                             dtype=torch.int32)], dim=1)
    a = R.composite_work(starts, walk_counts(
        starts, gaussian, mean2d, conic, opacity, width=16, height=16,
        tile=16))
    b = R.composite_work(starts, walk_counts(
        starts, padded, mean2d, conic, opacity, width=16, height=16,
        tile=16))
    assert a == b
