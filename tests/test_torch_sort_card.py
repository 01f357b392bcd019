"""The key sort of tile binning (csrc/sort_tiles.cu, through
``rasterize_cuda.sort_tiles`` and ``binning.sort_entries``) on the card:
its sorted keys and permutation bit for bit ``torch.sort``'s on random
keys of 9, 10, 16 and 18 bits with many equal keys, and with every slot
at its frame's sentinel; captured in a CUDA graph, each replay sorts the
keys it finds (one launch counted at the capture, none at a replay, one
digit-histogram kernel a replay by the profiler); and the whole binning
on the card bit for bit the same binning on the CPU.  The module skips
without a CUDA card; the card's machine has no JAX, so it runs without
the tests' conftest:

    python -m pytest tests/test_torch_sort_card.py --noconftest -s
"""

import dataclasses
import importlib.util
import os

import pytest
import torch

import chip_smoke
from gsworld_tpu_torch.render import rasterize_cuda as rc
from gsworld_tpu_torch.render.binning import bin_entries_fused, sort_entries
from gsworld_tpu_torch.render.project import Projected

SEED = 2 ** 31 + 2121
KERNEL = chip_smoke.KERNEL_NAMES["sort_tiles"]


def _emit_tests():
    """tests/test_torch_emit.py, by its path (the name ``tests`` may be
    another package's where the card runs)."""
    path = os.path.join(os.path.dirname(__file__), "test_torch_emit.py")
    spec = importlib.util.spec_from_file_location("_emit_tests", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


pytestmark = [pytest.mark.card, pytest.mark.skipif(
    not torch.cuda.is_available(),
    reason="needs a CUDA card: the CUDA kernels run there only")]


def _keys(frames, tiles, E, sentinel, seed):
    """Keys f (T+1) + tile (F, E) int32 on the card: a few tiles, so that
    equal keys are common, the sentinel T among them, or every slot at
    it."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    choice = torch.tensor([0, 1, 5, tiles // 2, tiles - 1, tiles],
                          device="cuda")
    pick = torch.randint(0, len(choice), (frames, E), generator=gen,
                         device="cuda")
    tile = torch.full_like(pick, tiles) if sentinel else choice[pick]
    f = torch.arange(frames, device="cuda")[:, None]
    return (f * (tiles + 1) + tile).to(torch.int32)


@pytest.mark.parametrize("frames,tiles,E,sentinel", [
    (1, 300, 393216, False), (2, 300, 393216, False),
    (128, 300, 393216, False), (512, 300, 16384, False),
    (128, 300, 393216, True)])
def test_sort_tiles_matches_torch_sort(frames, tiles, E, sentinel):
    keys = _keys(frames, tiles, E, sentinel, SEED + frames)
    bits = (frames * (tiles + 1) - 1).bit_length()
    got_k, got_p = rc.sort_tiles(keys.clone(), bits)
    want = torch.sort(keys.reshape(-1), stable=True)
    torch.cuda.synchronize()
    assert got_k.dtype == got_p.dtype == torch.int32
    assert torch.equal(got_k, want.values)
    assert torch.equal(got_p.long(), want.indices)


def test_sort_entries_in_a_cuda_graph():
    frames, tiles, E = 128, 300, 393216
    keys = _keys(frames, tiles, E, False, SEED)
    gid = torch.randint(-1, 200_000, (frames, E), dtype=torch.int32,
                        device="cuda")
    static = keys.clone()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        sort_entries(static.clone(), gid, tiles)         # warm-up
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    rc.reset_launch_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = sort_entries(static.clone(), gid, tiles)
    assert rc.launch_counts["sort_tiles"] == 1
    for seed in (1, 2):
        static.copy_(_keys(frames, tiles, E, False, SEED + seed))
        graph.replay()
        want = sort_entries(static.clone(), gid, tiles)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, want))
        perm = torch.sort(static.reshape(-1), stable=True).indices
        assert torch.equal(out[2].reshape(-1).long(), perm)
    assert rc.launch_counts["sort_tiles"] == 3       # the capture, 2 eager
    text, _, per = chip_smoke.replay_kernels(
        lambda: [graph.replay() for _ in range(3)], 3,
        "sort graph replays", names={KERNEL: 1})
    assert per[KERNEL] == 1, text


@pytest.mark.parametrize("cull_alpha", [False, True])
def test_binning_on_card_matches_cpu(cull_alpha):
    proj, cfg = _emit_tests()._projected(11, F=6, n=2000, width=320,
                                         height=224, tile=16, ties=True)
    cfg = dataclasses.replace(cfg, max_entries=20_000, cull_alpha=cull_alpha)
    cpu = bin_entries_fused(proj, cfg)
    card = bin_entries_fused(Projected(*(x.cuda() for x in proj)), cfg)
    T = cfg.num_tiles
    assert int(cpu.overflow.min()) > 0              # the budget binds
    assert torch.equal(card.starts.cpu(), cpu.starts)
    assert torch.equal(card.overflow.cpu(), cpu.overflow)
    for f in range(cpu.starts.shape[0]):
        n = int(cpu.starts[f, T])
        assert n > 0
        assert torch.equal(card.gaussian[f, :n].cpu(), cpu.gaussian[f, :n])
