"""The reset's device stamps on the card: one graphed reset of a 2-env
xArm6 wrapper under domain randomization leaves exactly one
``reset.begin`` / ``reset.end`` pair in the stamp ring, through one
replay of the wrapper's reset graph, with its ``dr.draws`` counted; and
the closed loop's recorded stretch (``benchmark/spans.py``) still reads
every ``loop_*`` metric when resets fall inside it.  The module imports
no JAX and skips without a CUDA card; on the card's machine run it
without the tests' conftest, which imports JAX:

    python -m pytest tests/test_torch_reset_stamps_card.py --noconftest -s
"""

import pytest
import torch

from benchmark import harness as H
from benchmark import reset_spans, spans
from benchmark.tests.tiny import tiny_cell
from gsworld_tpu_torch.utils import profiling as P

SEED = 2 ** 31 + 1811
LOOP_METRICS = {"loop_launch_ms", "loop_between_ms", "loop_host_syncs",
                "loop_physics_ms", "loop_render_ms"}

pytestmark = pytest.mark.card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the stamps are a CUDA kernel")


def _driver(name, **traffic):
    cell = tiny_cell(name, num_envs=2)
    cell.traffic.update(traffic)
    d = H.driver_module(cell.config["driver"]).Driver(cell, SEED,
                                                      device="cuda")
    d.setup()
    return d


def test_graphed_reset_stamps_one_pair(card):
    d = _driver("xarm6_align_dr.dr64")
    with P.recording() as rec:
        d.reset(keep=False)
    e = rec._drain()
    assert e.lost == 0
    assert e.tags == ["anchor", "reset.begin", "reset.end", "anchor"]
    counts = rec.counts()
    assert counts["graph.replays/the closed-loop reset"] == 1
    assert counts["dr.draws/AlignXArmEnv"] == 2 * 22
    assert not any(k.startswith("graph.captures/") for k in counts)
    assert [x.name for x in rec.device_spans()] == ["loop.reset"]
    out = reset_spans.reset_stretch(d, P, resets=4)
    assert set(out["metrics"]) == {"loop_reset_ms", "loop_reset_layout_ms"}
    assert out["notes"]["dr_draws_per_reset"] == 2 * 22


def test_loop_stretch_across_resets_reads_every_metric(card):
    d = _driver("fr3_align_loop.e64", episode_steps=5)
    out = spans.measure(d, P, steps=12)
    assert set(out["metrics"]) == LOOP_METRICS, out
    assert out["metrics"]["loop_host_syncs"] == 1.0
    dev = [x.name for x in out["recording"].device_spans()]
    assert dev.count("loop.reset") == 2 and dev.count("loop.between") == 11
