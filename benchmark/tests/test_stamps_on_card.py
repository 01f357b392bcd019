"""The device stamps on the card: a captured closed-loop step graph,
replayed three times, leaves three times its tags in the stamp ring, in
order and at rising times, and its outputs are bit for bit the eager
step's; a step through ``GSWorldWrapper.step`` counts its action copy and
its replay; and the recorded stretches of ``benchmark/spans.py`` read
every metric at the tiny cells' size.  On the card only."""

import pytest
import torch

from benchmark import harness as H
from benchmark import spans
from benchmark.tests.tiny import tiny_cell, tiny_train_cell
from gsworld_tpu_torch.utils import cuda_graph
from gsworld_tpu_torch.utils import profiling as P

LOOP = ["loop.begin", "loop.physics|render", "loop.end"]


def _leaves(x):
    out = []
    cuda_graph.tree_map(out.append, x)
    return out


def _loop_driver():
    d = H.driver_module("closed_loop").Driver(
        tiny_cell("fr3_align_loop.e64", num_envs=2), 2 ** 31 + 17,
        device="cuda")
    d.setup()
    return d


@pytest.mark.card
def test_step_graph_replays_its_stamps_and_the_eager_outputs(card):
    d = _loop_driver()
    w, env = d.wrapper, d.env
    actions = [d.next_action().to(env.device) for _ in range(3)]
    state, eager = env._state, []
    for a in actions:
        eager.append(w._step_and_render(state, a))
        state = eager[-1][0]
    graph = w.step_graph(actions[0])
    assert P.stamp_ring(env.device).numel() * 8 <= 64 * 1024
    with P.recording() as rec:
        state, outs = env._state, []
        for a in actions:
            outs.append(graph(state, a))
            state = outs[-1][0]
    e = rec._drain()
    assert e.lost == 0
    assert e.tags == ["anchor"] + LOOP * 3 + ["anchor"]
    assert all(a < b for a, b in zip(e.ns, e.ns[1:]))
    assert rec.counts() == {"graph.replays/the closed-loop step": 3}
    dev = rec.device_spans()
    assert [x.name for x in dev] == ["loop.physics", "loop.render",
                                     "loop.between"] * 2 + [
        "loop.physics", "loop.render"]
    assert all(x.start_ns < x.end_ns for x in dev)
    for got, want in zip(outs, eager):
        a, b = _leaves(got), _leaves(want)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.card
def test_wrapper_step_counts_its_copy_and_replay(card):
    d = _loop_driver()
    with P.recording() as rec:
        d.step()
    assert rec.counts() == {"host.sync/action_copy": 1,
                            "graph.replays/the closed-loop step": 1}
    names = sorted(s.name for s in rec.spans)
    assert names == ["gsw.step", "gsw.step.action", "gsw.step.launch",
                     "gsw.step.load", "gsw.step.outputs"]
    assert [x.name for x in rec.device_spans()] == ["loop.physics",
                                                     "loop.render"]


@pytest.mark.card
def test_recorded_stretches_read_every_metric(card):
    d = _loop_driver()
    out = spans.measure(d, P, steps=12)
    assert set(out["metrics"]) == {"loop_launch_ms", "loop_between_ms",
                                   "loop_host_syncs", "loop_physics_ms",
                                   "loop_render_ms"}, out
    assert out["metrics"]["loop_host_syncs"] == 1.0
    assert abs(out["notes"]["period_gap_pct"]) < 3.0, out["notes"]
    t = H.driver_module("train_3dgs").Driver(tiny_train_cell(), 2 ** 31 + 17,
                                             device="cuda")
    t.setup()
    out = spans.train_stretch(t, P, iters=30, skip=10)
    assert set(out["metrics"]) == {"train_forward_ms", "train_backward_ms",
                                   "train_update_ms", "train_between_ms",
                                   "train_host_syncs"}, out
    assert out["metrics"]["train_host_syncs"] == 2.0
