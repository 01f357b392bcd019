"""The port's recording (``utils/profiling.py``) on the CPU: host spans
(nesting, parents, sequence ids, the profiler's ranges), the pairing of
device stamps and their anchor on synthetic ``(tag, ns)`` arrays, the
counter registry, and the spans and counters of ``GSWorldWrapper.step``
and ``train`` under ``recording()``.  The stamps themselves run on a
card only (``benchmark/tests/test_stamps_on_card.py``)."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gsworld_tpu_torch.gs.model import scene_from_splats
from gsworld_tpu_torch.gs.synthetic import make_blob
from gsworld_tpu_torch.render import rasterize_cuda
from gsworld_tpu_torch.render.camera import RasterConfig, make_camera
from gsworld_tpu_torch.utils import profiling as P
from torch_physics_common import one_torch_thread  # noqa: F401 (autouse)


def _tree(rec):
    by_seq = {s.seq: s for s in rec.spans}
    return sorted((s.seq, s.name, by_seq[s.parent].name if s.parent >= 0
                   else None) for s in rec.spans)


def test_spans_nest_with_parents_and_sequence_ids():
    with P.recording() as rec:
        with P.span("a"):
            with P.span("b"):
                pass
            with P.span("c"):
                with P.span("d"):
                    pass
        with P.span("e"):
            pass
    assert _tree(rec) == [(0, "a", None), (1, "b", "a"), (2, "c", "a"),
                          (3, "d", "c"), (4, "e", None)]
    s = {x.name: x for x in rec.spans}
    assert s["a"].start_ns <= s["b"].start_ns <= s["b"].end_ns \
        <= s["c"].start_ns <= s["d"].end_ns <= s["c"].end_ns <= s["a"].end_ns
    assert rec.dropped == 0 and rec.device_spans() == []


def test_span_list_is_bounded_and_drops_are_counted():
    with P.recording() as rec:
        rec.limit = 3
        for _ in range(5):
            with P.span("x"):
                pass
    assert len(rec.spans) == 3 and rec.dropped == 2
    assert [s.seq for s in rec.spans] == [0, 1, 2]


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    opened = []
    monkeypatch.setattr(P._autograd_profiler, "record_function",
                        lambda name: opened.append(name))
    assert P.span("gsw.x") is P._NO_SPAN
    with P.span("gsw.x"):
        pass
    assert opened == [] and P._State.active is None


@pytest.mark.parametrize("recorded", [False, True])
def test_ranges_present_while_a_profiler_runs(recorded):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if recorded:
            with P.recording() as rec:
                with P.span("gsw.outer"):
                    with P.span("gsw.inner"):
                        torch.ones(4).sum()
            assert [s.name for s in rec.spans] == ["gsw.inner", "gsw.outer"]
        else:
            with P.span("gsw.outer"):
                with P.span("gsw.inner"):
                    torch.ones(4).sum()
    names = [e.name for e in prof.events()]
    assert names.count("gsw.outer") == 1 and names.count("gsw.inner") == 1
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(4).sum()
    assert P.span("gsw.outer") is P._NO_SPAN
    assert "gsw.outer" not in [e.name for e in prof.events()]


def test_one_recording_at_a_time():
    with P.recording():
        with pytest.raises(RuntimeError):
            with P.recording():
                pass
    assert P._State.active is None


def test_launch_counts_are_a_registry_group():
    group = P.counters.groups["kernel_launches"]
    assert rasterize_cuda.launch_counts is group
    rasterize_cuda.reset_launch_counts()
    rasterize_cuda.launch_counts["emit_entries"] += 2
    snap = P.counters.snapshot()
    assert snap["kernel_launches/emit_entries"] == 2
    assert snap["kernel_launches/composite_tiles"] == 0
    rasterize_cuda.reset_launch_counts()
    assert P.counters.snapshot()["kernel_launches/emit_entries"] == 0


def test_counters_move_inside_a_recording():
    with P.recording() as rec:
        P.count("graph.replays", "a test graph", 3)
        P.host_waits("a test site", torch.device("cuda"))
        P.host_waits("a test site", torch.device("cpu"))
        assert rec.counts()["graph.replays/a test graph"] == 3
    P.count("graph.replays", "a test graph")
    assert rec.counts() == {"graph.replays/a test graph": 3,
                            "host.sync/a test site": 1}
    assert P.since({"x/y": 1}, {"x/y": 1, "x/z": 2}) == {"x/z": 2}


def _ring(stamps, first_seq=0):
    """A ring as the card leaves it after ``stamps`` (tag, ns) with
    sequence numbers from ``first_seq``."""
    ring = np.zeros(P.RING_WORDS, np.int64)
    for k, (tag, ns) in enumerate(stamps):
        n = first_seq + k
        i = 2 + 2 * (n % P.RING_SLOTS)
        ring[i] = (n << 8) | P.STAMP_TAGS.index(tag)
        ring[i + 1] = ns
    ring[0] = first_seq + len(stamps)
    return ring


LOOP = ["loop.begin", "loop.physics|render", "loop.end"]


def test_ring_entries_in_order_from_the_first():
    stamps = [("anchor", 5)] + [(t, 10 * (i + 1)) for i, t in
                                enumerate(LOOP * 2)] + [("anchor", 99)]
    e = P.ring_entries(_ring(stamps, first_seq=40), 40)
    assert e.tags == [t for t, _ in stamps] and e.lost == 0
    assert list(e.ns) == [ns for _, ns in stamps]
    assert list(e.slots) == list(range(40, 40 + len(stamps)))
    # read from a later sequence number on: the older ones are left out
    assert P.ring_entries(_ring(stamps, 40), 42).tags == \
        [t for t, _ in stamps[2:]]


def test_ring_overrun_keeps_the_newest_and_counts_the_lost():
    n = P.RING_SLOTS + 7
    stamps = [(LOOP[i % 3], 1000 + i) for i in range(n)]
    e = P.ring_entries(_ring(stamps), 0)
    assert e.lost == 7 and len(e.tags) == P.RING_SLOTS
    assert list(e.ns) == [1000 + i for i in range(7, n)]
    assert e.tags[0] == LOOP[7 % 3]
    bad = _ring(stamps)
    bad[2] = 0                         # an entry of another sequence
    with pytest.raises(RuntimeError):
        P.ring_entries(bad, 0)


def test_a_recording_counts_the_stamps_its_ring_lost():
    n = P.RING_SLOTS + 5
    stamps = [(LOOP[i % 3], 1000 + i) for i in range(n)]
    with P.recording() as rec:
        pass
    before = P.counters.snapshot().get("stamps/lost", 0)
    rec.take_ring(_ring(stamps))
    assert rec.entries.lost == 5 and len(rec.entries.tags) == P.RING_SLOTS
    assert rec.counts() == {"stamps/lost": 5}
    assert P.counters.snapshot()["stamps/lost"] == before + 5
    rec = P.Recording()
    rec.take_ring(_ring(stamps[:20]))
    assert rec.entries.lost == 0 and "stamps/lost" not in rec.counts()
    rec = P.Recording()
    rec.take_ring(None)
    assert rec.entries.tags == [] and rec.device_spans() == []


def test_pair_stamps_names_the_device_spans():
    tags = ["anchor"] + LOOP * 2 + ["train.begin", "anchor"]
    ns = [0, 10, 30, 70, 100, 130, 170, 200, 300]
    assert P.pair_stamps(tags, ns) == [
        ("loop.physics", 10, 30), ("loop.render", 30, 70),
        ("loop.between", 70, 100), ("loop.physics", 100, 130),
        ("loop.render", 130, 170), ("loop.end..train.begin", 170, 200)]
    train = ["train.begin", "train.forward|backward",
             "train.backward|update", "train.end", "train.begin"]
    assert [n for n, _, _ in P.pair_stamps(train, range(5))] == [
        "train.forward", "train.backward", "train.update", "train.between"]


def test_anchor_places_device_times_on_the_host_clock():
    # the device clock runs from 1e12 at 1 + 20e-6 of the host's rate
    rate = 1.0 / (1.0 + 20e-6)
    g = [10 ** 12, 10 ** 12 + 2 * 10 ** 9]
    h = [5 * 10 ** 9, 5 * 10 ** 9 + round((g[1] - g[0]) * rate)]
    anchors = [(g[0], h[0] - 4000, h[0] + 4000),
               (g[1], h[1] - 10000, h[1] + 10000)]
    to_host, err = P.anchor_map(anchors)
    assert err == 10000
    mid = g[0] + 10 ** 9
    assert abs(to_host(mid) - (h[0] + 10 ** 9 * rate)) <= 1
    to_host1, err1 = P.anchor_map(anchors[:1])
    assert err1 == 4000 and to_host1(mid) == h[0] + 10 ** 9
    # anchors too close for their error keep the rate at 1
    close = [(g[0], 0, 8000), (g[0] + 100, 100, 8100)]
    assert P.anchor_map(close)[0](g[0] + 50) == 4050
    with pytest.raises(ValueError):
        P.anchor_map([])


def test_device_spans_and_gaps_of_a_synthetic_recording():
    rec = P.Recording()
    # host: two steps, each with its launch; each step graph begins 1 ms
    # after its launch
    ms = 1_000_000
    rec.spans = [P.SpanRecord("gsw.step.launch", 1 * ms, 2 * ms, 0, 1),
                 P.SpanRecord("gsw.step", 0, 9 * ms, -1, 0),
                 P.SpanRecord("gsw.step.launch", 11 * ms, 12 * ms, 2, 3),
                 P.SpanRecord("gsw.step", 10 * ms, 19 * ms, -1, 2)]
    g0 = 7 * 10 ** 12
    stamps = [("anchor", g0)] + [
        (t, g0 + x * ms) for t, x in zip(LOOP * 2, (2, 5, 9, 12, 15, 19))] \
        + [("anchor", g0 + 30 * ms)]
    rec.entries = P.ring_entries(_ring(stamps, 3), 3)
    rec.anchor_windows = [(3, -1000, 1000), (10, 30 * ms - 1000,
                                             30 * ms + 1000)]
    dev = rec.device_spans()
    assert [(d.name, d.start_ns // ms, d.end_ns // ms) for d in dev] == [
        ("loop.physics", 2, 5), ("loop.render", 5, 9),
        ("loop.between", 9, 12), ("loop.physics", 12, 15),
        ("loop.render", 15, 19)]
    assert rec.anchor_error_ns == 1000
    gaps = rec.attribute_gaps()
    assert len(gaps) == 1 and gaps[0].span.name == "loop.between"
    # the midpoint, 10.5 ms, lies in the second step before its launch
    assert gaps[0].host == "gsw.step"
    assert P.innermost(rec.spans, int(11.5 * ms)) == "gsw.step.launch"
    assert P.innermost(rec.spans, int(9.5 * ms)) == "outside every span"


def _loop():
    import dataclasses
    from gsworld_tpu_torch import envs
    from gsworld_tpu_torch.wrapper.gs_env import GSWorldWrapper
    env = envs.make("AlignFr3Env-v1", num_envs=2,
                    obs_mode="rgb+segmentation", device="cpu")
    env.cameras = [dataclasses.replace(c, width=160, height=120)
                   for c in env.cameras]
    w = GSWorldWrapper(env, "fr3_align", raster_config=RasterConfig(
        width=160, height=120, max_entries=16384),
        synthetic_sizes=dict(n_background=2400, n_per_link=120,
                             n_per_object=120), device="cpu")
    w.reset(seed=3)
    return env, w


def test_wrapper_step_spans_and_counters(monkeypatch):
    env, w = _loop()
    waits = []
    real = P.host_waits
    monkeypatch.setattr(P, "host_waits",
                        lambda site, dev: (waits.append((site, dev)),
                                           real(site, dev)))
    import gsworld_tpu_torch.envs.base as base
    monkeypatch.setattr(base, "host_waits", P.host_waits)
    action = env.action_space_sample()
    with P.recording() as rec:
        w.step(action)                    # a tensor on the env's device
        w.step(action.numpy())            # host memory: copied
    assert _tree(rec) == [(0, "gsw.step", None),
                          (1, "gsw.step.action", "gsw.step"),
                          (2, "gsw.step", None),
                          (3, "gsw.step.action", "gsw.step")]
    assert waits == [("action_copy", env.device)]
    # the CPU waits for nothing: no host.sync, no graph, no stamp
    assert rec.counts() == {} and rec.device_spans() == []


def test_train_spans_and_counters(monkeypatch):
    from gsworld_tpu_torch.train3dgs import train as ttrain
    waits = []
    monkeypatch.setattr(ttrain, "host_waits",
                        lambda site, dev: waits.append((site, dev.type)))
    cfg = RasterConfig(width=48, height=48)
    w2c = torch.eye(4)
    w2c[2, 3] = 2.0
    cam = make_camera(w2c, 0.5, 0.5)
    truth = scene_from_splats(make_blob(np.random.default_rng(8), 120,
                                        [0, 0, 0], 0.4, [0.7, 0.3, 0.2], 0,
                                        log_scale_mean=-2.5), device="cpu")
    with torch.no_grad():
        target = ttrain.render_trainable(truth, torch.zeros(120, 2), cam,
                                         cfg)[0]
    with P.recording() as rec:
        ttrain.train(truth, [cam], [target], cfg, None, 128, 0, 3.0,
                     iterations=3)
    assert _tree(rec) == [(0, "gsw.train.iter", None),
                          (1, "gsw.train.loss_read", "gsw.train.iter"),
                          (2, "gsw.train.iter", None),
                          (3, "gsw.train.loss_read", "gsw.train.iter"),
                          (4, "gsw.train.iter", None),
                          (5, "gsw.train.loss_read", "gsw.train.iter")]
    assert waits == [("loss_read", "cpu")] * 3
    assert rec.counts() == {} and rec.device_spans() == []
