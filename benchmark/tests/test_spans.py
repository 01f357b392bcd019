"""``benchmark/spans.py`` and its readers: the reductions on synthetic
recordings (steps, launches, stamps and counters made by hand), a
stretch of the tiny cells on the CPU, and a program without the
recording, whose runs read nothing and raise nothing."""

import json

import pytest

from benchmark import harness as H
from benchmark import spans
from benchmark.tests.tiny import tiny_cell, tiny_train_cell
from gsworld_tpu_torch.utils import profiling as P

MS = 1_000_000
G0 = 3 * 10 ** 12          # the device clock at the entry anchor
LOOP = ("loop.begin", "loop.physics|render", "loop.end")
TRAIN = ("train.begin", "train.forward|backward", "train.backward|update",
         "train.end")
NEW = ["loop_launch_ms", "loop_between_ms", "loop_host_syncs",
       "loop_physics_ms", "loop_render_ms"]
NEW_ALL = NEW + [m + ".e1" for m in NEW] + [
    "train_forward_ms", "train_backward_ms", "train_update_ms",
    "train_between_ms", "train_host_syncs"]


def _ring(stamps, first):
    import numpy as np
    ring = np.zeros(P.RING_WORDS, np.int64)
    for k, (tag, ns) in enumerate(stamps):
        i = 2 + 2 * ((first + k) % P.RING_SLOTS)
        ring[i] = ((first + k) << 8) | P.STAMP_TAGS.index(tag)
        ring[i + 1] = ns
    ring[0] = first + len(stamps)
    return ring


def _recording(spans_, stamps, end_ms):
    """A recording of host ``spans_`` [(name, start ms, end ms, parent
    seq)] and device ``stamps`` [(tag, ms)] between an anchor at 0 and
    one at ``end_ms``, the device clock at G0 + its host time."""
    rec = P.Recording()
    rec.spans = [P.SpanRecord(n, int(a * MS), int(b * MS), p, i)
                 for i, (n, a, b, p) in enumerate(spans_)]
    all_ = [("anchor", G0)] + [(t, G0 + int(x * MS)) for t, x in stamps] \
        + [("anchor", G0 + int(end_ms * MS))]
    rec.first_slot = 100
    rec.take_ring(_ring(all_, 100))
    rec.anchor_windows = [(100, -500, 500),
                          (100 + len(all_) - 1, int(end_ms * MS) - 500,
                           int(end_ms * MS) + 500)]
    return rec


def _loop_recording(n, period=10.0, physics=3.0, render=5.0, launch=0.5,
                    lost=0):
    """n steps of ``period`` ms: each a gsw.step span with a launch span
    at +1 ms, its graph beginning at +1.5 ms; the last ``lost`` stamps
    left out."""
    host, stamps = [], []
    for k in range(n):
        t = k * period
        seq = len(host)
        host.append(("gsw.step", t, t + 9.9, -1))
        host.append(("gsw.step.launch", t + 1, t + 1 + launch, seq))
        b = t + 1.5
        stamps += [(LOOP[0], b), (LOOP[1], b + physics),
                   (LOOP[2], b + physics + render)]
    return _recording(host, stamps[:len(stamps) - lost], n * period + 1)


def test_loop_readings_of_a_synthetic_stretch():
    rec = _loop_recording(6)
    kept = [False, True, True, False, False, True]
    deltas = [{"host.sync/action_copy": 1,
               "graph.replays/the closed-loop step": 1}] * 6
    out = spans.loop_readings(rec, kept, deltas)
    m = out["metrics"]
    assert m["loop_launch_ms"] == pytest.approx(0.5)
    assert m["loop_physics_ms"] == pytest.approx(3.0)
    assert m["loop_render_ms"] == pytest.approx(5.0)
    assert m["loop_between_ms"] == pytest.approx(2.0)
    assert m["loop_host_syncs"] == 1.0
    n = out["notes"]
    assert n["kept"] == 3 and n["stamps_lost"] == 0
    assert n["graph_replays_per_step"] == {"the closed-loop step": 1.0}
    assert n["host_period_ms"] == pytest.approx(10.0)
    assert abs(n["period_gap_pct"]) < 1e-6
    # each graph begins 0.5 ms after its launch and ends 0.5 ms before
    # the host's next step
    assert n["causal_margin_us"] == pytest.approx([500.0, 500.0])
    # the gaps' midpoints lie where the host is in its step, before the
    # launch; each gap (-0.5 to 1.5 ms of a step) covers 0.4 ms of the
    # step before, 0.1 ms outside every span, 1 ms of the step and 0.5 ms
    # of its launch
    mid, cov = n["gaps"]["midpoint"], n["gaps"]["covered"]
    assert list(mid) == ["gsw.step"] and mid["gsw.step"][0] == 3
    assert cov == pytest.approx({"gsw.step": 3 * 1.4,
                                 "gsw.step.launch": 3 * 0.5,
                                 "outside every span": 3 * 0.1})


def test_loop_readings_drop_a_stretch_that_captured_or_lost_stamps():
    rec = _loop_recording(4)
    rec.counters_before = {}
    rec.counters_after = {"graph.captures/the closed-loop step": 1}
    assert spans.loop_readings(rec, [True] * 4, [{}] * 4)["metrics"] == {}
    # stamps that never came (the last 3) leave the device metrics out
    rec = _loop_recording(4, lost=3)
    m = spans.loop_readings(rec, [True] * 4, [{}] * 4)["metrics"]
    assert "loop_physics_ms" not in m and "loop_launch_ms" in m
    # stamps the ring lost to overrun (stamps/lost) leave out every metric
    n = P.RING_SLOTS // 3 + 2
    rec = _loop_recording(n)
    out = spans.loop_readings(rec, [True] * n, [{}] * n)
    assert out["metrics"] == {} and out["notes"]["stamps_lost"] > 0


def test_train_readings_of_a_synthetic_stretch():
    iters, skip = 8, 3
    host, stamps = [], []
    # iteration 1 also runs two eager warm-up steps
    for k in range(iters):
        t = 10.0 * k
        seq = len(host)
        host.append(("gsw.train.iter", t, t + 9.0, -1))
        host.append(("gsw.train.launch", t + 1, t + 1.2, seq))
        if k == 0:
            stamps += [(tag, b + 0.1 * i) for b in (0.1, 0.6)
                       for i, tag in enumerate(TRAIN)]
        b = t + 1.5
        stamps += [(TRAIN[0], b), (TRAIN[1], b + 2), (TRAIN[2], b + 4.5),
                   (TRAIN[3], b + 5.5)]
    rec = _recording(host, stamps, 10.0 * iters)
    counts = {"host.sync/loss_read": 5, "host.sync/pinned_alloc": 5,
              "graph.replays/the train step": 5}
    m = spans.train_readings(rec, counts, iters, skip)["metrics"]
    assert m == pytest.approx({
        "train_forward_ms": 2.0, "train_backward_ms": 2.5,
        "train_update_ms": 1.0, "train_between_ms": 4.5,
        "train_host_syncs": 2.0})
    notes = spans.train_readings(rec, counts, iters, skip)["notes"]
    assert notes["causal_margin_us"] == pytest.approx([500.0, 3000.0])
    assert notes["graph_replays_per_iter"] == {"the train step": 1.0}
    counts["graph.captures/the train step"] = 1
    assert spans.train_readings(rec, counts, iters, skip)["metrics"] == {}


class _Rec:
    def __init__(self, driver, trace=True):
        self.driver, self.trace, self.notes = driver, trace, {}


def test_readers_take_their_values_from_the_cached_readings():
    rec = _Rec(None)
    rec.notes["spans"] = {"loop_launch_ms": 1.5, "train_update_ms": 0.25}
    assert H.reader("loop_launch_ms").read(rec) == 1.5
    assert H.reader("loop_launch_ms.e1").read(rec) == 1.5
    assert H.reader("train_update_ms").read(rec) == 0.25
    for name in NEW_ALL:
        if name not in ("loop_launch_ms", "loop_launch_ms.e1",
                        "train_update_ms"):
            assert H.reader(name).read(rec) is None


def test_new_metrics_are_additions_with_their_cells():
    spec = json.loads((H.ROOT / "BENCHMARK.json").read_text())
    by_name = {m["name"]: m for m in spec["per_layer"]}
    assert [m["name"] for m in spec["per_layer"][-len(NEW_ALL):]] == NEW_ALL
    for name in NEW_ALL:
        m = by_name[name]
        cell = ("fr3_align_3dgs.train" if name.startswith("train")
                else "fr3_align_loop.e1" if name.endswith(".e1")
                else "fr3_align_loop.e64")
        assert m["workloads"] == [cell]
        assert m["source"] in ("host_clock", "device_trace")


def test_tiny_loop_stretch_on_the_cpu():
    cell = tiny_cell("fr3_align_loop.e64", num_envs=2)
    cell.traffic["episode_steps"] = 3
    d = H.driver_module("closed_loop").Driver(cell, 2 ** 31 + 5,
                                              device="cpu")
    d.setup()
    out = spans.measure(d, P, steps=5)
    # steps 0 and 3 follow a reset, step 2 precedes one: 1 and 4 are kept
    assert out["notes"]["kept"] == 2 and out["notes"]["steps"] == 5
    # the CPU waits for nothing, replays no graph and stamps nothing
    assert out["metrics"] == {"loop_host_syncs": 0.0}
    # a run on the CPU reads nothing, as a run without a traced window
    for trace in (None, True):
        rec = _Rec(d, trace)
        assert spans.readings(rec) == {} and rec.notes["spans"] == {}


def test_a_loop_stretch_without_a_count_runs_for_its_seconds(monkeypatch):
    cell = tiny_cell("fr3_align_loop.e64", num_envs=2)
    d = H.driver_module("closed_loop").Driver(cell, 2 ** 31 + 6,
                                              device="cpu")
    d.setup()
    # no time at all: MIN_STEPS steps
    monkeypatch.setattr(spans, "STRETCH_S", 0.0)
    monkeypatch.setattr(spans, "MIN_STEPS", 3)
    assert spans.measure(d, P, record=False)["notes"]["steps"] == 3
    # all the time there is: as many as the stamp ring holds
    monkeypatch.setattr(spans, "STRETCH_S", 1e9)
    monkeypatch.setattr(P, "RING_SLOTS", 2 + 4 * spans.STAMPS_PER_STEP)
    assert spans.measure(d, P, record=False)["notes"]["steps"] == 4


def test_readings_come_from_a_fresh_process(monkeypatch):
    asked = []

    def child(cell, seed):
        asked.append((cell, seed))
        return {"loop_launch_ms": 0.25}
    monkeypatch.setattr(spans, "in_fresh_process", child)

    class D:
        device = type("dev", (), {"type": "cuda"})()
        cell = type("cell", (), {"name": "fr3_align_loop.e1"})()
    rec = _Rec(D())
    rec.seed = 2 ** 31 + 9
    assert H.reader("loop_launch_ms.e1").read(rec) == 0.25
    assert H.reader("loop_between_ms.e1").read(rec) is None
    assert asked == [("fr3_align_loop.e1", 2 ** 31 + 9)]


def test_a_failed_child_reads_nothing(capsys):
    assert spans.in_fresh_process("no_such_cell", 1) == {}
    assert "no cell 'no_such_cell'" in capsys.readouterr().err


def test_tiny_train_stretch_on_the_cpu():
    d = H.driver_module("train_3dgs").Driver(tiny_train_cell(), 2 ** 31 + 5,
                                             device="cpu")
    d.setup()
    out = spans.train_stretch(d, P, iters=5, skip=2)
    assert out["metrics"] == {"train_host_syncs": 0.0}
    assert out["notes"]["iters"] == 3


def test_a_program_without_the_recording_reads_nothing(monkeypatch):
    monkeypatch.delattr(P, "recording")
    assert spans.profiling() is None

    class D:
        device = type("dev", (), {"type": "cuda"})()
    rec = _Rec(D())
    for name in NEW_ALL:
        assert H.reader(name).read(rec) is None
    assert rec.notes["spans"] == {}
