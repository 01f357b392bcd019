"""The harness is driven by data: every cell resolves to its files by
name, an added cell and metric take effect with no file edited, the
traffic repeats for a seed, and a run without a card stops."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from benchmark import harness as H
from benchmark.traffic import ActionStream, EpisodeSeeds, Reservoir

SPEC = json.loads((H.ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_resolves(name):
    cell = H.find_cell(name)
    assert cell.config["name"] == cell.entry["config"]
    assert (H.BENCH_DIR / "drivers" / f"{cell.config['driver']}.py").exists()
    H.driver_module(cell.config["driver"])
    assert cell.end_to_end and cell.per_layer
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    for m in cell.end_to_end + cell.per_layer:
        assert callable(H.reader(m["name"]).read)
    for m in cell.per_layer:
        assert m["moves"] in [e["name"] for e in cell.end_to_end]
    assert set(cell.traffic["check"]["limits"])


def test_added_cell_and_metric_found_by_name(tmp_path):
    root = tmp_path
    shutil.copytree(H.BENCH_DIR / "configs", root / "benchmark" / "configs")
    shutil.copytree(H.BENCH_DIR / "traffic", root / "benchmark" / "traffic")
    (root / "benchmark" / "metrics").mkdir()
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "fr3_align_loop.e8",
                              "config": "fr3_align_loop", "traffic": "e8",
                              "chips": 1, "why": "a test cell"})
    spec["per_layer"].append({"name": "steps_seen.test", "unit": "steps",
                              "better": "higher", "source": "host_clock",
                              "layer": "Closed-loop entry",
                              "moves": "env_steps_per_s",
                              "workloads": ["fr3_align_loop.e8"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    traffic = json.loads((H.BENCH_DIR / "traffic" / "e64.json").read_text())
    traffic["num_envs"] = 8
    (root / "benchmark" / "traffic" / "e8.json").write_text(
        json.dumps(traffic))
    (root / "benchmark" / "metrics" / "steps_seen.test.py").write_text(
        "def read(rec):\n    return len(rec.calls) or None\n")
    cell = H.find_cell("fr3_align_loop.e8", root=root)
    assert cell.traffic["num_envs"] == 8
    assert [m["name"] for m in cell.per_layer][-1] == "steps_seen.test"
    assert "steps_seen.test" not in [
        m["name"] for m in H.find_cell("fr3_align_loop.e1", root).per_layer]
    rec = H.Record(cell=cell, seed=1, calls=[0.1, 0.2, 0.3])
    assert H.reader("steps_seen.test", root).read(rec) == 3
    rec.calls = []
    assert H.reader("steps_seen.test", root).read(rec) is None


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 11, 2 ** 40 + 3])
def test_actions_repeat_for_a_seed(seed):
    traffic = {"num_envs": 3, "actions": {"low": -1.0, "high": 1.0}}
    a = [ActionStream(seed, traffic, 8).next() for _ in range(2)]
    s = ActionStream(seed, traffic, 8)
    b = [s.next(), s.next()]
    assert a[0].shape == (3, 8) and a[0].dtype == np.float32
    assert np.array_equal(a[0], b[0]) and not np.array_equal(b[0], b[1])
    assert (b[0] >= -1).all() and (b[0] < 1).all()
    other = ActionStream(seed + 1, traffic, 8).next()
    assert not np.array_equal(other, b[0])
    e, f = EpisodeSeeds(seed), EpisodeSeeds(seed)
    assert [e.next(), e.next()] == [f.next(), f.next()]


def test_reservoir_repeats_and_keeps_k():
    def take(seed):
        r = Reservoir(3, seed)
        for i in range(100):
            r.offer(lambda i=i: i)
        return r.items
    assert take(5) == take(5) and len(take(5)) == 3
    assert take(5) != take(6)


def test_run_without_a_card_stops():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "fr3_align_loop.e1", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=H.ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr
