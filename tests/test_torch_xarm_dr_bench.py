"""The benchmark's xArm6 domain-randomized cell (``xarm6_align_dr.dr64``)
on the CPU at the tiny cells' size (2 envs, 160x120): the run's check
against the reference (``benchmark/reference/closed_loop_dr.py``) with the
randomization on in both sides' states, the check failing once the
program's render drops the tint or the camera noise, the reset's spans
and the ``dr.draws`` counter, the pairing of the reset's device stamps,
and the reference's new modules importing nothing of JAX or the port."""

import json
import subprocess
import sys
import types

import pytest
import torch

from benchmark import harness as H
from benchmark import reset_spans, spans
from benchmark.drivers import closed_loop
from benchmark.reference.closed_loop import leaves
from benchmark.run import run_cell
from benchmark.tests.test_spans import _recording
from benchmark.tests.tiny import tiny_cell
from gsworld_tpu_torch.utils import profiling as P
from gsworld_tpu_torch.wrapper import gs_env

CELL = "xarm6_align_dr.dr64"
SEED = 2 ** 31 + 1801
DR_LEAVES = ("task.obj_color", "task.cam_pose_noise", "world.a_friction",
             "world.a_scale")
# per env: friction, scale and 3 colour channels for each of the 2 actors,
# 3 offsets and 3 rotations for each of the 2 cameras
DRAWS_PER_ENV = 5 * 2 + 6 * 2


def _clock(monkeypatch, tick=0.1):
    """The loop driver's clock advances ``tick`` seconds a reading, so a
    window of 1 s runs 3 steps whatever the machine's speed."""
    t = [0.0]

    def perf_counter():
        t[0] += tick
        return t[0]
    monkeypatch.setattr(closed_loop, "time",
                        types.SimpleNamespace(perf_counter=perf_counter))


def _run(monkeypatch):
    """One run of the tiny cell through ``run_cell`` -> (result, checks,
    the samples compared, the reference)."""
    _clock(monkeypatch)
    seen = {}
    real = closed_loop.compare

    def compare(samples, envs, ref, control=None):
        seen.update(samples=samples, envs=envs, ref=ref)
        return real(samples, envs, ref, control)
    monkeypatch.setattr(closed_loop, "compare", compare)
    result, checks = run_cell(tiny_cell(CELL, num_envs=2), SEED, 1.0, False,
                              device="cpu")
    return result, checks, seen


def test_cell_is_correct_with_the_randomization_on_both_sides(monkeypatch):
    result, checks, seen = _run(monkeypatch)
    assert result["correct"] is True, checks
    assert result["attempted"] == 3 and result["failed"] == 0
    kinds = [s.kind for s in seen["samples"]]
    assert kinds.count("reset") >= 1 and kinds.count("step") >= 2, kinds
    reset = next(s for s in seen["samples"] if s.kind == "reset")
    ref_state = seen["ref"].run(reset, seen["envs"])["state"]
    for side in (leaves(reset.after), leaves(ref_state)):
        assert set(DR_LEAVES) <= set(side)
        assert side["task.cam_pose_noise"].shape == (2, 2, 6)
        assert bool((side["task.cam_pose_noise"] != 0).all())
        assert bool((side["world.a_scale"] != 1).all())
        assert not torch.equal(side["world.a_friction"][0],
                               side["world.a_friction"][1])
    for s in seen["samples"]:
        assert set(DR_LEAVES) <= set(leaves(s.after))


def test_reference_renders_the_sampled_envs_from_the_whole_batch():
    """The reference's first half over every env, then the sampled rows:
    on the CPU the same frames as a render of those envs alone."""
    import dataclasses

    from benchmark.reference.closed_loop_dr import render_sampled
    from benchmark.reference.gsw.wrapper.gs_env import world_poses
    d = _driver(CELL, num_envs=3)
    ref = d.reference_loop()
    state = ref.env._reset_layout(*ref.env.reset_draws(SEED))
    poses = world_poses(state.world, state.task)
    assert poses.obj_color is not None and poses.cam_pose_noise is not None
    idx = torch.tensor([2, 0])
    sub = type(poses)(**{f.name: getattr(poses, f.name)[idx]
                         for f in dataclasses.fields(poses)})
    got = render_sampled(ref.wrapper.renderer, poses, idx)
    want = ref.wrapper.renderer.render(sub)
    assert sorted(got) == sorted(want) == ["right_cam", "wrist_cam"]
    for cam in want:
        for k in ("rgb", "segmentation"):
            assert got[cam][k].shape[0] == 2
            assert torch.equal(got[cam][k], want[cam][k]), (cam, k)


_world_poses = gs_env.world_poses


def _no_tint(self, obj_color):
    return None


def _no_camera_noise(world, task=None):
    task = {k: v for k, v in (task or {}).items() if k != "cam_pose_noise"}
    return _world_poses(world, task)


@pytest.mark.parametrize("fault", ["tint", "camera_noise"])
def test_check_fails_without_the_programs_randomized_render(monkeypatch,
                                                            fault):
    """The program renders without the tint or the camera noise; its
    state keeps them, so only the frames can tell."""
    if fault == "tint":
        monkeypatch.setattr(gs_env.GSWorldRenderer, "slot_tint", _no_tint)
    else:
        monkeypatch.setattr(gs_env, "world_poses", _no_camera_noise)
    result, checks, _ = _run(monkeypatch)
    got = {name: value for name, value, _ in checks}
    assert result["correct"] is False, checks
    assert got["state_gap"] == 0.0
    assert got["rgb_off_pct"] > 0.02 or got["rgb_mae"] > 0.02


def _driver(name, num_envs=2):
    d = H.driver_module(H.find_cell(name).config["driver"]).Driver(
        tiny_cell(name, num_envs=num_envs), SEED, device="cpu")
    d.setup()
    return d


@pytest.mark.parametrize("name,draws", [(CELL, 2 * DRAWS_PER_ENV),
                                        ("fr3_align_loop.e64", 0)])
def test_reset_spans_and_draws_on_the_cpu(name, draws):
    d = _driver(name)
    with P.recording() as rec:
        d.reset(keep=False)
    by_seq = {s.seq: s for s in rec.spans}
    tree = sorted((s.seq, s.name, by_seq[s.parent].name if s.parent >= 0
                   else None) for s in rec.spans)
    assert tree == [(0, "gsw.reset", None),
                    (1, "gsw.reset.layout", "gsw.reset"),
                    (2, "gsw.reset.launch", "gsw.reset")]
    moved = sum(v for k, v in rec.counts().items()
                if k.startswith("dr.draws/"))
    assert moved == draws
    out = reset_spans.reset_stretch(d, P, resets=3)
    assert out["notes"]["dr_draws_per_reset"] == draws
    # the CPU stamps nothing: the host layout alone is read
    assert set(out["metrics"]) == {"loop_reset_layout_ms"}


@pytest.mark.parametrize("resets", [1, 2])
def test_reset_stamps_pair_into_the_reset_and_keep_the_steps_between(
        resets):
    """The steps' ``loop.between`` runs from the first step's end to the
    next one's begin, over the resets between them."""
    loop = ["loop.begin", "loop.physics|render", "loop.end"]
    tags = loop + ["reset.begin", "reset.end"] * resets + loop
    pairs = P.pair_stamps(tags, range(len(tags)))
    names = [n for n, _, _ in pairs]
    assert names == (["loop.physics", "loop.render", "loop.end..reset.begin"]
                     + ["loop.reset", "reset.end..reset.begin"] * (resets - 1)
                     + ["loop.reset", "reset.end..loop.begin", "loop.between",
                        "loop.physics", "loop.render"])
    assert [p for p in pairs if p[0] == "loop.between"] == [
        ("loop.between", 2, 3 + 2 * resets)]
    # an anchor inside the gap leaves it unpaired
    cut = loop + ["reset.begin", "anchor", "reset.end"] + loop
    assert "loop.between" not in [n for n, _, _ in
                                  P.pair_stamps(cut, range(len(cut)))]


def test_loop_readings_keep_every_metric_across_a_reset():
    """A stretch of 6 steps of 10 ms with a reset (its graph 4 ms) before
    step 3 reads every loop metric, as one without the reset's stamps."""
    host, stamps = [], []
    for k in range(6):
        t = 10.0 * k + (6.0 if k >= 3 else 0.0)
        if k == 3:
            host.append(("gsw.reset", t - 6.0, t - 0.5, -1))
            stamps += [("reset.begin", t - 5.0), ("reset.end", t - 1.0)]
        seq = len(host)
        host.append(("gsw.step", t, t + 9.9, -1))
        host.append(("gsw.step.launch", t + 1, t + 1.5, seq))
        stamps += [("loop.begin", t + 1.5), ("loop.physics|render", t + 4.5),
                   ("loop.end", t + 9.5)]
    rec = _recording(host, stamps, 70.0)
    kept = [False, True, False, False, True, True]
    m = spans.loop_readings(rec, kept, [{}] * 6)["metrics"]
    assert set(m) == {"loop_launch_ms", "loop_between_ms", "loop_host_syncs",
                      "loop_physics_ms", "loop_render_ms"}
    assert m["loop_physics_ms"] == pytest.approx(3.0)
    assert m["loop_render_ms"] == pytest.approx(5.0)
    assert m["loop_between_ms"] == pytest.approx(2.0)
    dev = rec.device_spans()
    assert [d.name for d in dev].count("loop.reset") == 1
    between = [d.end_ns - d.start_ns for d in dev if d.name == "loop.between"]
    # the third holds the reset: step 2's end to step 3's begin
    assert between == pytest.approx([2e6, 2e6, 8e6, 2e6, 2e6], rel=1e-3)


def test_reset_readers_read_nothing_without_the_programs_reset():
    class _Rec:
        driver, trace, seed, notes = None, True, SEED, {}
    rec = _Rec()
    for name in ("loop_reset_ms", "loop_reset_layout_ms"):
        assert H.reader(name).read(rec) is None
    # a stretch of a program without the reset's spans reads nothing
    out = reset_spans.reset_readings(P.Recording(), 8)
    assert out["metrics"] == {}


def test_config_states_the_envs_randomization():
    from benchmark.reference.gsw.envs.tasks import real_xarm as ref
    from gsworld_tpu_torch.envs.tasks import real_xarm
    cfg = H.find_cell(CELL).config
    assert cfg["env_kwargs"] == {"domain_randomization": True}
    for dr in (real_xarm.SO100GraspCubeDomainRandomizationConfig(),
               ref.SO100GraspCubeDomainRandomizationConfig()):
        for k, v in cfg["domain_randomization"].items():
            want = getattr(dr, k)
            assert (list(want) if isinstance(want, tuple) else want) == v, k


REFERENCE_MODULES = """
import importlib, json, pkgutil, sys
import benchmark.reference
for m in pkgutil.walk_packages(benchmark.reference.__path__,
                               "benchmark.reference."):
    importlib.import_module(m.name)
from benchmark.reference.gsw.envs.registry import registered_envs
print(json.dumps([sorted(sys.modules), sorted(registered_envs())]))
"""


def test_reference_modules_import_without_jax_or_the_port():
    p = subprocess.run([sys.executable, "-c", REFERENCE_MODULES],
                       cwd=H.ROOT, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    modules, registered = json.loads(p.stdout.strip().splitlines()[-1])
    tops = {m.split(".")[0] for m in modules}
    assert not tops & (set(H.FORBIDDEN) | {"gsworld_tpu_torch"})
    gsw = "benchmark.reference.gsw.envs."
    for m in ("benchmark.reference.closed_loop_dr", gsw + "agents.xarm6",
              gsw + "tasks.real_xarm", gsw + "tasks.tabletop.xarm6.align"):
        assert m in modules, m
    assert {"AlignFr3Env-v1", "AlignXArmEnv-v1",
            "RealXArm6-v1"} <= set(registered)
