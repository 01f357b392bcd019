"""The port's demo recording, replay and utilities against the JAX
package's: io_utils (dict <-> HDF5, the video's .npz fallback,
NumpyEncoder), RecordEpisode's HDF5 schema and JSON sidecar name for name
(JAX's RecordEpisode fed the port's own step outputs), merge_trajectories,
replay of a recorded episode (frames bit for bit), set_env_state,
compare_trajectories, the checkpoint bundles and checks, StepTimer,
GSWorldWrapper's state log, ``run_with_gs.collect`` with patched
solutions, and the new modules importing without JAX.

Everything runs on the CPU at 64x48 with 2% of the synthetic scene; no
JAX physics step is compiled.  Tolerances: all comparisons are exact
(the same numpy arrays, or the same float32 operations on them)."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from gsworld_tpu.rollout import io_utils as jio
from gsworld_tpu.rollout import record as jrec
from gsworld_tpu.rollout import replay as jrep
from gsworld_tpu.utils import checkpoint as jck
from gsworld_tpu.utils import profiling as jprof
from gsworld_tpu_torch import envs as tenvs
from gsworld_tpu_torch.gs.model import SCENE_FIELDS
from gsworld_tpu_torch.physics.world import WORLD_FIELDS
from gsworld_tpu_torch.render.camera import RasterConfig
from gsworld_tpu_torch.rollout import io_utils
from gsworld_tpu_torch.rollout import record as trec
from gsworld_tpu_torch.rollout import replay as trep
from gsworld_tpu_torch.rollout import run_with_gs
from gsworld_tpu_torch.rollout.planner.motionplanner import (
    FR3UmiMotionPlanningSolver,
)
from gsworld_tpu_torch.utils import checkpoint as tck
from gsworld_tpu_torch.utils import profiling as tprof
from gsworld_tpu_torch.wrapper.gs_env import GSWorldWrapper
from torch_physics_common import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 64, 48
SCALE = 0.02
SIZES = dict(n_background=int(120_000 * SCALE),
             n_per_link=int(6_000 * SCALE), n_per_object=int(6_000 * SCALE))
STEPS = 2


def make_wrapper(**kw):
    import dataclasses
    env = tenvs.make("AlignFr3Env-v1", num_envs=1, obs_mode="rgb",
                     control_mode="pd_joint_pos",
                     sim_config=dict(sim_freq=100, control_freq=20),
                     device="cpu")
    env.cameras = [dataclasses.replace(c, width=W, height=H)
                   for c in env.cameras]
    return GSWorldWrapper(env, "fr3_align",
                          raster_config=RasterConfig(width=W, height=H),
                          synthetic_sizes=SIZES, device="cpu", **kw)


def hold_action(env):
    """pd_joint_pos: hold the arm where it is, gripper open."""
    q = env.state.world.qpos[0]
    return np.concatenate([q[list(env.agent.arm_dof_ids)].numpy(),
                           [1.0]]).astype(np.float32)


class Shim:
    """Passes calls to a wrapper and keeps its outputs as numpy, so the
    JAX RecordEpisode can be fed the same episode (Replayer)."""

    def __init__(self, wrapper):
        self.env = wrapper
        self.outs = []

    def reset(self, seed=None, options=None):
        obs, info = self.env.reset(seed=seed, options=options)
        self.outs.append(("reset", trec._to_np(obs)))
        return obs, info

    def step(self, action):
        out = self.env.step(action)
        self.outs.append(("step", trec._to_np(out),
                          trec._to_np(self.env.get_state_dict())))
        return out

    def __getattr__(self, name):
        return getattr(self.env, name)


class Replayer:
    """A stand-in env for JAX's RecordEpisode that returns a Shim's
    recorded outputs in order."""

    env_id = "AlignFr3Env-v1"

    def __init__(self, outs):
        self.outs = list(outs)
        self.sd = None

    def reset(self, seed=None, options=None):
        kind, obs = self.outs.pop(0)
        assert kind == "reset"
        return obs, {}

    def step(self, action):
        kind, out, self.sd = self.outs.pop(0)
        assert kind == "step"
        return out

    def get_state_dict(self):
        return self.sd


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """One episode (reset + STEPS hold steps) recorded by the port over a
    tiny GSWorldWrapper, and the same episode recorded by JAX's
    RecordEpisode from the port's outputs."""
    out = tmp_path_factory.mktemp("rec")
    wrapper = make_wrapper()
    shim = Shim(wrapper)
    rec = trec.RecordEpisode(shim, str(out / "port"), save_video=True)
    rec.reset(seed=3)
    states = []
    for _ in range(STEPS):
        rec.step(hold_action(wrapper.env))
        states.append(wrapper.env.state)
    frames = np.stack(rec._frames)
    rec.flush_trajectory()
    video = rec.flush_video()
    rec.close()
    jr = jrec.RecordEpisode(Replayer(shim.outs), str(out / "jax"),
                            save_video=True)
    jr.reset(seed=3)
    for _ in range(STEPS):
        jr.step(hold_action(wrapper.env))
    jr.flush_trajectory()
    jr.flush_video()
    jr.close()
    return dict(dir=out, wrapper=wrapper, frames=frames, video=video,
                states=states)


def h5_tree(path):
    """{name: (dtype, shape, values) or attrs} of every group, dataset and
    attribute of an HDF5 file."""
    import h5py
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = (obj.dtype.str, obj.shape, obj[()])
            else:
                out[name] = "group"
            for k, v in obj.attrs.items():
                out[f"{name}@{k}"] = v
        f.visititems(visit)
    return out


def assert_trees_equal(a, b):
    assert list(sorted(a)) == list(sorted(b)), set(a) ^ set(b)
    for k in a:
        if isinstance(a[k], tuple):
            assert a[k][:2] == b[k][:2], k
            np.testing.assert_array_equal(a[k][2], b[k][2], err_msg=k)
        else:
            assert np.all(a[k] == b[k]), k


def test_hdf5_and_json_io_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    data = {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "img": rng.integers(0, 255, (2, 4, 5, 3)).astype(np.uint8),
            "sub": {"n": 3, "x": 1.5, "flag": True, "name": "can",
                    "l": [1, 2, 3], "none": None,
                    "deep": {"t": np.arange(4)}}}
    io_utils.save_dict_to_hdf5(str(tmp_path / "t.h5"), data)
    jio.save_dict_to_hdf5(str(tmp_path / "j.h5"), data)
    assert_trees_equal(h5_tree(tmp_path / "t.h5"), h5_tree(tmp_path / "j.h5"))
    got = io_utils.load_hdf5(str(tmp_path / "j.h5"))
    want = jio.load_hdf5(str(tmp_path / "t.h5"))
    flat = lambda d: {k: v for k, v in _flat(d)}               # noqa: E731
    assert flat(got).keys() == flat(want).keys()
    for k, v in flat(want).items():
        np.testing.assert_array_equal(flat(got)[k], v, err_msg=k)
    obj = {"i": np.int64(3), "f": np.float32(0.5), "a": np.arange(3)}
    assert (json.dumps(obj, cls=io_utils.NumpyEncoder)
            == json.dumps(obj, cls=jio.NumpyEncoder))
    with pytest.raises(TypeError):
        json.dumps({"o": object()}, cls=io_utils.NumpyEncoder)


def _flat(d, prefix=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def test_video_falls_back_to_npz_without_ffmpeg(tmp_path, monkeypatch):
    """Where ffmpeg is not on PATH both packages write <path>.npz."""
    monkeypatch.setattr(io_utils.shutil, "which", lambda _: None)
    monkeypatch.setattr(jio.shutil, "which", lambda _: None)
    frames = np.random.default_rng(1).integers(0, 255, (3, H, W, 3),
                                               dtype=np.uint8)
    got = io_utils.save_images_to_mp4(frames, str(tmp_path / "t.mp4"), 15)
    want = jio.save_images_to_mp4(frames, str(tmp_path / "j.mp4"), 15)
    assert got == str(tmp_path / "t.mp4.npz")
    assert want == str(tmp_path / "j.mp4.npz")
    a, b = np.load(got), np.load(want)
    assert a.files == b.files
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])


def test_record_episode_schema_matches_jax(recorded):
    d = recorded["dir"]
    port = h5_tree(d / "port" / "trajectory.h5")
    assert_trees_equal(port, h5_tree(d / "jax" / "trajectory.h5"))
    names = {k for k in port if "@" not in k}
    actors = recorded["wrapper"].env.actor_names
    assert names == ({"traj_0", "traj_0/actions", "traj_0/rewards",
                      "traj_0/success", "traj_0/env_states",
                      "traj_0/env_states/actors",
                      "traj_0/env_states/articulations",
                      "traj_0/env_states/articulations/fr3_umi"}
                     | {f"traj_0/env_states/actors/{a}" for a in actors})
    assert port["traj_0/actions"][1] == (STEPS, 8)
    assert port["traj_0/env_states/articulations/fr3_umi"][1] == (STEPS, 1,
                                                                   18)
    assert (port["traj_0@episode_seed"], port["traj_0@elapsed_steps"]) == (
        3, STEPS)
    with open(d / "port" / "trajectory.json") as f:
        pj = json.load(f)
    with open(d / "jax" / "trajectory.json") as f:
        assert pj == json.load(f)
    assert pj["env_id"] == "AlignFr3Env-v1"
    # the video: env 0 of the first camera, reset frame and every step
    assert recorded["frames"].shape == (STEPS + 1, H, W, 3)
    with np.load(recorded["video"]) as v:
        np.testing.assert_array_equal(v["frames"], recorded["frames"])


def test_merge_trajectories_matches_jax(recorded, tmp_path):
    d = recorded["dir"]
    paths = [str(d / "port" / "trajectory.h5"),
             str(d / "jax" / "trajectory.h5")]
    got = trec.merge_trajectories(paths, str(tmp_path / "t" / "all.h5"))
    want = jrec.merge_trajectories(paths, str(tmp_path / "j" / "all.h5"))
    tree = h5_tree(got)
    assert_trees_equal(tree, h5_tree(want))
    assert {k for k in tree if "/" not in k and "@" not in k} == {
        "traj_0", "traj_1"}
    with open(got.replace(".h5", ".json")) as f:
        eps = json.load(f)["episodes"]
    with open(want.replace(".h5", ".json")) as f:
        assert eps == json.load(f)["episodes"]
    assert len(eps) == 2


def test_replay_gives_the_recorded_frames(recorded):
    """replay_h5 (through replay_trajectory and set_env_state) renders
    the recorded states: the recorded video's step frames bit for bit."""
    wrapper = recorded["wrapper"]
    path = str(recorded["dir"] / "port" / "trajectory.h5")
    frames = trep.replay_h5(wrapper, path)
    assert frames.dtype == np.uint8
    np.testing.assert_array_equal(frames, recorded["frames"][1:])


def test_set_env_state_inverts_get_state_dict(recorded):
    env = recorded["wrapper"].env
    want = recorded["states"][-1].world
    env._state = recorded["states"][-1]
    sd = trec._to_np(env.get_state_dict())
    env.reset(seed=11)
    dof = env.agent.model.dof
    art = sd["articulations"]["fr3_umi"]
    trep.set_env_state(env, sd["actors"], art[..., :dof], art[..., dof:])
    got = env.state.world
    for f in ("qpos", "qvel", "a_pos", "a_quat", "a_lin", "a_ang"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_compare_and_checks_match_jax():
    rng = np.random.default_rng(2)
    a = {"actors": {"can": rng.normal(size=(6, 1, 13)),
                    "rack": rng.normal(size=(6, 1, 13))},
         "articulations": {"fr3_umi": rng.normal(size=(6, 1, 18))}}
    b = {"actors": {k: (v + rng.normal(0, 1e-3, v.shape))[:5]
                    for k, v in a["actors"].items()},
         "articulations": {"fr3_umi": a["articulations"]["fr3_umi"][:4]}}
    assert trep.compare_trajectories(a, b) == jrep.compare_trajectories(a, b)
    bad = {"x": np.zeros((2, 3)), "y": {"z": np.zeros((3,))}}
    for sd in (a, b, bad, {"x": torch.zeros(2, 3), "y": np.zeros(2)}):
        assert tck.is_state_dict_consistent(sd) == \
            jck.is_state_dict_consistent(jax_tree(sd))
    assert not tck.is_state_dict_consistent(bad)
    qp = np.zeros((5, 9))
    for qv, dq in ((np.zeros((5, 9)), 0.0), (np.zeros((5, 9)), 1e-3),
                   (np.full((5, 9), 1e-2), 0.0)):
        qp2 = qp.copy()
        qp2[-1] += dq
        assert tck.check_joint_stuck(qp2, qv) == jck.check_joint_stuck(qp2,
                                                                       qv)
    assert tck.check_joint_stuck(qp, np.zeros((5, 9)))
    assert not tck.check_joint_stuck(qp[:1], np.zeros((1, 9)))


def jax_tree(sd):
    return {k: jax_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in sd.items()}


def test_step_timer_matches_jax():
    summaries = []
    for mod in (tprof, jprof):
        t = mod.StepTimer()
        for _ in range(3):
            with t.phase("step"):
                with t.phase("render"):
                    pass
        summaries.append(t.summary())
        assert t.fps("step", per_call_items=4) > 0 and t.fps("none") == 0.0
    got, want = summaries
    assert got.keys() == want.keys() == {"step", "render"}
    for k in got:
        assert got[k].keys() == want[k].keys()
        assert got[k]["count"] == want[k]["count"] == 3


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path)) as prof:
        torch.ones(8).sum()
    assert os.path.exists(tmp_path / "trace.json")
    assert len(prof.key_averages()) > 0


def test_checkpoints_round_trip(recorded, tmp_path):
    wrapper = recorded["wrapper"]
    scene = wrapper.renderer.scene
    path = tck.save_scene(scene, str(tmp_path / "scene"),
                          extra={"step": np.int64(7)})
    assert path.endswith(".npz")
    back = tck.load_scene(path, like=scene)
    for f in SCENE_FIELDS:
        a, b = getattr(scene, f), getattr(back, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    state = recorded["states"][-1]
    back = tck.load_env_state(
        tck.save_env_state(state, str(tmp_path / "st.npz")), like=state)
    assert_states_equal(back, state)
    w = tck.load_env_state(
        tck.save_env_state(state.world, str(tmp_path / "w.npz")),
        like=state.world)
    for f in WORLD_FIELDS:
        assert torch.equal(getattr(w, f), getattr(state.world, f)), f


def assert_states_equal(a, b):
    for f in WORLD_FIELDS:
        x, y = getattr(a.world, f), getattr(b.world, f)
        assert x.dtype == y.dtype and torch.equal(x, y), f
    assert torch.equal(a.elapsed, b.elapsed)
    assert a.elapsed.dtype == b.elapsed.dtype
    assert torch.equal(a.prev_target, b.prev_target)
    assert a.task.keys() == b.task.keys()
    for k in a.task:
        assert torch.equal(a.task[k], b.task[k]), k


def test_state_log_writes_one_bundle_per_step(tmp_path):
    wrapper = make_wrapper(log_state=True,
                           state_log_path=str(tmp_path / "log"))
    wrapper.reset(seed=5)
    assert not (tmp_path / "log").exists()
    states = []
    for _ in range(STEPS):
        wrapper.step(hold_action(wrapper.env))
        states.append(wrapper.env.state)
    files = sorted(os.listdir(tmp_path / "log"))
    assert files == [f"state_{i:06d}.npz" for i in range(STEPS)]
    for name, st in zip(files, states):
        assert_states_equal(
            tck.load_env_state(str(tmp_path / "log" / name), like=st), st)


def test_collect_with_patched_solutions(tmp_path, monkeypatch):
    """collect over seeds 0, 1: seed 0's plan fails (-1, after one
    step), seed 1's holds for two steps; the stats, the one kept
    trajectory, its JSON entry and its video."""
    calls = []

    def solve(env, seed=None, debug=False, vis=False):
        calls.append(seed)
        env.reset(seed=seed)
        planner = FR3UmiMotionPlanningSolver(env)
        if seed % 2 == 0:
            planner.hold(steps=1)
            return -1
        return planner.hold(steps=2)

    from gsworld_tpu_torch.rollout.planner import solutions
    monkeypatch.setitem(solutions.SOLUTIONS, "AlignFr3Env-v1", solve)
    out = tmp_path / "demos"
    stats = run_with_gs.collect(
        "AlignFr3Env-v1", "fr3_align", num_traj=1, output_dir=str(out),
        save_video=True, width=W, height=H, synthetic_scale=SCALE,
        max_seeds=4, verbose=False, device="cpu")
    assert calls == [0, 1]
    assert stats == {"num_traj": 1, "tried": 2, "success_rate": 1.0,
                     "failed_plan_rate": 0.5, "avg_episode_len": None}
    assert sorted(os.listdir(out)) == ["episode_seed1.mp4.npz",
                                       "trajectory.h5", "trajectory.json"]
    tree = h5_tree(out / "trajectory.h5")
    assert tree["traj_0/actions"][1] == (2, 8)
    assert tree["traj_0@episode_seed"] == 1
    with open(out / "trajectory.json") as f:
        meta = json.load(f)
    assert meta["episodes"] == [{"episode_id": 0, "episode_seed": 1,
                                 "elapsed_steps": 2, "success": False}]
    with np.load(out / "episode_seed1.mp4.npz") as v:
        assert v["frames"].shape == (3, H, W, 3)


def test_new_modules_import_without_jax():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import gsworld_tpu_torch.physics.contact
        import gsworld_tpu_torch.rollout.planner.motionplanner
        import gsworld_tpu_torch.rollout.planner.rrt
        import gsworld_tpu_torch.rollout.planner.solutions as s
        import gsworld_tpu_torch.rollout.io_utils
        import gsworld_tpu_torch.rollout.record
        import gsworld_tpu_torch.rollout.replay
        import gsworld_tpu_torch.rollout.run_with_gs
        import gsworld_tpu_torch.utils.checkpoint
        import gsworld_tpu_torch.utils.profiling
        assert len(s.SOLUTIONS) == 7
        bad = [m for m in sys.modules
               if m == "gsworld_tpu" or m.startswith("gsworld_tpu.")]
        assert not bad, bad
        print("OK")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("OK")
