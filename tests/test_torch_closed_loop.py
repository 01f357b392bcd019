"""The closed loop as a whole: three steps of AlignFr3Env-v1 through the
port's GSWorldWrapper against the JAX GSWorldWrapper (2 envs, 160x120, a
small synthetic scene, the Pallas kernels in interpret mode), from the
same bridged state with the same actions: every frame >= 40 dB (uint8
PSNR; the JAX render quantizes colour to 10 bits and breaks depth
near-ties differently), segmentation agreement >= 99.9%; the scanned
loop (``scan_steps``, the counterpart of JAX's ``lax.scan`` of
``_step_and_render``) from that state with those actions against the
JAX frames and bit for bit against the port's eager frames;
``rollout_fps(use_scan=True)``'s contract; and the same loop with JAX
unavailable.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gsworld_tpu import envs as jenvs
from gsworld_tpu.render.camera import RasterConfig as JCfg
from gsworld_tpu.wrapper.gs_env import GSWorldWrapper as JWrapper
from gsworld_tpu_torch.envs.base import env_state_from_numpy
from gsworld_tpu_torch.rollout.random_actions import (
    build,
    main,
    rollout_fps,
    scan_steps,
)
from gsworld_tpu_torch.wrapper.gs_env import GSWorldWrapper, _clone_state
from torch_physics_common import (
    one_torch_thread,  # noqa: F401 (autouse fixture)
    jax_world_to_numpy,
    rel_err,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, B = 160, 120, 2
SCALE = 0.02
STEPS = 3
RASTER = dict(width=W, height=H, tile=32, max_tiles_per_gaussian=64,
              max_entries=16384, cull_alpha=True)


def _psnr_u8(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


@pytest.fixture(scope="module")
def loops():
    """Both wrappers stepped STEPS times from the JAX env's reset state;
    with the bridged start state and the STEPS actions."""
    jenv = jenvs.make("AlignFr3Env-v1", num_envs=B,
                      obs_mode="rgb+segmentation")
    jenv.cameras = [dataclasses.replace(c, width=W, height=H)
                    for c in jenv.cameras]
    jw = JWrapper(jenv, "fr3_align",
                  raster_config=JCfg(backend="pallas", **RASTER),
                  synthetic_sizes=dict(n_background=int(120_000 * SCALE),
                                       n_per_link=int(6_000 * SCALE),
                                       n_per_object=int(6_000 * SCALE)))
    jenv.reset(seed=2)
    js = jenv.state
    tenv, tw = build("AlignFr3Env-v1", B, "fr3_align", 120, 40, W, H,
                     synthetic_scale=SCALE, obs_mode="rgb+segmentation",
                     tile=32, max_tiles_per_gaussian=64, max_entries=16384,
                     device="cpu")
    tenv.reset(seed=0)
    tenv._state = env_state_from_numpy(dict(
        world=jax_world_to_numpy(js.world), elapsed=np.asarray(js.elapsed),
        prev_target=np.asarray(js.prev_target), task={}), device="cpu")
    start = _clone_state(tenv.state)
    rng = np.random.default_rng(9)
    frames, actions = [], []
    for _ in range(STEPS):
        a = rng.uniform(-1, 1, (B, 8)).astype(np.float32)
        jout = jw.step(jnp.asarray(a))
        tout = tw.step(a)
        frames.append((jout, tout))
        actions.append(a)
    return jenv, tenv, tw, frames, start, torch.as_tensor(np.stack(actions))


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("cam", ["wrist_cam", "right_cam"])
def test_frames_match_jax_wrapper(loops, step, cam):
    frames = loops[3]
    jobs, tobs = frames[step][0][0], frames[step][1][0]
    assert set(tobs["sensor_data"]) == {"wrist_cam", "right_cam"}
    rgb = tobs["sensor_data"][cam]["rgb"].numpy()
    seg = tobs["sensor_data"][cam]["segmentation"].numpy()
    jrgb = np.asarray(jobs["sensor_data"][cam]["rgb"])
    jseg = np.asarray(jobs["sensor_data"][cam]["segmentation"])
    assert rgb.shape == jrgb.shape == (B, H, W, 3) and rgb.dtype == jrgb.dtype
    assert seg.shape == jseg.shape == (B, H, W, 1) and seg.dtype == jseg.dtype
    assert rgb.std() > 5.0, "constant image"
    for e in range(B):
        p = _psnr_u8(rgb[e], jrgb[e])
        assert p >= 40.0, f"step {step} {cam} env {e}: PSNR {p:.1f} dB"
    agree = np.mean(seg == jseg)
    assert agree >= 0.999, f"segmentation agreement {agree:.5f}"


def test_state_and_step_outputs_match(loops):
    jenv, tenv, _, frames = loops[:4]
    (jobs, jr, jterm, jtrunc, jinfo), (tobs, tr, tterm, ttrunc, tinfo) = \
        frames[-1]
    for f in ("qpos", "a_pos", "a_quat"):
        assert rel_err(getattr(tenv.state.world, f).numpy(),
                       getattr(jenv.state.world, f)) <= 1e-4, f
    assert set(tobs) == set(jobs)
    assert np.abs(tr.numpy() - np.asarray(jr)).max() <= 1e-4
    for k in jinfo:
        np.testing.assert_array_equal(tinfo[k].numpy(), np.asarray(jinfo[k]))
    assert int(tenv.state.elapsed[0]) == STEPS


def test_frames_follow_the_state(loops):
    _, tenv, tw = loops[:3]
    before = tw.render_current_step()["right_cam"]["rgb"].clone()
    w = tenv.state.world
    a_pos = w.a_pos.clone()
    a_pos[0, 0, 1] -= 0.05
    tenv._state = tenv.state.replace(world=w.replace(a_pos=a_pos))
    after = tw.render_current_step()["right_cam"]["rgb"]
    tenv._state = tenv.state.replace(world=w)
    changed = (before != after).any(dim=-1).flatten(1).sum(dim=1)
    assert int(changed[0]) > 20 and int(changed[1]) == 0


def test_wrapper_surface(loops):
    _, tenv, tw = loops[:3]
    assert isinstance(tw, GSWorldWrapper)
    assert tw.num_envs == B and tw.action_dim == 8       # forwarded
    assert tw.agent is tenv.agent
    human = tw.render()
    assert human.shape == (B, 480, 640, 3) and human.dtype == torch.uint8
    obs, info = tw.reset(seed=1)
    assert info == {} and "sensor_data" in obs and "agent" in obs
    fps, spf, last = rollout_fps(tw, 1, seed=0, warmup=0)
    assert fps > 0 and last.shape == (B, H, W, 3) and last.dtype == np.uint8
    # split over the CPU (the env's device): env i steps as env i
    fps_s, _, last_s = rollout_fps(tw, 1, seed=0, warmup=0, shard=True)
    assert fps_s > 0
    np.testing.assert_array_equal(last_s, last)
    with pytest.raises(ValueError, match="renders on|render on"):
        GSWorldWrapper(tenv, "fr3_align", device="meta")


def test_scan_steps_matches_jax_and_eager(loops):
    """JAX's lax.scan of _step_and_render computes what its _jit_step
    does, so the scanned loop's frames face the JAX wrapper's steps."""
    _, tenv, tw, frames, start, actions = loops
    cam = tenv.cameras[0].name
    saved = tenv._state
    try:
        got, means = scan_steps(tw, actions, state=_clone_state(start))
        got, means = got.numpy(), means.numpy()
    finally:
        tenv._state = saved
    assert got.shape == (STEPS, H, W, 3) and got.dtype == np.uint8
    assert means.shape == (STEPS,) and means.dtype == np.float32
    for i, (jout, tout) in enumerate(frames):
        rgb = tout[0]["sensor_data"][cam]["rgb"].numpy()
        np.testing.assert_array_equal(got[i], rgb[0])
        np.testing.assert_allclose(means[i], rgb.mean(dtype=np.float64),
                                   rtol=1e-6)
        p = _psnr_u8(got[i], np.asarray(jout[0]["sensor_data"][cam]["rgb"][0]))
        assert p >= 40.0, f"step {i}: PSNR {p:.1f} dB"


def test_rollout_fps_scan_returns_jax_contract(loops, tmp_path):
    """(ep_len, H, W, 3) uint8 frames of env 0's first camera, the last of
    3 reps (JAX's random_actions.py rollout_fps(use_scan=True)); the
    actions are the eager loop's of the same seed; the CLI saves them."""
    tw = loops[2]
    fps, spf, frames = rollout_fps(tw, 1, seed=4, warmup=0, use_scan=True)
    assert fps > 0 and spf > 0
    assert frames.shape == (1, H, W, 3) and frames.dtype == np.uint8
    # 3 reps of one step: the eager loop's third step
    _, _, last = rollout_fps(tw, 3, seed=4, warmup=0)
    np.testing.assert_array_equal(frames[-1], last[0])
    main(["-n", "1", "--ep_len", "3", "--width", "32", "--height", "24",
          "--synthetic_scale", "0.003", "--device", "cpu", "--scan",
          "--save_video_dir", str(tmp_path)])
    assert len(list(tmp_path.glob("frame_*.png"))) == 3


def test_rollout_fps_scan_clock_reads_no_frames(loops, monkeypatch):
    """The scanned clock covers what JAX's does (ROADMAP C23): a warm-up
    of one whole scan of ep_len steps, then reps whose clock stops at the
    host read of the per-step means, with the frames left on the device;
    nothing reads the returned frames between a rep's two clock reads,
    and the last rep's frames are read after the last one."""
    import time
    import types

    import gsworld_tpu_torch.rollout.random_actions as ra
    tw = loops[2]
    log, calls = [], []

    class Watched(torch.Tensor):
        @classmethod
        def __torch_function__(cls, func, types_, args=(), kwargs=None):
            log.append("frames")
            with torch._C.DisableTorchFunctionSubclass():
                return func(*args, **(kwargs or {}))

    def watched_scan(wrapper, actions, state=None):
        calls.append(actions.shape[0])
        frames, means = scan_steps(wrapper, actions, state)
        return frames.as_subclass(Watched), means

    def clock():
        log.append("clock")
        return time.perf_counter()

    monkeypatch.setattr(ra, "scan_steps", watched_scan)
    monkeypatch.setattr(ra, "time", types.SimpleNamespace(perf_counter=clock))
    saved = tw.env._state
    try:
        _, _, frames = ra.rollout_fps(tw, 3, seed=4, warmup=2, use_scan=True)
    finally:
        tw.env._state = saved
    assert frames.shape == (3, H, W, 3) and frames.dtype == np.uint8
    assert calls == [3] * (1 + ra.SCAN_REPS)
    clocks = 0
    for event in log:
        if event == "clock":
            clocks += 1
        else:
            assert clocks % 2 == 0, f"frames read inside a timed rep: {log}"
    assert clocks == 2 * ra.SCAN_REPS and log[-1] == "frames"


def test_closed_loop_runs_without_jax():
    """The port imports neither jax nor gsworld_tpu: the closed loop in a
    subprocess where importing jax fails."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import numpy as np, torch
        from gsworld_tpu_torch.rollout.random_actions import main, build
        env, w = build("AlignFr3Env-v1", 2, "fr3_align", 120, 40, 64, 48,
                       synthetic_scale=0.003, obs_mode="rgb+segmentation",
                       device="cpu")
        obs, _ = w.reset(seed=0)
        z0 = env.state.world.a_pos.clone()
        for _ in range(2):
            obs, r, term, trunc, info = w.step(env.action_space_sample())
        assert obs["sensor_data"]["right_cam"]["rgb"].shape == (2, 48, 64, 3)
        assert obs["sensor_data"]["right_cam"]["segmentation"].dtype \\
            == torch.int16
        assert torch.isfinite(env.state.world.qpos).all()
        assert not torch.equal(env.state.world.qpos[:, :7],
                               obs["agent"]["qpos"][:, :7] * 0)
        fps = main(["-n", "1", "--ep_len", "1", "--width", "64", "--height",
                    "48", "--synthetic_scale", "0.003", "--device", "cpu"])
        assert fps > 0
        bad = [m for m in sys.modules
               if m == "gsworld_tpu" or m.startswith("gsworld_tpu.")
               or m == "flax" or m.startswith("flax.")]
        assert not bad, bad
        print("OK")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("OK")
