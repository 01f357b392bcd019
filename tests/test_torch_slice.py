"""The whole GS render slice: the port's GSWorldRenderer against the JAX
GSWorldWrapper.render_current_step for AlignFr3Env-v1 (2 envs, 160x120,
a small synthetic scene, the Pallas kernels in interpret mode), on the
same joint and actor poses; and the port rendering with JAX unavailable.
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
from gsworld_tpu.wrapper.gs_env import GSWorldWrapper
from gsworld_tpu_torch import constants
from gsworld_tpu_torch.envs.base import EnvPoses
from gsworld_tpu_torch.envs.tasks.tabletop.franka.align import AlignFr3Env
from gsworld_tpu_torch.render.camera import RasterConfig
from gsworld_tpu_torch.wrapper.gs_env import GSWorldRenderer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, B = 160, 120, 2
SCALE = 0.02
SIZES = dict(n_background=int(120_000 * SCALE),
             n_per_link=int(6_000 * SCALE),
             n_per_object=int(6_000 * SCALE))
RASTER = dict(width=W, height=H, tile=32, max_tiles_per_gaussian=64,
              max_entries=16384, cull_alpha=True)


def _resize(cams):
    # as the bench does: width/height change, K stays at 640x480
    return [dataclasses.replace(c, width=W, height=H) for c in cams]


def _poses(seed):
    """Task-init qpos plus a seeded joint walk; cans and rack on the table
    in the AlignFr3 init ranges."""
    rng = np.random.default_rng(seed)
    q = np.tile(constants.fr3_umi_task_init_qpos, (B, 1))
    q[:, :7] += rng.uniform(-0.15, 0.15, size=(B, 7)).astype(np.float32)
    xo = AlignFr3Env.x_offset
    a_pos = np.stack([
        np.stack([xo - 0.2 + 0.05 * rng.uniform(size=B),
                  0.1 + 0.1 * rng.uniform(size=B), np.full(B, 0.065)], -1),
        np.stack([xo - 0.25 + 0.2 * rng.uniform(size=B),
                  0.1 + 0.1 * rng.uniform(size=B), np.full(B, 0.05)], -1),
        np.stack([xo - 0.25 + 0.2 * rng.uniform(size=B),
                  -0.2 + 0.1 * rng.uniform(size=B), np.full(B, 0.068)], -1),
    ], axis=1).astype(np.float32)
    c, s = np.cos(np.pi / 4), np.sin(np.pi / 4)
    upright = np.array([c, s, 0, 0], np.float32)       # x +90 deg
    rack = np.array([c, 0, 0, -s], np.float32)         # z -90 deg
    a_quat = np.broadcast_to(np.stack([upright, upright, rack]),
                             (B, 3, 4)).astype(np.float32)
    return q.astype(np.float32), a_pos, a_quat


def _psnr_u8(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


def test_slice_matches_jax_wrapper():
    env = jenvs.make("AlignFr3Env-v1", num_envs=B,
                     obs_mode="rgb+segmentation")
    env.cameras = _resize(env.cameras)
    jw = GSWorldWrapper(env, "fr3_align",
                        raster_config=JCfg(backend="pallas", **RASTER),
                        synthetic_sizes=SIZES)
    env.reset(seed=0)
    q, a_pos, a_quat = _poses(0)
    w = env._state.world
    env._state = env._state.replace(world=w.replace(
        qpos=jnp.asarray(q), a_pos=jnp.asarray(a_pos),
        a_quat=jnp.asarray(a_quat)))
    ref = jw.render_current_step()

    tenv = AlignFr3Env(num_envs=B, obs_mode="rgb+segmentation")
    tenv.cameras = _resize(tenv.cameras)
    tw = GSWorldRenderer(tenv, "fr3_align",
                         raster_config=RasterConfig(**RASTER),
                         synthetic_sizes=SIZES, device="cpu")
    out = tw.render(EnvPoses(qpos=torch.as_tensor(q),
                             a_pos=torch.as_tensor(a_pos),
                             a_quat=torch.as_tensor(a_quat)))
    assert set(out) == set(ref) == {"wrist_cam", "right_cam"}
    for cam in out:
        rgb, seg = out[cam]["rgb"].numpy(), out[cam]["segmentation"].numpy()
        jrgb = np.asarray(ref[cam]["rgb"])
        jseg = np.asarray(ref[cam]["segmentation"])
        assert rgb.shape == jrgb.shape == (B, H, W, 3)
        assert rgb.dtype == np.uint8 and seg.dtype == np.int16
        assert seg.shape == jseg.shape == (B, H, W, 1)
        assert rgb.std() > 5.0, "constant image"
        # JAX quantizes colour to 10 bits and breaks depth near-ties
        # differently: a PSNR bound, not bit equality
        p = _psnr_u8(rgb, jrgb)
        assert p >= 40.0, f"{cam}: PSNR {p:.1f} dB"
        agree = np.mean(seg == jseg)
        assert agree >= 0.995, f"{cam}: segmentation agreement {agree:.4f}"
        assert len(np.unique(seg)) > 2
    assert int(tw.last_overflow.sum()) == 0


def test_port_renders_without_jax():
    """The port imports neither jax nor gsworld_tpu: render a tiny scene in
    a subprocess where importing jax fails."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import dataclasses, numpy as np, torch
        from gsworld_tpu_torch import constants
        from gsworld_tpu_torch.envs.base import EnvPoses
        from gsworld_tpu_torch.envs.tasks.tabletop.franka.align import (
            AlignFr3Env)
        from gsworld_tpu_torch.render.camera import RasterConfig
        from gsworld_tpu_torch.wrapper.gs_env import GSWorldRenderer
        env = AlignFr3Env(num_envs=1, obs_mode="rgb+segmentation")
        env.cameras = [dataclasses.replace(c, width=64, height=48)
                       for c in env.cameras]
        r = GSWorldRenderer(env, "fr3_align",
                            raster_config=RasterConfig(width=64, height=48),
                            synthetic_sizes=dict(n_background=300,
                                                 n_per_link=20,
                                                 n_per_object=20),
                            device="cpu")
        q = torch.as_tensor(constants.fr3_umi_task_init_qpos)[None]
        out = r.render(EnvPoses(qpos=q, a_pos=torch.zeros(1, 3, 3),
                                a_quat=torch.tensor([[[1.0, 0, 0, 0]] * 3])))
        assert out["wrist_cam"]["rgb"].shape == (1, 48, 64, 3)
        bad = [m for m in sys.modules
               if m == "gsworld_tpu" or m.startswith("gsworld_tpu.")]
        assert not bad, bad
        print("OK")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("OK")


def test_renderer_refuses_mixed_camera_sizes():
    env = AlignFr3Env(num_envs=1)
    env.cameras = [env.cameras[0],
                   dataclasses.replace(env.cameras[1], width=320)]
    with pytest.raises(ValueError, match="share one size"):
        GSWorldRenderer(env, "fr3_align",
                        synthetic_sizes=dict(n_background=10, n_per_link=2,
                                             n_per_object=2), device="cpu")


def test_entry_points_default_to_the_card():
    """The port's entry points run on the card unless the caller asks for
    the CPU, as every CPU test here does with device="cpu"."""
    import inspect

    from gsworld_tpu_torch.gs.model import scene_from_numpy, scene_from_splats
    from gsworld_tpu_torch.gs.pcd_init import create_from_pcd
    from gsworld_tpu_torch.gs.scene_factory import get_scene
    from gsworld_tpu_torch.real2sim.pipeline import train_from_colmap_model
    for fn in (GSWorldRenderer, train_from_colmap_model, get_scene,
               create_from_pcd, scene_from_numpy, scene_from_splats):
        default = inspect.signature(fn).parameters["device"].default
        assert default == "cuda", (fn.__name__, default)
