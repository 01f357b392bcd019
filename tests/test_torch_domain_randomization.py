"""Domain randomization of the port's xArm tasks (RealXArm6 and its
SO100GraspCubeDomainRandomizationConfig) against the JAX package's.

JAX's randomized values cannot be reproduced (the port draws from a CPU
torch generator, JAX from its keys), so what is held to JAX is what
consumes them, given the same values: one control step of a randomized
state (friction and scale reach the contacts; state to 1e-5, the noisy
sensor extrinsics in the observation to 1e-5), the extrinsics under a
given ``cam_pose_noise`` (1e-5), and the render of a randomized state
with its colour tint and the xArm link offset (uint8 PSNR >= 40 dB,
segmentation agreement >= 99.9%, as tests/test_torch_closed_loop.py).
The port's own draws: per-env variation within the configured ranges,
nothing drawn when disabled, the tint moves object pixels only.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gsworld_tpu import envs as jenvs
from gsworld_tpu.render.camera import RasterConfig as JCfg
from gsworld_tpu.wrapper.gs_env import GSWorldWrapper as JWrapper
from gsworld_tpu_torch import constants
from gsworld_tpu_torch import envs as tenvs
from gsworld_tpu_torch.envs.base import EnvPoses, env_state_from_numpy
from gsworld_tpu_torch.envs.tasks.real_xarm import normal_from_uniform
from gsworld_tpu_torch.render.camera import RasterConfig
from gsworld_tpu_torch.wrapper.gs_env import GSWorldWrapper, world_poses
from torch_physics_common import (
    one_torch_thread,  # noqa: F401 (autouse fixture)
    check_step,
    jax_state_fields,
    step_pair,
)

ENV = "AlignXArmEnv-v1"
W, H, B = 160, 120, 2
SIZES = dict(n_background=2400, n_per_link=120, n_per_object=400)
RASTER = dict(width=W, height=H, tile=32, max_tiles_per_gaussian=64,
              max_entries=16384, cull_alpha=True)


def dr_env(num_envs=3, **kw):
    return tenvs.make(ENV, num_envs=num_envs, domain_randomization=True,
                      device="cpu", **kw)


def test_per_env_variation():
    env = dr_env()
    cfg = env.domain_randomization_config
    A, C = len(env.actor_names), len(env.cameras)
    assert env.dr_draws == 5 * A + 6 * C
    env.reset(seed=0)
    w, task = env.state.world, env.state.task
    fric = w.a_friction.numpy()
    assert fric.shape == (3, A) and not np.allclose(fric[0], fric[1])
    assert (fric >= cfg.obj_friction_bounds[0]).all()
    assert (fric <= cfg.obj_friction_bounds[1]).all()
    sc = w.a_scale.numpy()
    assert not np.allclose(sc[0], sc[1])
    assert (sc >= cfg.obj_scale_range[0]).all()
    assert (sc <= cfg.obj_scale_range[1]).all()
    col = task["obj_color"].numpy()
    assert col.shape == (3, A, 3) and not np.allclose(col[0], col[1])
    assert (col >= 0).all() and (col < 1).all()
    noise = task["cam_pose_noise"].numpy()
    assert noise.shape == (3, C, 6)
    assert (np.abs(noise[..., :3]) <= np.asarray(cfg.max_camera_offset)).all()
    assert 0 < np.abs(noise[..., 3:]).max() < 10 * cfg.camera_view_rot_noise
    # seeded: the same seed draws the same randomization
    env.reset(seed=0)
    assert torch.equal(env.state.world.a_friction, w.a_friction)
    assert torch.equal(env.state.task["cam_pose_noise"],
                       task["cam_pose_noise"])


def test_disabled_is_identity():
    on, off = dr_env(2), tenvs.make(ENV, num_envs=2, device="cpu")
    assert off.dr_draws == 0
    off.reset(seed=0)
    on.reset(seed=0)
    w = off.state.world
    np.testing.assert_array_equal(w.a_friction.numpy(),
                                  np.full((2, 2), 0.6, np.float32))
    np.testing.assert_array_equal(w.a_scale.numpy(), 1.0)
    assert off.state.task == {}
    # the randomization draws come after the episode's: same layout
    for f in ("qpos", "a_pos", "a_quat", "root_pos"):
        assert torch.equal(getattr(on.state.world, f), getattr(w, f)), f
    # without cam_pose_noise the extrinsics are the plain ones
    ext = off.camera_extrinsics_cv(w)
    obs_ext = off._observations(off.state, off._env_data(off.state))[0][
        "sensor_param"]["wrist_cam"]["extrinsic_cv"]
    assert torch.equal(obs_ext, ext[:, 0, :3])


def test_normal_from_uniform():
    u = torch.tensor([0.0, 2.0 ** -24, 0.5, 1.0 - 2.0 ** -24])
    n = normal_from_uniform(u)
    assert torch.isfinite(n).all() and float(n[2]) == 0.0
    assert float(n[0]) < -5.0 and float(n[3]) > 5.0
    v = torch.rand(10000, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(normal_from_uniform(v)[1:-1],
                               torch.special.ndtri(v)[1:-1], atol=2e-4,
                               rtol=1e-4)


@pytest.fixture(scope="module")
def jax_dr_env():
    return jenvs.make(ENV, num_envs=B, domain_randomization=True)


def test_randomized_step_matches_jax(jax_dr_env):
    """JAX's own randomized state (its friction, scale, colours, camera
    noise), scales pushed apart, stepped in both packages: the contacts
    see friction and scale, the observation's extrinsics the noise."""
    tenv = dr_env(B)

    def spread_scales(f):
        f["world"]["a_scale"][:, 0] = [0.9, 1.1]

    jout, tout, fields = step_pair(jax_dr_env, tenv, seed=1, act_seed=2,
                                   prepare=spread_scales)
    assert set(fields["task"]) == {"obj_color", "cam_pose_noise"}
    assert not np.allclose(fields["world"]["a_friction"], 0.6)
    check_step(jax_dr_env, tenv, jout, tout)


def test_noisy_extrinsics_match_jax(jax_dr_env):
    """Extrinsics of one world under a given noise (larger than the
    config's), per camera and with a single camera's noise for both
    (index min(i, C - 1)); never on the human camera."""
    jax_dr_env.reset(seed=3)
    js = jax_dr_env.state
    tenv = dr_env(B)
    rng = np.random.default_rng(4)
    for C in (2, 1):
        noise = np.concatenate([rng.uniform(-0.05, 0.05, (B, C, 3)),
                                rng.normal(0, 0.1, (B, C, 3))],
                               -1).astype(np.float32)
        task = dict(js.task)
        task["cam_pose_noise"] = jnp.asarray(noise)
        want = np.asarray(jax_dr_env.camera_extrinsics_cv(
            js.replace(task=task)))
        fields = jax_state_fields(js)
        state = env_state_from_numpy(fields, device="cpu")
        got = tenv.camera_extrinsics_cv(
            state.world, cam_pose_noise=torch.as_tensor(noise)).numpy()
        assert np.abs(got - want).max() <= 1e-5
        plain = tenv.camera_extrinsics_cv(state.world).numpy()
        assert np.abs(got - plain).max() > 1e-3
    human = tenv.human_render_cameras
    torch.testing.assert_close(
        tenv.camera_extrinsics_cv(state.world, human,
                                  cam_pose_noise=torch.as_tensor(noise)),
        tenv.camera_extrinsics_cv(state.world, human), rtol=0, atol=0)


def test_extrinsics_of_env_state_match_jax(jax_dr_env):
    """The JAX package's camera_extrinsics_cv takes the EnvState and
    applies its task's cam_pose_noise to the sensor cameras (ROADMAP
    C21): the port's, given the same EnvState, within 1e-5 of it, for the
    sensor cameras and (without noise) the human view."""
    jax_dr_env.reset(seed=5)
    js = jax_dr_env.state
    state = env_state_from_numpy(jax_state_fields(js), device="cpu")
    tenv = dr_env(B)
    got = tenv.camera_extrinsics_cv(state).numpy()
    want = np.asarray(jax_dr_env.camera_extrinsics_cv(js))
    assert np.abs(got - want).max() <= 1e-5
    plain = tenv.camera_extrinsics_cv(state.world).numpy()
    assert np.abs(got - plain).max() > 1e-4
    human = np.asarray(jax_dr_env.camera_extrinsics_cv(
        js, jax_dr_env.human_render_cameras))
    got_h = tenv.camera_extrinsics_cv(state, tenv.human_render_cameras)
    assert np.abs(got_h.numpy() - human).max() <= 1e-5


def test_scale_affects_contacts():
    """A scaled-down object rests lower on the table."""
    env = dr_env(B)
    env.reset(seed=0)
    w = env.state.world
    sc = w.a_scale.clone()
    sc[0, 0], sc[1, 0] = 0.5, 1.5
    env._state = env.state.replace(world=w.replace(a_scale=sc))
    zero = np.zeros(env.action_dim, np.float32)
    for _ in range(25):
        env.step(zero)
    z = env.state.world.a_pos[:, 0, 2].numpy()
    assert z[0] < z[1] - 0.01, z


def _shrunk(env):
    env.cameras = [dataclasses.replace(c, width=W, height=H)
                   for c in env.cameras]
    return env


@pytest.fixture(scope="module")
def renders():
    """The JAX wrapper's render of its randomized reset state, and the
    port's of the same state bridged."""
    jenv = _shrunk(jenvs.make(ENV, num_envs=B, obs_mode="rgb+segmentation",
                              domain_randomization=True))
    jw = JWrapper(jenv, "xarm6_align",
                  raster_config=JCfg(backend="pallas", **RASTER),
                  synthetic_sizes=SIZES)
    jw.reset(seed=6)
    jout = jw.render_current_step()
    tenv = _shrunk(dr_env(B, obs_mode="rgb+segmentation"))
    tw = GSWorldWrapper(tenv, "xarm6_align",
                        raster_config=RasterConfig(**RASTER),
                        synthetic_sizes=SIZES, device="cpu")
    tenv.reset(seed=0)
    tenv._state = env_state_from_numpy(jax_state_fields(jenv.state),
                                       device="cpu")
    return jout, tw.render_current_step(), tw


def _psnr_u8(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


@pytest.mark.parametrize("cam", ["wrist_cam", "right_cam"])
def test_render_matches_jax(renders, cam):
    jout, tout, tw = renders
    rgb = tout[cam]["rgb"].numpy()
    jrgb = np.asarray(jout[cam]["rgb"])
    assert rgb.shape == jrgb.shape == (B, H, W, 3) and rgb.std() > 5.0
    for e in range(B):
        p = _psnr_u8(rgb[e], jrgb[e])
        assert p >= 40.0, f"{cam} env {e}: PSNR {p:.1f} dB"
    seg, jseg = tout[cam]["segmentation"].numpy(), np.asarray(
        jout[cam]["segmentation"])
    assert np.mean(seg == jseg) >= 0.999
    # the objects are in view in some frame
    ids = {constants.obj_gs_semantics[n] for n in tw.renderer.gs_objects}
    assert np.isin(np.concatenate([tout[c]["segmentation"].numpy().ravel()
                                   for c in tout]), list(ids)).any()


def test_link_offset_and_tint_are_applied(renders):
    """The xArm's links are shifted by object_offset["xarm_arm"] (0 for
    an FR3), and the tint reaches the render."""
    _, tout, tw = renders
    r = tw.renderer
    torch.testing.assert_close(
        r.link_offset, torch.tensor(constants.object_offset["xarm_arm"]))
    state = tw.env.state
    poses = world_poses(state.world, state.task)
    assert poses.obj_color is state.task["obj_color"]
    untinted = r.render(EnvPoses(**{**poses.__dict__, "obj_color": None}))
    moved = sum(int((untinted[c]["rgb"] != tout[c]["rgb"]).any(-1).sum())
                for c in tout)
    assert moved > 0
    fr3 = tenvs.make("AlignFr3Env-v1", num_envs=1, device="cpu")
    assert fr3.robot_uids == "fr3_umi"


def test_tint_changes_only_object_pixels(renders):
    """Zero tint on env 0's objects changes only pixels an object's
    Gaussians contribute to (those lit in a render that blacks out every
    other Gaussian), never the segmentation; env 1 stays bit for bit.
    Object pixels by segmentation alone are too few: the synthetic
    objects' splats are partly transparent, and where the background
    carries the most weight a pixel is labelled background though the
    object's colour shows in it."""
    from gsworld_tpu_torch.render.rasterize import render as gs_render
    _, _, tw = renders
    r, state = tw.renderer, tw.env.state
    poses = world_poses(state.world, state.task)
    posed, cams = r.frames(poses)

    def frame(tint):
        out = gs_render(posed, cams, r.raster_config, r.scene.sh0,
                        r.scene.shN, semantics=r.scene.semantics,
                        color_tint=tint[:, None])
        return out["rgb"], out["seg"]

    before, seg0 = frame(r.color_tint(poses.obj_color))
    color = poses.obj_color.clone()
    color[0] = 0.0
    after, seg1 = frame(r.color_tint(color))
    is_obj = torch.isin(r.scene.slot_ids, r.obj_slot).float()
    lit, _ = frame(is_obj[None, :, None].expand(B, -1, 3))
    reached = lit.sum(-1) > 0
    changed = (before != after).any(-1)                     # (B, C, H, W)
    assert not changed[1].any()
    assert not (changed[0] & ~reached[0]).any()
    assert torch.equal(seg0, seg1)
    ids = torch.tensor([constants.obj_gs_semantics[n] for n in r.gs_objects])
    on_obj = torch.isin(seg0.long(), ids)
    assert (changed[0] & on_obj[0]).sum() > 0
    assert (on_obj[0] & ~changed[0] & (before[0].amax(-1) > 1e-3)).sum() == 0
