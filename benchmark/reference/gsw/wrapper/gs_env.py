"""GSWorldWrapper: photorealistic GS rendering in the env step, and the
GSWorldRenderer it owns (port of gsworld_tpu/wrapper/gs_env.py).

``GSWorldWrapper(env, cfg_name)`` steps the env's physics and renders the
new state: ``obs["sensor_data"][cam]["rgb"]`` (and ``"segmentation"``)
beside the env's own observation.  ``GSWorldRenderer`` renders any batched
pose state handed to it.

Per render, for B envs x C cameras in ONE batched path:

    FK -> per-link / per-object slot transforms -> repose ->
    camera bridge -> project -> bin (emit kernel + sort) ->
    composite (compositor kernel)

Per-link transform (reference gs_world_wrapper.py:110-131):
    delta_l = sim2gs . T_link . T_link_scan^-1 . sim2gs^-1       (rigid)
Per-object transform (gs_world_wrapper.py:135-162):
    full_o = sim2gs . (T_actor + offset) . sim2gs_obj^-1
    -> polar-decomposed rigid + uniform scale * object_scale
Scan-pose link poses come from one FK at ``robot_scan_qpos``.  An xArm's
link positions are shifted by ``object_offset["xarm_arm"]`` first (its
scan was aligned with that offset); an FR3's are not.

Domain randomization reaches the render through the task state: the
per-object colour ``obj_color`` (B, A, 3) becomes a per-env, per-slot
tint (1 where no object is) gathered per Gaussian and multiplied into the
projected colours, and ``cam_pose_noise`` perturbs the sensor cameras'
extrinsics (``GsBaseEnv.camera_extrinsics_cv``).

Output contract (as the JAX wrapper): per camera, ``rgb`` uint8
(B, H, W, 3) from ``clip(img * 255, 0, 255)`` truncated, and with
segmentation in ``env.obs_mode`` an int16 ``segmentation`` (B, H, W, 1).

The reference renders, steps and resets eagerly: it captures no CUDA
graph.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from benchmark.reference.gsw import constants
from benchmark.reference.gsw.core.maths import (
    extract_rigid_transform_fast,
    tf_from_pq,
    tf_inverse_rigid,
)
from benchmark.reference.gsw.envs.base import EnvPoses, GsBaseEnv
from benchmark.reference.gsw.gs.scene_factory import get_scene
from benchmark.reference.gsw.gs.transform import SlotTransforms, repose_scene
from benchmark.reference.gsw.physics.kinematics import forward_kinematics
from benchmark.reference.gsw.physics.spec_io import load_surface_points
from benchmark.reference.gsw.render.camera import RasterConfig, cam_maniskill2gs
from benchmark.reference.gsw.render.rasterize import render as gs_render


class GSWorldRenderer:
    """Renders batched env poses of ``env`` through its sensor cameras."""

    def __init__(self, env: GsBaseEnv, scene_gs_cfg_name: str,
                 raster_config: Optional[RasterConfig] = None,
                 synthetic_sizes: Optional[dict] = None,
                 asset_dir: Optional[str] = None,
                 cfg_dir: Optional[str] = None,
                 device="cuda"):
        self.env = env
        self.device = torch.device(device)
        model = env.agent.model
        sizes = {(c.width, c.height) for c in env.cameras}
        if len(sizes) != 1:
            raise ValueError("all sensor cameras must share one size to "
                             f"render as one batch, got {sorted(sizes)}")

        _, sim2gs = constants.robot_calibration(scene_gs_cfg_name)
        sim2gs = np.asarray(sim2gs, np.float64)
        # host-side polar decomposition of sim2gs (SVD in numpy)
        U, S, Vh = np.linalg.svd(sim2gs[:3, :3])
        rigid = np.eye(4, dtype=np.float32)
        rigid[:3, :3] = (U @ Vh).astype(np.float32)
        rigid[:3, 3] = sim2gs[:3, 3]
        self.scale_sim2real = float(S.mean())
        self.gs_objects = [n for n in env.actor_names
                           if n in constants.sim2gs_object_transforms]

        scan_qpos = constants.robot_scan_qpos[env.robot_uids]
        try:
            surface = load_surface_points(env.robot_uids)
        except FileNotFoundError:
            surface = None
        self.scene, self.layout, self.is_real_scene = get_scene(
            scene_gs_cfg_name, model, scan_qpos, self.gs_objects,
            link_names=list(model.link_names), asset_dir=asset_dir,
            cfg_dir=cfg_dir, synthetic_sizes=synthetic_sizes,
            surface_points=surface, device=self.device)

        pos0, quat0 = forward_kinematics(
            model, torch.as_tensor(np.asarray(scan_qpos, np.float32)))
        f32 = dict(dtype=torch.float32, device=self.device)
        self.sim2gs = torch.as_tensor(sim2gs, **f32)
        self.inv_sim2gs = torch.as_tensor(np.linalg.inv(sim2gs), **f32)
        self.rigid_sim2real = torch.as_tensor(rigid, **f32)
        self.inv_link_pose0 = tf_inverse_rigid(tf_from_pq(pos0, quat0)).to(
            self.device)                                         # (L, 4, 4)
        objs = self.gs_objects
        self.obj_slot = torch.as_tensor(
            [self.layout.object_slots[n] for n in objs], dtype=torch.long,
            device=self.device)
        self.obj_actor_idx = torch.as_tensor(
            [env.actor_index[n] for n in objs], dtype=torch.long,
            device=self.device)
        self.inv_sim2gs_obj = torch.as_tensor(np.stack([
            np.linalg.inv(np.asarray(constants.sim2gs_object_transforms[n],
                                     np.float64)) for n in objs])
            if objs else np.zeros((0, 4, 4)), **f32)
        self.obj_offset = torch.as_tensor(np.stack([
            np.asarray(constants.object_offset.get(n, [0, 0, 0]), np.float64)
            for n in objs]) if objs else np.zeros((0, 3)), **f32)
        self.obj_scale = torch.as_tensor(
            [constants.object_scale.get(n, 1.0) for n in objs], **f32)
        self.link_slots = torch.as_tensor(self.layout.link_slots,
                                          dtype=torch.long, device=self.device)
        self.apply_scale = torch.as_tensor(self.layout.scaled,
                                           device=self.device)
        self.link_offset = (torch.as_tensor(
            constants.object_offset["xarm_arm"], **f32)
            if "xarm" in env.robot_uids else None)
        cam0 = env.cameras[0] if env.cameras else None
        self.raster_config = raster_config or RasterConfig(
            width=cam0.width if cam0 else 640,
            height=cam0.height if cam0 else 480)

    def slot_transforms(self, link_pos, link_quat, a_pos, a_quat,
                        a_scale=None) -> SlotTransforms:
        """(B, S) transform stack in layout slot order from FK link poses
        (B, L, ...) and actor poses (B, A, ...)."""
        B = link_pos.shape[0]
        S = self.layout.num_slots
        f32 = dict(dtype=torch.float32, device=link_pos.device)
        if a_scale is None:
            a_scale = torch.ones(a_pos.shape[:2], **f32)
        R = torch.eye(3, **f32).repeat(B, S, 1, 1)
        t = torch.zeros((B, S, 3), **f32)
        s = torch.ones((B, S), **f32)

        if self.link_offset is not None:
            link_pos = link_pos + self.link_offset
        delta = (self.sim2gs @ tf_from_pq(link_pos, link_quat)
                 @ self.inv_link_pose0 @ self.inv_sim2gs)        # (B, L, 4, 4)
        R[:, self.link_slots] = delta[..., :3, :3]
        t[:, self.link_slots] = delta[..., :3, 3]
        if self.gs_objects:
            ai = self.obj_actor_idx
            T_act = tf_from_pq(a_pos[:, ai] + self.obj_offset, a_quat[:, ai])
            full = self.sim2gs @ T_act @ self.inv_sim2gs_obj
            _, scale, R_obj, t_obj = extract_rigid_transform_fast(full)
            R[:, self.obj_slot] = R_obj
            t[:, self.obj_slot] = t_obj
            s[:, self.obj_slot] = scale * self.obj_scale * a_scale[:, ai]
        return SlotTransforms(R=R, t=t, scale=s, apply_scale=self.apply_scale)

    def color_tint(self, obj_color):
        """Per-Gaussian tint (B, N, 3) of the per-actor colours
        ``obj_color`` (B, A, 3): the objects' slots take their actor's
        colour, every other slot 1; None without colours or objects."""
        if obj_color is None or not self.gs_objects:
            return None
        B = obj_color.shape[0]
        tint = torch.ones((B, self.layout.num_slots, 3), dtype=torch.float32,
                          device=obj_color.device)
        tint[:, self.obj_slot] = obj_color[:, self.obj_actor_idx].to(
            torch.float32)
        return tint[:, self.scene.slot_ids.long()]

    def _config_for(self, cameras):
        """The raster configuration of a render through ``cameras``: the
        sensor cameras (None) must have its size, other cameras (the human
        view) bring their own."""
        cfg = self.raster_config
        if cameras is None:
            cam = self.env.cameras[0]
            if (cam.width, cam.height) != (cfg.width, cfg.height):
                raise ValueError("raster_config size differs from the "
                                 "cameras'")
            return cfg
        sizes = {(c.width, c.height) for c in cameras}
        if len(sizes) != 1:
            raise ValueError("cameras of one render must share one size, "
                             f"got {sorted(sizes)}")
        (w, h), = sizes
        return dataclasses.replace(cfg, width=w, height=h)

    @torch.no_grad()
    def frames(self, poses: EnvPoses, cameras=None):
        """FK, slot transforms, repose and camera bridge of ``poses`` ->
        (posed Gaussians (B, 1, N, ...), GS cameras (B, C)), which
        broadcast to the B x C frames of one render.  ``cameras`` default
        to the env's sensor cameras."""
        env = self.env
        cams = env.cameras if cameras is None else cameras
        cfg = self._config_for(cameras)
        link_pos, link_quat = forward_kinematics(
            env.agent.model, poses.qpos, poses.root_pos, poses.root_quat)
        slots = self.slot_transforms(link_pos, link_quat, poses.a_pos,
                                     poses.a_quat, poses.a_scale)
        posed = repose_scene(self.scene, slots)                  # (B, N, ...)
        ext = env.camera_extrinsics_cv(
            poses, cams, link_pose=(link_pos, link_quat))        # (B, C, 4, 4)
        K = env.camera_intrinsics(cams, ext.device)              # (C, 3, 3)
        gs_cams = cam_maniskill2gs(ext, K, cfg.width, cfg.height,
                                   self.rigid_sim2real, self.scale_sim2real)
        return type(posed)(*(x[:, None] for x in posed)), gs_cams

    @torch.no_grad()
    def render(self, poses: EnvPoses, cameras=None,
               raster_config: Optional[RasterConfig] = None) -> dict:
        """Render every env of ``poses`` through every sensor camera, or
        through ``cameras`` (then without segmentation).
        ``raster_config`` replaces the renderer's for this render."""
        env = self.env
        cams = env.cameras if cameras is None else cameras
        cfg = self._config_for(cameras)
        if raster_config is not None:
            if (raster_config.width, raster_config.height) != (
                    cfg.width, cfg.height):
                raise ValueError("raster_config size differs from the "
                                 "cameras'")
            cfg = raster_config
        posed_bc, gs_cams = self.frames(poses, cameras)
        want_seg = cameras is None and "segmentation" in env.obs_mode
        tint = self.color_tint(poses.obj_color)
        out = gs_render(posed_bc, gs_cams, cfg, self.scene.sh0,
                        self.scene.shN,
                        semantics=self.scene.semantics if want_seg else None,
                        color_tint=None if tint is None else tint[:, None])
        self.last_overflow = out["overflow"]                     # (B, C)
        imgs = torch.clamp(out["rgb"] * 255.0, 0, 255).to(torch.uint8)
        result = {}
        for ci, cam in enumerate(cams):
            result[cam.name] = {"rgb": imgs[:, ci]}
            if want_seg:
                result[cam.name]["segmentation"] = (
                    out["seg"][:, ci, :, :, None].to(torch.int16))
        return result


def world_poses(world, task=None) -> EnvPoses:
    """The pose state the render reads, of a WorldState and the task
    state (its ``obj_color`` and ``cam_pose_noise``, where it has them)."""
    task = task or {}
    return EnvPoses(qpos=world.qpos, a_pos=world.a_pos, a_quat=world.a_quat,
                    root_pos=world.root_pos, root_quat=world.root_quat,
                    a_scale=world.a_scale, obj_color=task.get("obj_color"),
                    cam_pose_noise=task.get("cam_pose_noise"))


class GSWorldWrapper:
    """Wraps a GsBaseEnv; obs['sensor_data'][cam]['rgb'] becomes the GS
    render (uint8, (B, H, W, 3)) of the state after each reset and step,
    with an int16 'segmentation' (B, H, W, 1) when the env's obs_mode asks
    for it.  Attributes it does not define are the env's."""

    def __init__(self, env: GsBaseEnv, scene_gs_cfg_name: str,
                 raster_config: Optional[RasterConfig] = None,
                 asset_dir: Optional[str] = None,
                 cfg_dir: Optional[str] = None,
                 synthetic_sizes: Optional[dict] = None,
                 device=None):
        self.env = env
        self.num_envs = env.num_envs
        self.scene_gs_cfg_name = scene_gs_cfg_name
        device = env.device if device is None else torch.device(device)
        if device != env.device:
            raise ValueError(f"the env steps on {env.device}, the wrapper "
                             f"was asked to render on {device}")
        self.render_kwargs = dict(
            raster_config=raster_config, synthetic_sizes=synthetic_sizes,
            asset_dir=asset_dir, cfg_dir=cfg_dir)
        self.renderer = GSWorldRenderer(
            env, scene_gs_cfg_name, device=device, **self.render_kwargs)
        self.is_real_scene = self.renderer.is_real_scene
        self.raster_config = self.renderer.raster_config

    def _render_fn(self, state, cameras=None) -> dict:
        """The GS render of ``state``."""
        return self.renderer.render(world_poses(state.world, state.task),
                                    cameras)

    def _step_and_render(self, state, action):
        """One step of ``state`` and the GS render of the new state."""
        (state, obs, reward, terminated, truncated,
         info) = self.env._step_fn(state, action)
        obs = dict(obs)
        obs["sensor_data"] = self._render_fn(state)
        return state, obs, reward, terminated, truncated, info

    def _reset_and_render(self, state):
        """The device part of a reset of the laid-out ``state`` and its GS
        render (the JAX wrapper's ``_reset_and_render`` after the layout)
        -> (obs, the render's overflow)."""
        obs = dict(self.env._reset_tail(state))
        obs["sensor_data"] = self._render_fn(state)
        return obs, self.renderer.last_overflow

    def reset(self, seed: Optional[int] = None,
              options: Optional[dict] = None):
        seed = 0 if seed is None else seed
        self.env._action_gen = torch.Generator().manual_seed(seed + 1)
        return self._reset_from_draws(*self.env.reset_draws(seed)), {}

    def _reset_from_draws(self, draws, dr_draws):
        """A reset from its draws: the env's host layout, then its device
        tail and the render; the env takes the new state -> obs."""
        env = self.env
        state = env._reset_layout(draws, dr_draws)
        obs = self._reset_and_render(state)[0]
        env._state = state
        return obs

    def step(self, action):
        """One step and the GS render of the new state."""
        action = self.env._as_action(action)
        (self.env._state, obs, reward, terminated, truncated,
         info) = self._step_and_render(self.env._state, action)
        return obs, reward, terminated, truncated, info

    def render_current_step(self) -> dict:
        """Render without stepping."""
        st = self.env._state
        return self.renderer.render(world_poses(st.world, st.task))

    def render(self) -> torch.Tensor:
        """Human render view: the GS render of the third-person camera,
        uint8 (B, H, W, 3)."""
        st = self.env._state
        out = self.renderer.render(world_poses(st.world, st.task),
                                   cameras=self.env.human_render_cameras)
        return next(iter(out.values()))["rgb"]

    def __getattr__(self, name):
        return getattr(self.env, name)
