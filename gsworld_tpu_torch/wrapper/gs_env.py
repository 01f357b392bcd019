"""GSWorldRenderer: the GS render half of the env step (port of
gsworld_tpu/wrapper/gs_env.py:GSWorldWrapper, render path).

Per render, for B envs x C cameras in ONE batched path:

    FK -> per-link / per-object slot transforms -> repose ->
    camera bridge -> project -> bin (emit kernel + sort) ->
    composite (compositor kernel)

Per-link transform (reference gs_world_wrapper.py:110-131):
    delta_l = sim2gs . T_link . T_link_scan^-1 . sim2gs^-1       (rigid)
Per-object transform (gs_world_wrapper.py:135-162):
    full_o = sim2gs . (T_actor + offset) . sim2gs_obj^-1
    -> polar-decomposed rigid + uniform scale * object_scale
Scan-pose link poses come from one FK at ``robot_scan_qpos``.

Output contract (as the JAX wrapper): per camera, ``rgb`` uint8
(B, H, W, 3) from ``clip(img * 255, 0, 255)`` truncated, and with
segmentation in ``env.obs_mode`` an int16 ``segmentation`` (B, H, W, 1).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from gsworld_tpu_torch import constants
from gsworld_tpu_torch.core.maths import (
    extract_rigid_transform_fast,
    tf_from_pq,
    tf_inverse_rigid,
)
from gsworld_tpu_torch.envs.base import EnvPoses, GsBaseEnv
from gsworld_tpu_torch.gs.scene_factory import get_scene
from gsworld_tpu_torch.gs.transform import SlotTransforms, repose_scene
from gsworld_tpu_torch.physics.kinematics import forward_kinematics
from gsworld_tpu_torch.physics.spec_io import load_surface_points
from gsworld_tpu_torch.render.camera import RasterConfig, cam_maniskill2gs
from gsworld_tpu_torch.render.rasterize import render as gs_render


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
        self.scene, self.layout = get_scene(
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

    @torch.no_grad()
    def frames(self, poses: EnvPoses):
        """FK, slot transforms, repose and camera bridge of ``poses`` ->
        (posed Gaussians (B, 1, N, ...), GS cameras (B, C)), which
        broadcast to the B x C frames of one render."""
        env = self.env
        cams = env.cameras
        cfg = self.raster_config
        if (cams[0].width, cams[0].height) != (cfg.width, cfg.height):
            raise ValueError("raster_config size differs from the cameras'")
        with record_function("gsw.pose"):
            link_pos, link_quat = forward_kinematics(
                env.agent.model, poses.qpos, poses.root_pos, poses.root_quat)
            slots = self.slot_transforms(link_pos, link_quat, poses.a_pos,
                                         poses.a_quat, poses.a_scale)
            posed = repose_scene(self.scene, slots)              # (B, N, ...)
            ext = env.camera_extrinsics_cv(
                poses, link_pose=(link_pos, link_quat))          # (B, C, 4, 4)
            K = torch.as_tensor(np.stack([np.asarray(c.intrinsic, np.float32)
                                          for c in cams]),
                                device=ext.device)               # (C, 3, 3)
            gs_cams = cam_maniskill2gs(ext, K, cfg.width, cfg.height,
                                       self.rigid_sim2real,
                                       self.scale_sim2real)
        return type(posed)(*(x[:, None] for x in posed)), gs_cams

    @torch.no_grad()
    def render(self, poses: EnvPoses) -> dict:
        """Render every env of ``poses`` through every sensor camera."""
        env = self.env
        cams = env.cameras
        cfg = self.raster_config
        posed_bc, gs_cams = self.frames(poses)
        want_seg = "segmentation" in env.obs_mode
        out = gs_render(posed_bc, gs_cams, cfg, self.scene.sh0,
                        self.scene.shN,
                        semantics=self.scene.semantics if want_seg else None)
        self.last_overflow = out["overflow"]                     # (B, C)
        imgs = torch.clamp(out["rgb"] * 255.0, 0, 255).to(torch.uint8)
        result = {}
        for ci, cam in enumerate(cams):
            result[cam.name] = {"rgb": imgs[:, ci]}
            if want_seg:
                result[cam.name]["segmentation"] = (
                    out["seg"][:, ci, :, :, None].to(torch.int16))
        return result
