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

On a CUDA env built with ``graph=True`` (the default), every call
replays one CUDA graph, as the JAX wrapper runs its jitted programs:
``GSWorldWrapper.step`` the whole step, physics to render
(``step_graph``: an ``envs.base.StepGraph`` of ``_step_and_render``,
``_jit_step``), which the scanned loop
(``rollout/random_actions.py:scan_steps``) replays too; ``reset`` the
reset's device tail and the sensor render (``reset_graph``,
``_jit_reset``) after the env's host layout; ``GSWorldRenderer.render``
one graph per camera set (``render_graph``: the sensor cameras for
``render_current_step``, ``_jit_render``, and the human view for
``render``).  Each is captured at its first call.  A graph cannot be
replayed inside another's capture, so the captured functions call the
eager render (``GSWorldRenderer._render``).  A call with
``raster_config=``, ``graph=False`` and the CPU run eagerly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gsworld_tpu_torch import constants
from gsworld_tpu_torch.core.maths import (
    extract_rigid_transform_fast,
    tf_from_pq,
    tf_inverse_rigid,
)
from gsworld_tpu_torch.envs.base import (  # noqa: F401 (_clone_state)
    EnvPoses,
    GsBaseEnv,
    StepGraph,
    _clone_state,
)
from gsworld_tpu_torch.gs.scene_factory import get_scene
from gsworld_tpu_torch.gs.transform import SlotTransforms, repose_scene
from gsworld_tpu_torch.physics.kinematics import forward_kinematics
from gsworld_tpu_torch.physics.spec_io import load_surface_points
from gsworld_tpu_torch.render.camera import RasterConfig, cam_maniskill2gs
from gsworld_tpu_torch.render.rasterize import render as gs_render
from gsworld_tpu_torch.utils.cuda_graph import FnGraph
from gsworld_tpu_torch.utils.profiling import span, stamp


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
        self._render_graphs = {}

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
        posed = repose_scene(self.scene, slots)              # (B, N, ...)
        ext = env.camera_extrinsics_cv(
            poses, cams, link_pose=(link_pos, link_quat))    # (B, C, 4, 4)
        K = env.camera_intrinsics(cams, ext.device)          # (C, 3, 3)
        gs_cams = cam_maniskill2gs(ext, K, cfg.width, cfg.height,
                                   self.rigid_sim2real,
                                   self.scale_sim2real)
        return type(posed)(*(x[:, None] for x in posed)), gs_cams

    @torch.no_grad()
    def render(self, poses: EnvPoses, cameras=None,
               raster_config: Optional[RasterConfig] = None) -> dict:
        """Render every env of ``poses`` through every sensor camera, or
        through ``cameras`` (then without segmentation).
        ``raster_config`` replaces the renderer's for this render (another
        D or E at the sensor cameras' size: tools/render_parity.py).  On a
        CUDA env built with ``graph=True`` a render without
        ``raster_config`` replays the camera set's ``render_graph``; its
        outputs are tensors of their own, as the eager render's."""
        if raster_config is None and self.env.graph \
                and self.device.type == "cuda":
            result, self.last_overflow = self.render_graph(
                poses, cameras)(poses)
            return result
        return self._render(poses, cameras, raster_config)

    def render_graph(self, poses: EnvPoses, cameras=None) -> FnGraph:
        """The render through ``cameras`` (default the sensor cameras) as
        one CUDA graph (an ``FnGraph`` of ``_render`` on static EnvPoses,
        returning the render and ``last_overflow``), one per camera set and
        set of pose fields, captured at its first call from ``poses``; a
        CUDA renderer only.  A replay launches one emit and one compositor
        kernel."""
        if self.device.type != "cuda":
            raise ValueError(f"the renderer draws on {self.device}: only a "
                             f"CUDA render is captured")
        cams = self.env.cameras if cameras is None else cameras
        key = (cameras is None, tuple(map(id, cams)), tuple(
            None if v is None else (tuple(v.shape), v.dtype)
            for v in (getattr(poses, f.name)
                      for f in dataclasses.fields(poses))))
        hit = self._render_graphs.get(key)
        if hit is None:
            hit = self._render_graphs[key] = (
                self._capture_render(poses, cameras), list(cams))
        return hit[0]

    def _capture_render(self, poses: EnvPoses, cameras=None) -> FnGraph:
        def fn(p):
            out = self._render(p, cameras)
            return out, self.last_overflow

        return FnGraph(fn, self.device, (poses,), "the GS render",
                       pool=self.env.graph_pool())

    @torch.no_grad()
    def _render(self, poses: EnvPoses, cameras=None,
                raster_config: Optional[RasterConfig] = None) -> dict:
        """``render``'s work, eagerly (what every graph captures)."""
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
    for it.  With ``log_state`` each step also saves the state
    (``save_state_log``).  Attributes it does not define are the env's."""

    def __init__(self, env: GsBaseEnv, scene_gs_cfg_name: str,
                 raster_config: Optional[RasterConfig] = None,
                 asset_dir: Optional[str] = None,
                 cfg_dir: Optional[str] = None,
                 synthetic_sizes: Optional[dict] = None,
                 log_state: bool = False,
                 state_log_path: str = "./exp_log",
                 device=None):
        self.env = env
        self.log_state = log_state
        self.state_log_path = state_log_path
        self._state_log_count = 0
        self.num_envs = env.num_envs
        self.scene_gs_cfg_name = scene_gs_cfg_name
        device = env.device if device is None else torch.device(device)
        if device != env.device:
            raise ValueError(f"the env steps on {env.device}, the wrapper "
                             f"was asked to render on {device}")
        # the scene and raster arguments, for a wrapper of another env
        # (dist/sharded.py wraps one per shard)
        self.render_kwargs = dict(
            raster_config=raster_config, synthetic_sizes=synthetic_sizes,
            asset_dir=asset_dir, cfg_dir=cfg_dir)
        self.renderer = GSWorldRenderer(
            env, scene_gs_cfg_name, device=device, **self.render_kwargs)
        self.is_real_scene = self.renderer.is_real_scene
        self.raster_config = self.renderer.raster_config
        self._step_graph: Optional[StepGraph] = None
        self._reset_graph: Optional[FnGraph] = None

    def _render_fn(self, state, cameras=None) -> dict:
        """The eager GS render of ``state`` (what the graphs capture)."""
        return self.renderer._render(
            world_poses(state.world, state.task), cameras)

    def _step_and_render(self, state, action):
        """One step of ``state`` and the GS render of the new state.  On a
        card it stamps the device's clock (``utils.profiling.stamp``) at
        its begin and between the physics and the render; the step graph
        stamps its end."""
        dev = self.env.device
        stamp("loop.begin", dev)
        (state, obs, reward, terminated, truncated,
         info) = self.env._step_fn(state, action)
        stamp("loop.physics|render", dev)
        obs = dict(obs)
        obs["sensor_data"] = self._render_fn(state)
        return state, obs, reward, terminated, truncated, info

    def step_graph(self, action) -> StepGraph:
        """The wrapper's whole step as one CUDA graph (a ``StepGraph`` of
        ``_step_and_render``), captured at the first call from the env's
        current state, with ``action``'s shape; a CUDA env only.  A
        replay launches one emit and one compositor kernel and overwrites
        the renderer's ``last_overflow``."""
        if self.env.device.type != "cuda":
            raise ValueError(f"the env steps on {self.env.device}: only a "
                             f"CUDA env's step is captured")
        if self._step_graph is None:
            self._step_graph = StepGraph(self._step_and_render,
                                         self.env.device, self.env._state,
                                         action, "the closed-loop step",
                                         pool=self.env.graph_pool(),
                                         end_tag="loop.end")
            # the render's overflow output of the graph
            self._step_overflow = self.renderer.last_overflow
        return self._step_graph

    def _reset_and_render(self, state):
        """The device part of a reset of the laid-out ``state`` and its GS
        render (the JAX wrapper's ``_reset_and_render`` after the layout)
        -> (obs, the render's overflow)."""
        obs = dict(self.env._reset_tail(state))
        obs["sensor_data"] = self._render_fn(state)
        return obs, self.renderer.last_overflow

    def reset_graph(self, state) -> FnGraph:
        """The reset's device tail and the sensor render as one CUDA graph
        (an ``FnGraph`` of ``_reset_and_render``), captured at the first
        call from ``state``; a CUDA env only.  A replay launches one emit
        and one compositor kernel."""
        if self.env.device.type != "cuda":
            raise ValueError(f"the env resets on {self.env.device}: only a "
                             f"CUDA env's reset is captured")
        if self._reset_graph is None:
            self._reset_graph = self._capture_reset(state)
        return self._reset_graph

    def _capture_reset(self, state) -> FnGraph:
        return FnGraph(self._reset_and_render, self.env.device, (state,),
                       "the closed-loop reset", pool=self.env.graph_pool())

    def reset(self, seed: Optional[int] = None,
              options: Optional[dict] = None):
        seed = 0 if seed is None else seed
        self.env._action_gen = torch.Generator().manual_seed(seed + 1)
        return self._reset_from_draws(*self.env.reset_draws(seed)), {}

    def _reset_from_draws(self, draws, dr_draws):
        """A reset from its draws: the env's host layout, then its device
        tail and the render through the wrapper's reset graph on a graphed
        env (eagerly otherwise); the env takes the new state -> obs."""
        env = self.env
        state = env._reset_layout(draws, dr_draws)
        if env._graphed():
            obs, self.renderer.last_overflow = self.reset_graph(state)(state)
        else:
            obs = self._reset_and_render(state)[0]
        env._state = state
        return obs

    def step(self, action):
        """One step and the GS render of the new state; through the
        wrapper's CUDA graph where the env's ``step`` replays one (its
        outputs are tensors of their own, as the eager step's)."""
        with span("gsw.step"):
            action = self.env._as_action(action)
            if self.env._graphed():
                out = self.step_graph(action)(self.env._state, action)
                self.renderer.last_overflow = self._step_overflow
            else:
                out = self._step_and_render(self.env._state, action)
                stamp("loop.end", self.env.device)
            (self.env._state, obs, reward, terminated, truncated,
             info) = out
            if self.log_state:
                self.save_state_log()
            return obs, reward, terminated, truncated, info

    def save_state_log(self) -> str:
        """Save the current env state as a restorable bundle,
        ``<state_log_path>/state_<n>.npz`` (utils/checkpoint.py
        ``load_env_state`` reads it) -> its path."""
        from gsworld_tpu_torch.utils.checkpoint import save_env_state
        path = f"{self.state_log_path}/state_{self._state_log_count:06d}.npz"
        self._state_log_count += 1
        return save_env_state(self.env._state, path)

    def render_current_step(self) -> dict:
        """Render without stepping (through the renderer's graph of the
        sensor cameras on a graphed env)."""
        st = self.env._state
        return self.renderer.render(world_poses(st.world, st.task))

    def render(self) -> torch.Tensor:
        """Human render view: the GS render of the third-person camera,
        uint8 (B, H, W, 3) (through the renderer's graph of that view on
        a graphed env)."""
        st = self.env._state
        out = self.renderer.render(world_poses(st.world, st.task),
                                   cameras=self.env.human_render_cameras)
        return next(iter(out.values()))["rgb"]

    def __getattr__(self, name):
        return getattr(self.env, name)
