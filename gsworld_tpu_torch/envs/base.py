"""Base task environment: batched reset/step with a ManiSkill-like surface
(port of gsworld_tpu/envs/base.py).

An env is a *static* description (physics scene, cameras, controller) plus
``_reset_fn(draws)`` / ``_step_fn(state, action)`` on tensors with a leading
env axis B, and a thin stateful facade with the familiar gym API
(``reset(seed=...)``, ``step(action)``, obs dicts with ``agent`` / ``extra``
/ ``sensor_param`` keys).  The hooks a task overrides (``_load_scene``,
``_initialize_episode``, ``evaluate``, ``_get_obs_extra``,
``compute_dense_reward``) take and return batched tensors.

Random numbers: ``reset(seed)`` seeds a CPU ``torch.Generator`` and draws
the uniform numbers ``_initialize_episode`` turns into an episode (then
those ``_randomize_world`` turns into domain randomization).  A sampler
is a pure function of its draws; the episode is laid out on the CPU and
copied to the env's device once, so one seed gives one episode on the
CPU and on the card.  The env's own action generator draws on the CPU as
well.

On a CUDA device ``step`` replays one CUDA graph of the whole step
(an ``FnGraph`` of ``_step_fn`` that carries its state: physics,
observation, reward), captured at the first step (``graph=True``, the
default), as the JAX package runs its jitted step.  ``reset`` is split
in two: the host layout (``_reset_layout``: the draws, the episode,
domain randomization and the EnvState, built on the CPU and copied to
the device once) and the device tail (``_reset_tail``: the observation
of that state), which a graphed env replays as one CUDA graph (the JAX
package's jitted reset).  ``graph=False`` steps and resets eagerly, and
on the CPU there is nothing to capture and ``graph`` is ignored
(``utils.cuda_graph.graphed`` decides).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from gsworld_tpu_torch import constants
from gsworld_tpu_torch.core.maths import (
    axis_angle_to_quat,
    tf_from_pq,
    tf_inverse_rigid,
)
from gsworld_tpu_torch.envs.agents.base import AgentSpec, get_agent
import gsworld_tpu_torch.envs.agents.fr3_umi  # noqa: F401 (registers agents)
from gsworld_tpu_torch.physics import builders as B
from gsworld_tpu_torch.physics.kinematics import forward_kinematics
from gsworld_tpu_torch.physics.world import (
    WORLD_FIELDS,
    PhysicsScene,
    WorldState,
    contact_row_count,
    control_step,
    scene_tensors,
    world_state_from_numpy,
    world_state_to_numpy,
)
from gsworld_tpu_torch.utils import cuda_graph
from gsworld_tpu_torch.utils.profiling import count, host_waits, span

# SAPIEN camera convention -> OpenCV
SAPIEN2OPENCV = np.array([
    [0.0, -1.0, 0.0, 0.0],
    [0.0, 0.0, -1.0, 0.0],
    [1.0, 0.0, 0.0, 0.0],
    [0.0, 0.0, 0.0, 1.0],
], dtype=np.float32)


def look_at_sapien(eye, target, up=(0, 0, 1)) -> np.ndarray:
    """Camera pose (4x4, SAPIEN convention: forward=+x, left=+y, up=+z)
    looking from eye at target."""
    eye = np.asarray(eye, np.float64)
    forward = np.asarray(target, np.float64) - eye
    forward /= np.linalg.norm(forward)
    up = np.asarray(up, np.float64)
    up = up / np.linalg.norm(up)
    left = np.cross(up, forward)
    left /= np.linalg.norm(left)
    up = np.cross(forward, left)
    T = np.eye(4)
    T[:3, 0] = forward
    T[:3, 1] = left
    T[:3, 2] = up
    T[:3, 3] = eye
    return T


def calib_mat2sapien_trans_mat(calib_mat: np.ndarray) -> np.ndarray:
    """OpenCV camera-axes matrix -> SAPIEN camera pose: columns
    (x, y, z) -> (z, -x, -y)."""
    out = np.eye(4, dtype=np.float64)
    out[:3, 0] = calib_mat[:3, 2]
    out[:3, 1] = -calib_mat[:3, 0]
    out[:3, 2] = -calib_mat[:3, 1]
    out[:3, 3] = calib_mat[:3, 3]
    return out


@dataclasses.dataclass(frozen=True)
class CameraSpec:
    """A sensor camera: intrinsics + mount (link-relative SAPIEN pose).
    Resizing a camera changes width/height only; K stays as calibrated."""

    name: str
    width: int
    height: int
    intrinsic: np.ndarray          # (3, 3)
    mount_link: Optional[str]      # None = world-fixed
    local_pose: np.ndarray         # (4, 4) SAPIEN-convention pose in mount frame
    near: float = 0.01
    far: float = 100.0


@dataclasses.dataclass
class EnvPoses:
    """Batched pose state of B envs: what the GS render reads."""

    qpos: torch.Tensor                         # (B, dof)
    a_pos: torch.Tensor                        # (B, A, 3)
    a_quat: torch.Tensor                       # (B, A, 4) wxyz
    root_pos: Optional[torch.Tensor] = None    # (B, 3), default origin
    root_quat: Optional[torch.Tensor] = None   # (B, 4), default identity
    a_scale: Optional[torch.Tensor] = None     # (B, A), default 1
    # domain randomization of the task state, default none:
    obj_color: Optional[torch.Tensor] = None       # (B, A, 3) colour tint
    cam_pose_noise: Optional[torch.Tensor] = None  # (B, C, 6) pos, rotvec


class EpisodeInit(NamedTuple):
    """Output of _initialize_episode for B envs."""

    qpos: torch.Tensor      # (B, dof)
    a_pos: torch.Tensor     # (B, A, 3)
    a_quat: torch.Tensor    # (B, A, 4)
    task: Dict[str, torch.Tensor]


@dataclasses.dataclass
class EnvState:
    world: WorldState
    elapsed: torch.Tensor      # (B,) int32
    prev_target: torch.Tensor  # (B, dof)
    task: Dict[str, torch.Tensor]

    def replace(self, **kw) -> "EnvState":
        return dataclasses.replace(self, **kw)


def env_state_from_numpy(fields: Mapping[str, Any],
                         device="cuda") -> EnvState:
    """EnvState from numpy arrays: ``fields["world"]`` as
    :func:`world_state_from_numpy` takes it, ``elapsed``, ``prev_target``
    and the ``task`` dict, each with the leading env axis (e.g. the fields
    of a JAX EnvState; its random key has no counterpart and is ignored).
    Task fields keep their kind: flags stay bool, numbers become f32."""
    def task_field(v):
        v = np.array(v)
        return torch.as_tensor(v.astype(np.float32) if v.dtype.kind == "f"
                               else v, device=device)

    return EnvState(
        world=world_state_from_numpy(fields["world"], device=device),
        elapsed=torch.as_tensor(np.array(fields["elapsed"], np.int32),
                                device=device),
        prev_target=torch.as_tensor(
            np.array(fields["prev_target"], np.float32), device=device),
        task={k: task_field(v)
              for k, v in (fields.get("task") or {}).items()})


def env_state_to_numpy(state: EnvState) -> Dict[str, Any]:
    return dict(world=world_state_to_numpy(state.world),
                elapsed=state.elapsed.cpu().numpy(),
                prev_target=state.prev_target.cpu().numpy(),
                task={k: v.cpu().numpy() for k, v in state.task.items()})


# the host spans of a step graph's call (``GsBaseEnv.step`` and
# ``GSWorldWrapper.step``)
STEP_SPANS = dict(load="gsw.step.load", launch="gsw.step.launch",
                  outputs="gsw.step.outputs")


class GsBaseEnv:
    """Batched functional env with a gym-like stateful facade."""

    SUPPORTED_REWARD_MODES = ("none", "dense", "sparse")
    max_episode_steps: int = 100
    # names of the task's actors in the order the physics scene keeps
    # them (known without building the scene)
    actor_names: Tuple[str, ...] = ()
    # uniform numbers per env that _initialize_episode consumes
    episode_draws: int = 0
    # uniform numbers per env that _randomize_world consumes
    dr_draws: int = 0

    def __init__(self, num_envs: int = 1, robot_uids: str = "fr3_umi",
                 obs_mode: str = "state_dict",
                 control_mode: Optional[str] = None,
                 reward_mode: str = "dense",
                 sim_freq: int = 120, control_freq: int = 40,
                 robot_init_qpos_noise: float = 0.02,
                 sim_config: Optional[dict] = None,
                 device="cuda", graph: bool = True, **kwargs):
        if sim_config:
            sim_freq = sim_config.get("sim_freq", sim_freq)
            control_freq = sim_config.get("control_freq", control_freq)
        self.num_envs = num_envs
        self.robot_uids = robot_uids
        self.obs_mode = obs_mode
        self.reward_mode = reward_mode
        self.robot_init_qpos_noise = robot_init_qpos_noise
        self.device = torch.device(device)
        self.graph = bool(graph)
        self.agent: AgentSpec = get_agent(robot_uids)
        self.control_mode = control_mode or self.agent.default_control_mode
        self.controller = self.agent.controller(self.control_mode)

        self._actor_defs: List[B.ActorDef] = []
        self._load_scene()
        # asset upgrade path: when a real collision mesh exists for an
        # actor name, it replaces the primitive approximation
        self._actor_defs = [B.actor_from_asset(d) for d in self._actor_defs]
        kp, kd, fl = self.controller.gains()
        # the host-side scene; its tensors are made on first use, so
        # describing an env (cameras, actor names) touches no device
        self._scene: PhysicsScene = B.make_scene(
            self.agent.model, self.agent.spec, self._actor_defs,
            contact_links=self.agent.contact_links,
            link_friction=self.agent.finger_friction,
            planes=self._scene_planes(),
            kp=kp, kd=kd, force_limit=fl,
            sim_freq=sim_freq, control_freq=control_freq, device=None)
        names = self._scene.actors.names
        if self.actor_names and tuple(self.actor_names) != tuple(names):
            raise ValueError(f"actor_names {self.actor_names} differ from "
                             f"the loaded scene's {names}")
        self.actor_names = tuple(names)
        self.actor_index = {n: i for i, n in enumerate(names)}
        self._la_pairs = np.asarray(self._scene.la_pairs).reshape(-1, 2)
        self.cameras: List[CameraSpec] = list(self._default_sensor_configs())
        self.human_render_cameras: List[CameraSpec] = list(
            self._default_human_render_camera_configs())
        self._cam_consts: Dict[Any, Any] = {}
        self._graphs: Dict[str, cuda_graph.FnGraph] = {}
        self._graph_pool = None
        self._state: Optional[EnvState] = None
        self._action_gen: Optional[torch.Generator] = None

    @property
    def scene(self) -> PhysicsScene:
        """The physics scene with its tensors on the env's device."""
        if self._scene.tensors is None:
            self._scene = dataclasses.replace(
                self._scene, tensors=scene_tensors(self._scene, self.device))
        return self._scene

    # ------------------------------------------------------------------ #
    # subclass hooks (batched over the leading env axis)
    # ------------------------------------------------------------------ #

    def _load_scene(self) -> None:
        """Append ActorDefs to self._actor_defs."""

    def _scene_planes(self) -> Optional[np.ndarray]:
        """Static contact planes. Tabletop tasks get the bounded table +
        ground (scene_builder.py); empty base envs a ground plane at z=0."""
        if hasattr(self, "x_offset"):
            from gsworld_tpu_torch.envs.scene_builder import (
                TableSceneBuilderOffset)
            return TableSceneBuilderOffset(self.x_offset).planes()
        return None

    def _initialize_episode(self, draws: torch.Tensor) -> EpisodeInit:
        """``draws`` (B, episode_draws) uniform numbers in [0, 1) ->
        EpisodeInit, as a pure function."""
        raise NotImplementedError

    def evaluate(self, data: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {}

    def _get_obs_extra(self, data, info) -> Dict[str, torch.Tensor]:
        return {}

    def compute_dense_reward(self, data, action, info) -> torch.Tensor:
        return torch.zeros(self.num_envs, device=self.device)

    def _default_sensor_configs(self) -> Sequence[CameraSpec]:
        return ()

    def _default_human_render_camera_configs(self) -> Sequence[CameraSpec]:
        """Third-person view for videos."""
        return [CameraSpec(
            "render_camera", 640, 480, constants.rs_d435i_rgb_k,
            mount_link=None,
            local_pose=look_at_sapien([1.0, 0.2, 0.5], [0.0, 0.0, 0.15]))]

    def _root_pose(self) -> Tuple[float, float, float]:
        """World position of the robot's root in every episode; the
        orientation stays the identity."""
        return (0.0, 0.0, 0.0)

    def _randomize_world(self, world: WorldState, task, draws):
        """Per-episode domain randomization hook: ``draws`` (B, dr_draws)
        uniform numbers in [0, 1), drawn after the episode's; returns
        (world, task)."""
        return world, task

    def update_task_state(self, data, task):
        """Optional per-step task-state update (e.g. sticky flags)."""
        return task

    # ------------------------------------------------------------------ #
    # helpers available to hooks through `data`
    # ------------------------------------------------------------------ #

    def actor_pose(self, data, name):
        i = self.actor_index[name]
        return data["world"].a_pos[:, i], data["world"].a_quat[:, i]

    def actor_vel(self, data, name):
        i = self.actor_index[name]
        return data["world"].a_lin[:, i], data["world"].a_ang[:, i]

    def link_pose(self, data, name):
        i = self.agent.model.link_id(name)
        return data["link_pos"][:, i], data["link_quat"][:, i]

    def tcp_pose(self, data):
        return self.link_pose(data, self.agent.ee_link)

    def pair_force(self, data, link: str, actor: str):
        """World-frame contact force of `actor` on `link` (mean over the
        last control step's substeps), (B, 3)."""
        li = self.agent.model.link_id(link)
        ai = self.actor_index[actor]
        rows = np.nonzero((self._la_pairs[:, 0] == li)
                          & (self._la_pairs[:, 1] == ai))[0]
        forces = data["world"].la_forces
        if len(rows) == 0:
            return torch.zeros_like(forces[:, 0])
        return forces[:, int(rows[0])]

    def is_grasping(self, data, actor: str, min_force=0.5, max_angle=85.0):
        forces = torch.stack([self.pair_force(data, f, actor)
                              for f in self.agent.finger_links], dim=1)
        quats = torch.stack([self.link_pose(data, f)[1]
                             for f in self.agent.finger_links], dim=1)
        return self.agent.is_grasping_from_forces(
            forces, quats, min_force, max_angle)

    def agent_is_static(self, data, threshold=0.2):
        qvel = data["world"].qvel[..., :-len(self.agent.gripper_dof_ids)]
        return qvel.abs().amax(dim=-1) <= threshold

    def actor_is_static(self, data, name, lin_thresh=0.05, ang_thresh=0.5):
        lin, ang = self.actor_vel(data, name)
        return ((torch.linalg.norm(lin, dim=-1) < lin_thresh)
                & (torch.linalg.norm(ang, dim=-1) < ang_thresh))

    # ------------------------------------------------------------------ #
    # functional core
    # ------------------------------------------------------------------ #

    def _env_data(self, state: EnvState):
        world = state.world
        link_pos, link_quat = forward_kinematics(
            self.agent.model, world.qpos, world.root_pos, world.root_quat)
        return {"world": world, "link_pos": link_pos, "link_quat": link_quat,
                "task": state.task}

    @torch.no_grad()
    def _reset_layout(self, draws: torch.Tensor,
                      dr_draws: Optional[torch.Tensor] = None) -> EnvState:
        """The host part of a reset: ``draws`` (B, episode_draws) and
        ``dr_draws`` (B, dr_draws) -> the EnvState of the episode, laid
        out where the draws are (the CPU, for ``reset``) and copied to the
        env's device once, so it is the same episode on every device.
        Counts the randomization's draws it consumes (``dr.draws/<env>``,
        B x ``dr_draws``)."""
        scene = self.scene
        host = draws.device
        ep = self._initialize_episode(draws)
        Bn, A = self.num_envs, scene.actors.num
        n_la = max(len(self._la_pairs), 1)
        f32 = dict(dtype=torch.float32, device=host)
        root_pos = torch.tensor(self._root_pose(), **f32).expand(Bn, 3).clone()
        root_quat = torch.zeros((Bn, 4), **f32)
        root_quat[:, 0] = 1.0
        world = WorldState(
            qpos=ep.qpos, qvel=torch.zeros((Bn, self.agent.model.dof), **f32),
            root_pos=root_pos, root_quat=root_quat,
            a_pos=ep.a_pos, a_quat=ep.a_quat,
            a_lin=torch.zeros((Bn, A, 3), **f32),
            a_ang=torch.zeros((Bn, A, 3), **f32),
            la_forces=torch.zeros((Bn, n_la, 3), **f32),
            contact_lam=torch.zeros((Bn, contact_row_count(scene), 6), **f32),
            a_friction=scene.tensors.a_friction.to(host).expand(Bn, A).clone(),
            a_scale=torch.ones((Bn, A), **f32))
        if dr_draws is None:
            dr_draws = torch.zeros((Bn, 0), **f32)
        world, task = self._randomize_world(world, ep.task, dr_draws)
        count("dr.draws", type(self).__name__, dr_draws.numel())
        dev = self.device
        world = WorldState(**{f: (None if getattr(world, f) is None
                                  else getattr(world, f).to(dev))
                              for f in WORLD_FIELDS})
        return EnvState(world=world,
                        elapsed=torch.zeros(Bn, dtype=torch.int32,
                                            device=dev),
                        prev_target=world.qpos.clone(),
                        task={k: v.to(dev) for k, v in task.items()})

    @torch.no_grad()
    def _reset_tail(self, state: EnvState):
        """The device part of a reset: the observation of the laid-out
        ``state`` (one FK)."""
        return self._observations(state, self._env_data(state))[0]

    def _reset_fn(self, draws: torch.Tensor,
                  dr_draws: Optional[torch.Tensor] = None):
        """``draws`` (B, episode_draws), ``dr_draws`` (B, dr_draws) ->
        (EnvState, obs): ``_reset_layout`` then ``_reset_tail``."""
        state = self._reset_layout(draws, dr_draws)
        return state, self._reset_tail(state)

    def _physics(self, world: WorldState, prev_target, action):
        """PD targets of ``action`` and one control step."""
        target = self.controller.compute_targets(
            world.qpos, prev_target, action,
            root_pos=world.root_pos, root_quat=world.root_quat)
        return control_step(self.scene, world, target), target

    @torch.no_grad()
    def _step_fn(self, state: EnvState, action):
        """One step of ``state`` -> (state, obs, reward, terminated,
        truncated, info)."""
        world, target = self._physics(state.world, state.prev_target, action)
        elapsed = state.elapsed + 1
        state = EnvState(world=world, elapsed=elapsed, prev_target=target,
                         task=state.task)
        data = self._env_data(state)
        if state.task:
            state = state.replace(task=self.update_task_state(
                {k: v for k, v in data.items() if k != "task"}, state.task))
            data["task"] = state.task
        obs, info = self._observations(state, data)
        no = torch.zeros(self.num_envs, dtype=torch.bool,
                         device=elapsed.device)
        if self.reward_mode == "dense":
            reward = self.compute_dense_reward(data, action, info)
        elif self.reward_mode == "sparse":
            reward = info.get("success", no).to(torch.float32)
        else:
            reward = no.to(torch.float32)
        terminated = info.get("success", no)
        if "fail" in info:
            terminated = terminated | info["fail"]
        truncated = elapsed >= self.max_episode_steps
        return state, obs, reward, terminated, truncated, info

    def _observations(self, state: EnvState, data):
        """-> (obs, info) from one FK of the state (``data``)."""
        info = self.evaluate(data)
        obs = {
            "agent": {"qpos": state.world.qpos, "qvel": state.world.qvel},
            "extra": self._get_obs_extra(data, info),
        }
        if self.cameras:
            obs["sensor_param"] = self.sensor_params(
                state, link_pose=(data["link_pos"], data["link_quat"]))
        return obs, info

    # ------------------------------------------------------------------ #
    # cameras
    # ------------------------------------------------------------------ #

    def _camera_consts(self, cameras, device):
        """(SAPIEN->OpenCV, [local pose per camera], K (C, 3, 3)) as
        tensors on ``device``, made once per camera set and device."""
        key = (tuple(id(c.local_pose) for c in cameras),
               tuple(id(c.intrinsic) for c in cameras), str(device))
        hit = self._cam_consts.get(key)
        if hit is None:
            kw = dict(dtype=torch.float32, device=device)
            hit = (torch.as_tensor(SAPIEN2OPENCV, **kw),
                   [torch.as_tensor(np.asarray(c.local_pose, np.float32),
                                    **kw) for c in cameras],
                   torch.as_tensor(np.stack(
                       [np.asarray(c.intrinsic, np.float32)
                        for c in cameras]), **kw),
                   list(cameras))      # keeps the ids above alive
            self._cam_consts[key] = hit
        return hit[:3]

    def camera_intrinsics(self, cameras=None, device=None) -> torch.Tensor:
        """(n_cams, 3, 3) intrinsics of ``cameras`` on ``device``."""
        cameras = self.cameras if cameras is None else cameras
        return self._camera_consts(cameras, device or self.device)[2]

    def camera_extrinsics_cv(self, poses, cameras=None, link_pose=None,
                             cam_pose_noise=None) -> torch.Tensor:
        """(B, n_cams, 4, 4) OpenCV world->cam extrinsics from FK.
        ``poses`` is an EnvState (as the JAX package's takes it), an
        EnvPoses or a WorldState; ``link_pose`` = (link_pos, link_quat)
        when FK already ran.  The sensor cameras' poses are perturbed by
        ``cam_pose_noise`` (B, C, 6) (default: the EnvState's task's or the
        EnvPoses' own), pose @ T(noise[:, min(i, C - 1)]); other cameras
        (the human view) never are."""
        if isinstance(poses, EnvState):
            if cam_pose_noise is None:
                cam_pose_noise = poses.task.get("cam_pose_noise")
            poses = poses.world
        sensors = cameras is None or cameras is self.cameras
        cameras = self.cameras if cameras is None else cameras
        if cam_pose_noise is None:
            cam_pose_noise = getattr(poses, "cam_pose_noise", None)
        if not sensors:
            cam_pose_noise = None
        if link_pose is None:
            link_pose = forward_kinematics(self.agent.model, poses.qpos,
                                           poses.root_pos, poses.root_quat)
        link_pos, link_quat = link_pose
        s2cv, locals_, _ = self._camera_consts(cameras, link_pos.device)
        Bn = link_pos.shape[0]
        outs = []
        for cam, local in zip(cameras, locals_):
            if cam.mount_link is None:
                pose = local.expand(Bn, 4, 4)
            else:
                li = self.agent.model.link_id(cam.mount_link)
                pose = tf_from_pq(link_pos[:, li], link_quat[:, li]) @ local
            if cam_pose_noise is not None:
                n = cam_pose_noise[:, min(len(outs),
                                          cam_pose_noise.shape[1] - 1)]
                pose = pose @ tf_from_pq(n[:, :3],
                                         axis_angle_to_quat(n[:, 3:6]))
            outs.append(s2cv @ tf_inverse_rigid(pose))
        return torch.stack(outs, dim=1)

    def sensor_params(self, state: EnvState, link_pose=None):
        ext = self.camera_extrinsics_cv(state, link_pose=link_pose)
        K = self.camera_intrinsics(device=ext.device)
        return {
            cam.name: {
                "extrinsic_cv": ext[:, i, :3, :],
                "intrinsic_cv": K[i].expand(self.num_envs, 3, 3),
            }
            for i, cam in enumerate(self.cameras)
        }

    # ------------------------------------------------------------------ #
    # gym facade
    # ------------------------------------------------------------------ #

    @property
    def action_dim(self) -> int:
        return self.controller.action_dim

    def action_space_sample(self, generator: Optional[torch.Generator] = None,
                            steps: Optional[int] = None):
        """Uniform actions in [-1, 1), (B, action_dim), on the env's
        device, drawn from ``generator`` (on its own device) or from the
        env's own CPU generator, which ``reset(seed)`` seeds.  With
        ``steps``, the actions of that many steps, (steps, B, action_dim),
        drawn as that many calls draw them and copied to the device
        once."""
        if generator is None:
            if self._action_gen is None:
                self._action_gen = torch.Generator().manual_seed(0)
            generator = self._action_gen
        a = [torch.rand((self.num_envs, self.action_dim), generator=generator,
                        device=generator.device) * 2.0 - 1.0
             for _ in range(1 if steps is None else steps)]
        return (a[0] if steps is None else torch.stack(a)).to(self.device)

    def reset_draws(self, seed: int):
        """The uniform numbers of ``reset(seed)``, on the CPU: (episode
        (B, episode_draws), randomization (B, dr_draws)), drawn in that
        order from one CPU generator seeded with ``seed``."""
        gen = torch.Generator().manual_seed(seed)
        ep = torch.rand((self.num_envs, self.episode_draws), generator=gen)
        dr = torch.rand((self.num_envs, self.dr_draws), generator=gen)
        return ep, dr

    def episode_draws_for(self, seed: int) -> torch.Tensor:
        """The (B, episode_draws) uniform numbers of ``reset(seed)``."""
        return self.reset_draws(seed)[0]

    def reset(self, seed: Optional[int] = None, options: Optional[dict] = None):
        seed = 0 if seed is None else seed
        self._action_gen = torch.Generator().manual_seed(seed + 1)
        return self._reset_from_draws(*self.reset_draws(seed)), {}

    def _reset_from_draws(self, draws, dr_draws):
        """A reset from its draws: the host layout, then the observation
        through the reset graph (``_reset_tail`` on a static EnvState,
        captured at the first graphed reset) on a graphed env, eagerly
        otherwise; the env takes the new state -> obs."""
        state = self._reset_layout(draws, dr_draws)
        if cuda_graph.graphed(self.graph, self.device):
            obs = cuda_graph.cached_graph(
                self._graphs, "reset", self._reset_tail, self.device,
                (state,), "the env reset", pool=self.graph_pool())(state)
        else:
            obs = self._reset_tail(state)
        self._state = state
        return obs

    def graph_pool(self):
        """The memory pool of the CUDA graphs of this env, its GS wrapper
        and renderer and its collision checker (None on the CPU).  They
        never replay at once and every call copies its outputs out before
        another replays, so one pool serves them all."""
        if self.device.type != "cuda":
            return None
        if self._graph_pool is None:
            with torch.cuda.device(self.device):
                self._graph_pool = torch.cuda.graph_pool_handle()
        return self._graph_pool

    def _as_action(self, action) -> torch.Tensor:
        """``action`` as a float32 (B, A) tensor on the env's device; one
        from host memory is copied there, which on a card waits for the
        stream (``host.sync/action_copy``)."""
        with span("gsw.step.action"):
            if not (isinstance(action, torch.Tensor)
                    and action.device == self.device):
                host_waits("action_copy", self.device)
            action = torch.as_tensor(action, dtype=torch.float32,
                                     device=self.device)
            if action.ndim == 1:
                action = action.expand(self.num_envs, -1)
            return action

    def step(self, action):
        """One step; on a graphed env through the step graph (``carry`` of
        ``_step_fn`` on a static EnvState and action, captured at the
        first graphed step), whose outputs are tensors of their own, as
        the eager step's."""
        action = self._as_action(action)
        if cuda_graph.graphed(self.graph, self.device):
            out = cuda_graph.cached_graph(
                self._graphs, "step", cuda_graph.carry(self._step_fn),
                self.device, (self._state, action), "the env step",
                pool=self.graph_pool(), spans=STEP_SPANS)(self._state, action)
        else:
            out = self._step_fn(self._state, action)
        (self._state, obs, reward, terminated, truncated, info) = out
        return obs, reward, terminated, truncated, info

    def get_state_dict(self):
        """ManiSkill-style state dict (['actors'][name][:, :7] = pos+quat)."""
        w = self._state.world
        actors = {
            name: torch.cat(
                [w.a_pos[:, i], w.a_quat[:, i], w.a_lin[:, i], w.a_ang[:, i]],
                dim=-1)
            for i, name in enumerate(self.actor_names)
        }
        return {"actors": actors,
                "articulations": {self.agent.uid: torch.cat(
                    [w.qpos, w.qvel], dim=-1)}}

    @property
    def state(self) -> EnvState:
        return self._state
