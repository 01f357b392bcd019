"""Trajectory replay: drive recorded states through FK -> repose -> render
(port of gsworld_tpu/rollout/replay.py).

Replaying recorded qpos / actor trajectories through the GS pipeline gives
the full visual output without stepping the physics: the harness for
physics-parity comparisons (``compare_trajectories``) and for re-rendering
collected demos at other resolutions or cameras.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def set_env_state(env, actors: Dict[str, np.ndarray], qpos: np.ndarray,
                  qvel: Optional[np.ndarray] = None):
    """Restore a ManiSkill-style state dict snapshot into the env (the
    inverse of ``get_state_dict``): each actor's (B, 7) pose or (B, 13)
    pose + velocities, qpos (B, dof) and, where given, qvel."""
    w = env.state.world
    B = env.num_envs
    dev = w.qpos.device
    f32 = dict(dtype=torch.float32, device=dev)
    a_pos, a_quat = w.a_pos.clone(), w.a_quat.clone()
    a_lin, a_ang = w.a_lin.clone(), w.a_ang.clone()
    for name, st in actors.items():
        i = env.actor_index[name]
        st = torch.as_tensor(np.asarray(st), **f32).reshape(B, -1)
        a_pos[:, i] = st[:, :3]
        a_quat[:, i] = st[:, 3:7]
        if st.shape[1] >= 13:
            a_lin[:, i] = st[:, 7:10]
            a_ang[:, i] = st[:, 10:13]
    qpos = torch.as_tensor(np.asarray(qpos), **f32).reshape(B, -1)
    qvel = (torch.as_tensor(np.asarray(qvel), **f32).reshape(B, -1)
            if qvel is not None else w.qvel)
    w = w.replace(a_pos=a_pos, a_quat=a_quat, a_lin=a_lin, a_ang=a_ang,
                  qpos=qpos, qvel=qvel)
    env._state = env._state.replace(world=w)


def replay_trajectory(wrapper, traj: Dict, render_every: int = 1):
    """Replay one recorded trajectory group (rollout/record.py schema)
    through the GS wrapper; yields (t, {camera: rgb (B, H, W, 3) uint8})
    without stepping the physics."""
    env = wrapper.env
    states = traj["env_states"]
    actors = states["actors"]
    art = list(states["articulations"].values())[0]
    T = next(iter(actors.values())).shape[0]
    dof = env.agent.model.dof
    for t in range(0, T, render_every):
        set_env_state(
            env,
            {k: v[t] for k, v in actors.items()},
            art[t][..., :dof], art[t][..., dof:2 * dof])
        frames = wrapper.render_current_step()
        yield t, {k: (v["rgb"] if isinstance(v, dict) else v).cpu().numpy()
                  for k, v in frames.items()}


def replay_h5(wrapper, h5_path: str, traj_key: str = "traj_0",
              out_dir: Optional[str] = None, render_every: int = 1):
    """Replay a trajectory from an HDF5 file -> env 0's frames of the
    first camera (T, H, W, 3), or the video path written under
    ``out_dir``."""
    import h5py

    from gsworld_tpu_torch.rollout.io_utils import save_images_to_mp4
    with h5py.File(h5_path, "r") as f:
        g = f[traj_key]
        traj = {
            "env_states": {
                "actors": {k: np.asarray(v) for k, v in
                           g["env_states/actors"].items()},
                "articulations": {k: np.asarray(v) for k, v in
                                  g["env_states/articulations"].items()},
            }
        }
    frames = []
    for t, imgs in replay_trajectory(wrapper, traj, render_every):
        cam = sorted(imgs)[0]
        frames.append(imgs[cam][0])
    if out_dir:
        return save_images_to_mp4(np.stack(frames),
                                  f"{out_dir}/{traj_key}_replay.mp4")
    return np.stack(frames)


def compare_trajectories(states_a: Dict, states_b: Dict):
    """Physics-parity metrics between two recorded state sequences (e.g.
    the port against the JAX package on the same action sequence):
    per-actor position RMSE and max deviation, qpos RMSE."""
    out = {}
    for name in states_a["actors"]:
        pa = np.asarray(states_a["actors"][name])[..., :3]
        pb = np.asarray(states_b["actors"][name])[..., :3]
        n = min(len(pa), len(pb))
        d = np.linalg.norm(pa[:n] - pb[:n], axis=-1)
        out[f"actor/{name}/rmse"] = float(np.sqrt((d ** 2).mean()))
        out[f"actor/{name}/max"] = float(d.max())
    for name in states_a.get("articulations", {}):
        qa = np.asarray(states_a["articulations"][name])
        qb = np.asarray(states_b["articulations"][name])
        n = min(len(qa), len(qb))
        d = qa[:n] - qb[:n]
        out[f"articulation/{name}/qpos_rmse"] = float(
            np.sqrt((d ** 2).mean()))
    return out
