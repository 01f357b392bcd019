"""RecordEpisode: HDF5 trajectory + video recording wrapper (port of
gsworld_tpu/rollout/record.py), and merge_trajectories for sharded
collection.

Trajectory schema (``traj_<i>`` groups, ManiSkill-compatible surface):
  actions (T, A) | rewards (T, B) | success (T, B) |
  env_states/<actors|articulations>/<name> (T, B, ...) |
  attrs: episode_seed, elapsed_steps, success
and a JSON sidecar ``<name>.json`` with one entry per episode.  ``h5py``
is imported where a file is opened.
"""

from __future__ import annotations

import glob
import json
import os
from typing import List, Optional

import numpy as np
import torch

from gsworld_tpu_torch.rollout import io_utils


def _to_np(tree):
    """The tree (dicts, lists, tuples) with every tensor as a host numpy
    array."""
    if isinstance(tree, dict):
        return {k: _to_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_np(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


class RecordEpisode:
    """Wraps an env (or GSWorldWrapper); records trajectories to HDF5 and
    the first camera's frames of env 0 to videos."""

    def __init__(self, env, output_dir: str, save_trajectory: bool = True,
                 save_video: bool = False, trajectory_name: str = "trajectory",
                 video_fps: int = 30, record_env_state: bool = True,
                 save_obs: bool = False):
        self.env = env
        self.output_dir = output_dir
        self.save_trajectory = save_trajectory
        self.save_video = save_video
        self.video_fps = video_fps
        self.record_env_state = record_env_state
        self.save_obs = save_obs
        os.makedirs(output_dir, exist_ok=True)
        self._h5_path = os.path.join(output_dir, f"{trajectory_name}.h5")
        self._json_path = os.path.join(output_dir, f"{trajectory_name}.json")
        if save_trajectory:
            import h5py
            self._file = h5py.File(self._h5_path, "w")
        else:
            self._file = None
        self._meta: List[dict] = []
        self._traj_count = 0
        self._reset_buffers()
        self._frames = []
        self._episode_seed = None

    def _reset_buffers(self):
        self._actions = []
        self._rewards = []
        self._success = []
        self._states = []
        self._obs = []

    # ------------------------------------------------------------------ #

    def reset(self, seed: Optional[int] = None, options: Optional[dict] = None):
        self._reset_buffers()
        self._frames = []
        self._episode_seed = seed
        obs, info = self.env.reset(seed=seed, options=options)
        self._maybe_record_frame(obs)
        return obs, info

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self._actions.append(_to_np(action))
        self._rewards.append(_to_np(reward))
        self._success.append(_to_np(info.get("success", False)))
        if self.record_env_state:
            self._states.append(_to_np(self.env.get_state_dict()))
        if self.save_obs:
            self._obs.append(_to_np(obs))
        self._maybe_record_frame(obs)
        return obs, reward, terminated, truncated, info

    def _maybe_record_frame(self, obs):
        if self.save_video and isinstance(obs, dict) and "sensor_data" in obs:
            cams = obs["sensor_data"]
            name = sorted(cams)[0]
            self._frames.append(_to_np(cams[name]["rgb"][0]))

    # ------------------------------------------------------------------ #

    def flush_trajectory(self, save: bool = True):
        if not save or self._file is None or not self._actions:
            self._reset_buffers()
            return
        g = self._file.create_group(f"traj_{self._traj_count}")
        g.create_dataset("actions", data=np.stack(self._actions))
        g.create_dataset("rewards", data=np.stack(self._rewards))
        success = np.stack(self._success)
        g.create_dataset("success", data=success)
        if self._states:
            # stack the per-step state dicts along time
            env_states = g.create_group("env_states")
            for top, sub in self._states[0].items():
                tg = env_states.create_group(top)
                for name in sub:
                    tg.create_dataset(
                        name, data=np.stack([s[top][name]
                                             for s in self._states]))
        g.attrs["episode_seed"] = (self._episode_seed
                                   if self._episode_seed is not None else -1)
        g.attrs["elapsed_steps"] = len(self._actions)
        g.attrs["success"] = bool(success[-1].any())
        self._meta.append({
            "episode_id": self._traj_count,
            "episode_seed": self._episode_seed,
            "elapsed_steps": len(self._actions),
            "success": bool(success[-1].any()),
        })
        self._traj_count += 1
        self._reset_buffers()

    def flush_video(self, name: Optional[str] = None, save: bool = True):
        if not save or not self._frames:
            self._frames = []
            return
        name = name or f"episode_{self._traj_count}"
        path = os.path.join(self.output_dir, f"{name}.mp4")
        path = io_utils.save_images_to_mp4(np.stack(self._frames), path,
                                           self.video_fps)
        self._frames = []
        return path

    def close(self):
        if self._file is not None:
            self._file.close()
            with open(self._json_path, "w") as f:
                json.dump({"episodes": self._meta,
                           "env_id": getattr(self.env, "env_id", None)},
                          f, cls=io_utils.NumpyEncoder, indent=1)

    def __getattr__(self, name):
        return getattr(self.env, name)


def merge_trajectories(pattern_or_paths, output_path: str):
    """Merge sharded trajectory .h5 files (a glob pattern or a list of
    paths) into one, ``traj_<i>`` renumbered in order, with the JSON
    sidecars' episodes concatenated."""
    import h5py
    if isinstance(pattern_or_paths, str):
        paths = sorted(glob.glob(pattern_or_paths))
    else:
        paths = list(pattern_or_paths)
    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
    episodes = []
    with h5py.File(output_path, "w") as out:
        idx = 0
        for p in paths:
            with h5py.File(p, "r") as src:
                for key in sorted(src.keys()):
                    src.copy(src[key], out, f"traj_{idx}")
                    idx += 1
            jp = p.replace(".h5", ".json")
            if os.path.exists(jp):
                with open(jp) as f:
                    episodes.extend(json.load(f).get("episodes", []))
    with open(output_path.replace(".h5", ".json"), "w") as f:
        json.dump({"episodes": episodes}, f, indent=1)
    return output_path
