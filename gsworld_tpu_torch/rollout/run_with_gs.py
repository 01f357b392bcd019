"""Motion-planning demo collection with GS rendering (port of
gsworld_tpu/rollout/run_with_gs.py): build the env + GSWorldWrapper +
RecordEpisode, loop the task's scripted solution over seeds until
``num_traj`` episodes pass, and track the success rate, the failed-plan
rate and the episode lengths.  ``shard_index`` / ``num_shards`` partition
the seeds between processes; ``merge_trajectories`` joins their files.

    python -m gsworld_tpu_torch.rollout.run_with_gs -e AlignFr3Env-v1 -n 1

Runs on the card unless ``--device cpu`` is given.  Writes
``<output_dir>/trajectory.h5`` (needs ``h5py``), its JSON sidecar and,
with ``--save_video``, one video per kept episode.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np


def collect(env_id: str = "AlignFr3Env-v1", cfg_name: str = "fr3_align",
            num_traj: int = 5, only_count_success: bool = False,
            output_dir: str = "./demos", save_video: bool = False,
            sim_freq: int = 100, control_freq: int = 20,
            width: int = 160, height: int = 120,
            synthetic_scale: float = 0.1, seed0: int = 0,
            shard_index: int = 0, num_shards: int = 1,
            render_gs: bool = True, max_seeds: Optional[int] = None,
            verbose: bool = True, device="cuda"):
    """-> stats dict (num_traj, tried, success_rate, failed_plan_rate,
    avg_episode_len).  One env in ``pd_joint_pos`` with ``obs_mode="rgb"``;
    with ``render_gs`` its cameras are resized to width x height and
    every reset and step is rendered through the synthetic scene of
    ``cfg_name`` at ``synthetic_scale`` of the full sizes."""
    import dataclasses

    from gsworld_tpu_torch import envs
    from gsworld_tpu_torch.render.camera import RasterConfig
    from gsworld_tpu_torch.rollout.planner.solutions import SOLUTIONS
    from gsworld_tpu_torch.rollout.record import RecordEpisode
    from gsworld_tpu_torch.wrapper.gs_env import GSWorldWrapper

    env = envs.make(env_id, num_envs=1, obs_mode="rgb",
                    control_mode="pd_joint_pos",
                    sim_config=dict(sim_freq=sim_freq,
                                    control_freq=control_freq),
                    device=device)
    target = env
    if render_gs:
        env.cameras = [dataclasses.replace(c, width=width, height=height)
                       for c in env.cameras]
        # the JAX package also sets max_per_tile and tile_chunk, fields of
        # its dense XLA raster path, which the port does not have
        target = GSWorldWrapper(
            env, cfg_name,
            raster_config=RasterConfig(width=width, height=height),
            synthetic_sizes=dict(n_background=int(120_000 * synthetic_scale),
                                 n_per_link=int(6_000 * synthetic_scale),
                                 n_per_object=int(6_000 * synthetic_scale)),
            device=device)
    rec = RecordEpisode(target, output_dir, save_trajectory=True,
                        save_video=save_video,
                        trajectory_name=f"trajectory.{shard_index}"
                        if num_shards > 1 else "trajectory")
    solve = SOLUTIONS[env_id]

    passed = 0
    tried = 0
    failed_plans = 0
    ep_lens = []
    seed = seed0 + shard_index
    t0 = time.time()
    while passed < num_traj:
        if max_seeds is not None and tried >= max_seeds:
            break
        res = solve(rec, seed=seed, debug=False, vis=False)
        tried += 1
        if res == -1:
            failed_plans += 1
            rec.flush_trajectory(save=False)
            rec.flush_video(save=False)
        else:
            obs, reward, terminated, truncated, info = res
            success = bool(info["success"].any())
            keep = success or not only_count_success
            rec.flush_trajectory(save=keep)
            rec.flush_video(name=f"episode_seed{seed}", save=keep and save_video)
            if success:
                passed += 1
                ep_lens.append(int(rec.env.state.elapsed[0]))
            elif not only_count_success:
                passed += 1
        seed += num_shards
        if verbose:
            print(f"[{env_id}] tried={tried} passed={passed} "
                  f"failed_plans={failed_plans} "
                  f"elapsed={time.time()-t0:.1f}s", flush=True)
    rec.close()
    executed = tried - failed_plans  # episodes whose plan produced steps
    stats = {
        "num_traj": passed, "tried": tried,
        "success_rate": passed / executed if executed else 0.0,
        "failed_plan_rate": failed_plans / max(tried, 1),
        "avg_episode_len": float(np.mean(ep_lens)) if ep_lens else None,
    }
    if verbose:
        print(stats)
    return stats


class GaussianPlanningRunner:
    """Config-dict driven demo-collection runner."""

    DEFAULTS = dict(env_id="AlignFr3Env-v1", cfg_name="fr3_align",
                    num_traj=5, only_count_success=True,
                    output_dir="./demos", save_video=False,
                    sim_freq=100, control_freq=20, seed0=0,
                    render_gs=True)

    def __init__(self, config: Optional[dict] = None):
        self.config = dict(self.DEFAULTS)
        if config:
            self.config.update(config)

    def run(self):
        return collect(**self.config)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--env_id", "-e", default="AlignFr3Env-v1")
    p.add_argument("--cfg_name", default="fr3_align")
    p.add_argument("--num_traj", "-n", type=int, default=5)
    p.add_argument("--only-count-success", action="store_true")
    p.add_argument("--output_dir", default="./demos")
    p.add_argument("--save_video", action="store_true")
    p.add_argument("--sim_freq", type=int, default=100)
    p.add_argument("--control_freq", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-gs", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    return collect(env_id=args.env_id, cfg_name=args.cfg_name,
                   num_traj=args.num_traj,
                   only_count_success=args.only_count_success,
                   output_dir=args.output_dir, save_video=args.save_video,
                   sim_freq=args.sim_freq, control_freq=args.control_freq,
                   seed0=args.seed, render_gs=not args.no_gs,
                   device=args.device)


if __name__ == "__main__":
    main()
