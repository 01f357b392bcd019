"""The closed loop: a user's random-action loop through
``GSWorldWrapper.step``, each step called once the previous step's
observations are ready on the device, every env reset through
``GSWorldWrapper.reset`` at the end of each episode.

Set-up builds the env and its GS wrapper as the configuration states,
resets with the first episode seed (capturing the reset graph), runs the
warm-up steps (capturing the step graph), and resets again with the
second seed, so the window starts an episode with every graph it
replays already captured.  The window steps until ``--seconds`` have
passed; a step is timed from the call until its observations are ready
on the device.  With ``--trace 1`` the window is the first
``trace_steps`` steps of an episode under the profiler.

Samples for the check: the reset that starts the window and the first
reset inside it, the window's last step, and a uniform sample of its
other steps drawn from ``--seed``, as are the envs whose frames are
compared.
"""

from __future__ import annotations

import dataclasses
import gc
import time

import torch
from torch.profiler import record_function

from benchmark import harness as H
from benchmark.reference.closed_loop import Sample, compare
from benchmark.traffic import ActionStream, EpisodeSeeds, Reservoir


class Driver:
    def __init__(self, cell, seed: int, device="cuda"):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = seed
        self.device = torch.device(device)
        self.attempted = 0
        self.failed = 0
        self.reference = self.control = None
        self.seed_streams(seed)

    def seed_streams(self, seed: int):
        """Draw the sample's envs, and start the check's sample afresh,
        from ``seed``."""
        self.seed = seed
        self.samples = []
        check = self.traffic["check"]
        rng = H.seed_rng(seed, "check-envs")
        B = int(self.traffic["num_envs"])
        self.check_envs = sorted(int(i) for i in rng.choice(
            B, size=min(int(check["envs"]), B), replace=False))
        self.reservoir = Reservoir(max(int(check["steps"]) - 1, 0), seed)

    # --- the program ---------------------------------------------------

    def setup(self):
        from gsworld_tpu_torch import envs
        from gsworld_tpu_torch.render.camera import RasterConfig
        from gsworld_tpu_torch.wrapper.gs_env import GSWorldWrapper
        c, r = self.config, self.config["raster"]
        env = envs.make(c["env_id"], num_envs=int(self.traffic["num_envs"]),
                        obs_mode=c["obs_mode"], control_mode=c["control_mode"],
                        sim_config=dict(sim_freq=c["sim_freq"],
                                        control_freq=c["control_freq"]),
                        device=self.device)
        env.cameras = [dataclasses.replace(cam, width=r["width"],
                                           height=r["height"])
                       for cam in env.cameras]
        self.env = env
        self.wrapper = GSWorldWrapper(
            env, c["scene"],
            raster_config=RasterConfig(
                width=r["width"], height=r["height"], tile=r["tile"],
                max_tiles_per_gaussian=r["max_tiles_per_gaussian"],
                max_entries=r["max_entries"]),
            synthetic_sizes=c["synthetic_sizes"], device=self.device)
        self.actions = ActionStream(self.seed, self.traffic, env.action_dim)
        self.episodes = EpisodeSeeds(self.seed)
        self.reset()
        for _ in range(int(self.traffic["warmup_steps"])):
            self.step()
        self.reset(keep=True)
        self.sync()

    def reseed(self, seed: int):
        """Start another seed's inputs on the program as it is set up (the
        control tool reads many seeds in one process)."""
        self.seed_streams(seed)
        self.actions = ActionStream(seed, self.traffic, self.env.action_dim)
        self.episodes = EpisodeSeeds(seed)
        self.reset(keep=True)
        self.sync()

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def next_action(self) -> torch.Tensor:
        return torch.from_numpy(self.actions.next())

    def reset(self, keep: bool = False):
        seed = self.episodes.next()
        with record_function("bench.reset"):
            obs, _ = self.wrapper.reset(seed=seed)
        self.steps_in_episode = 0
        if keep:
            self.samples.append(Sample("reset", seed, None, None,
                                       self.env._state, obs))

    def step(self):
        """One closed-loop step -> its seconds (call to observations
        ready) and the sample's makings."""
        action = self.next_action()
        before = self.env._state
        t0 = time.perf_counter()
        with record_function("bench.step"):
            obs, reward, terminated, truncated, _ = self.wrapper.step(action)
            self.sync()
        dt = time.perf_counter() - t0
        self.steps_in_episode += 1
        self.last = Sample("step", None, before, action, self.env._state,
                           obs, reward, terminated, truncated)
        return dt

    def window(self, rec, seconds: float, trace: bool = False):
        B = int(self.traffic["num_envs"])
        episode = int(self.traffic["episode_steps"])
        resets = 0
        if trace:
            from benchmark.trace import Traced
            n = int(self.traffic["trace_steps"])
            self.traced_states = []
            with Traced() as t:
                for i in range(n):
                    rec.calls.append(self.step())
                    self.traced_states.append(self.env._state)
                    if i < n - 1:
                        self.reservoir.offer(lambda: self.last)
            rec.trace = t.data(n)
            rec.window_s = rec.trace.window_s
        else:
            t_start = time.perf_counter()
            deadline = t_start + seconds
            while time.perf_counter() < deadline:
                if self.steps_in_episode >= episode:
                    self.reset(keep=resets == 0)
                    resets += 1
                rec.calls.append(self.step())
                if time.perf_counter() < deadline:
                    self.reservoir.offer(lambda: self.last)
            rec.window_s = time.perf_counter() - t_start
        self.attempted = len(rec.calls)
        rec.work["env_steps"] = B * len(rec.calls)
        rec.notes["num_envs"] = B
        self.samples += self.reservoir.items + [self.last]

    def peak_bytes(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def release(self):
        """Drop the program: its env, wrapper and graphs."""
        self.env = self.wrapper = self.actions = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # --- the check -----------------------------------------------------

    def reference_loop(self, tf32=False):
        """The reference of this configuration (the fp32 one made once)."""
        from benchmark.reference.closed_loop import LoopReference
        if tf32:
            return LoopReference(self.config, int(self.traffic["num_envs"]),
                                 self.device, tf32=True)
        if self.reference is None:
            self.reference = LoopReference(
                self.config, int(self.traffic["num_envs"]), self.device)
        return self.reference

    def check(self):
        """-> [(name, value, limit)] of the program's samples against the
        reference."""
        self.release()
        prog, _ = compare(self.samples, self.check_envs,
                          self.reference_loop())
        limits = self.traffic["check"]["limits"]
        return [(k, prog[k], float(limits[k])) for k in limits]

    def read_seed(self, seed: int, seconds: float, control: bool) -> dict:
        """Readings of one seed for the limits, on the program as it is
        set up: a short window of the traffic from a fresh episode, then
        the numbers compared, the program's and (with ``control``) the
        control's (the reference in TF32)."""
        self.reseed(seed)
        rec = H.Record(cell=self.cell, seed=seed)
        self.window(rec, seconds)
        if control and self.control is None:
            self.control = self.reference_loop(tf32=True)
        prog, ctrl = compare(self.samples, self.check_envs,
                             self.reference_loop(),
                             self.control if control else None)
        return {"seed": seed, "steps": len(rec.calls),
                "samples": len(self.samples), "program": prog,
                "control": ctrl}
