"""The closed loop of a configuration that makes its env with keyword
arguments of its own (``env_kwargs``, such as ``domain_randomization``):
the same loop as ``closed_loop.py``, through the same
``GSWorldWrapper.step`` call, a reset of every env at each episode's end
(with the randomization's fresh draws) and the same sampled check, with
``env_kwargs`` passed to ``envs.make`` on the program's side and to the
reference's (``reference/closed_loop_dr.py``).  ``closed_loop.Driver``
makes its env inside ``setup``, so ``setup`` is restated here with the
keyword arguments added."""

from __future__ import annotations

import dataclasses

from benchmark.drivers import closed_loop
from benchmark.traffic import ActionStream, EpisodeSeeds


class Driver(closed_loop.Driver):
    def setup(self):
        from gsworld_tpu_torch import envs
        from gsworld_tpu_torch.render.camera import RasterConfig
        from gsworld_tpu_torch.wrapper.gs_env import GSWorldWrapper
        c, r = self.config, self.config["raster"]
        env = envs.make(c["env_id"], num_envs=int(self.traffic["num_envs"]),
                        obs_mode=c["obs_mode"], control_mode=c["control_mode"],
                        sim_config=dict(sim_freq=c["sim_freq"],
                                        control_freq=c["control_freq"]),
                        device=self.device, **c["env_kwargs"])
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

    def reference_loop(self, tf32=False):
        """The reference of this configuration, its env made with the
        configuration's ``env_kwargs`` (the fp32 one made once)."""
        from benchmark.reference.closed_loop_dr import LoopReference
        if tf32:
            return LoopReference(self.config, int(self.traffic["num_envs"]),
                                 self.device, tf32=True)
        if self.reference is None:
            self.reference = LoopReference(
                self.config, int(self.traffic["num_envs"]), self.device)
        return self.reference
