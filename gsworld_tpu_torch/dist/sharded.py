"""The closed loop with its env axis split over a mesh: one env (and GS
wrapper) per mesh device, each stepping its own block of rows.

    loop = ShardedLoop(wrapper, env_mesh())       # or a bare env
    obs, _ = loop.reset(seed=0)
    obs, reward, terminated, truncated, info = loop.step(
        loop.action_space_sample())

Env i of the sharded loop starts and steps exactly as env i of the loop
it was made from: ``reset(seed)`` draws the whole batch's episode numbers
once on the CPU and hands each shard its rows, and actions are drawn once
for the whole batch and split by rows.  Each shard resets and steps with
its device current (on a graphed card through its wrapper's or env's
reset and step graphs), so shards on different cards run side by side
through asynchronous launches.  Observations come back on the mesh's
first device in env order.  ``loop.scan_steps(actions)`` is the scanned
loop of the split: on the card each shard replays its wrapper's CUDA
graph of the whole step, one host call per shard and step.
"""

from __future__ import annotations

from typing import Optional

import torch

from gsworld_tpu_torch import envs
from gsworld_tpu_torch.dist.mesh import (
    EnvMesh,
    gather_env_axis,
    shard_env_axis,
)
from gsworld_tpu_torch.envs.base import GsBaseEnv
from gsworld_tpu_torch.utils.cuda_graph import device_guard
from gsworld_tpu_torch.wrapper.gs_env import GSWorldWrapper


class ShardedLoop:
    """``loop`` (a ``GSWorldWrapper`` or a bare env made by ``envs.make``)
    split over ``mesh``: the same ``envs.make`` arguments (and the same
    scene and raster arguments) with ``num_envs / len(mesh)`` envs on
    each mesh device; the env's cameras as they are now."""

    def __init__(self, loop, mesh: EnvMesh):
        wrapper = loop if isinstance(loop, GSWorldWrapper) else None
        env: GsBaseEnv = loop.env if wrapper is not None else loop
        if not hasattr(env, "make_kwargs"):
            raise ValueError("a sharded loop remakes the env: build it "
                             "with envs.make")
        n = len(mesh)
        if env.num_envs % n:
            raise ValueError(f"{env.num_envs} envs do not split over "
                             f"{n} devices")
        self.env = env
        self.mesh = mesh
        self.num_envs = env.num_envs
        self.cameras = env.cameras
        self.shards = []
        for dev in mesh:
            kw = dict(env.make_kwargs, num_envs=env.num_envs // n,
                      device=dev)
            e = envs.make(env.env_id, **kw)
            e.cameras = list(env.cameras)
            e.human_render_cameras = list(env.human_render_cameras)
            self.shards.append(
                e if wrapper is None else GSWorldWrapper(
                    e, wrapper.scene_gs_cfg_name, **wrapper.render_kwargs))
        self._wrapped = wrapper is not None
        self._action_gen: Optional[torch.Generator] = None

    @property
    def action_dim(self) -> int:
        return self.env.action_dim

    def _shard_env(self, shard) -> GsBaseEnv:
        return shard.env if self._wrapped else shard

    def _gather(self, parts):
        return gather_env_axis(parts, self.mesh[0])

    def action_space_sample(self,
                            generator: Optional[torch.Generator] = None):
        """Uniform actions in [-1, 1) for all envs, (B, action_dim), on the
        mesh's first device, from ``generator`` or the loop's own CPU
        generator, which ``reset(seed)`` seeds as an env's own."""
        if generator is None:
            if self._action_gen is None:
                self._action_gen = torch.Generator().manual_seed(0)
            generator = self._action_gen
        a = torch.rand((self.num_envs, self.action_dim), generator=generator,
                       device=generator.device) * 2.0 - 1.0
        return a.to(self.mesh[0])

    def reset(self, seed: Optional[int] = None):
        seed = 0 if seed is None else seed
        self._action_gen = torch.Generator().manual_seed(seed + 1)
        n = len(self.mesh)
        # the whole batch's draws, each shard its rows (on the CPU)
        draws = [d.tensor_split(n) for d in self.env.reset_draws(seed)]
        out = []
        for i, (shard, dev) in enumerate(zip(self.shards, self.mesh)):
            # each shard's reset graph (wrapper or env) on a graphed card
            with device_guard(dev):
                out.append(shard._reset_from_draws(*(d[i] for d in draws)))
        return self._gather(out), {}

    def step(self, action):
        action = torch.as_tensor(action, dtype=torch.float32)
        if action.ndim == 1:
            action = action.expand(self.num_envs, -1)
        parts = shard_env_axis(action, self.mesh)
        outs = []
        for shard, dev, a in zip(self.shards, self.mesh, parts):
            with device_guard(dev):
                outs.append(shard.step(a))
        return tuple(self._gather([o[k] for o in outs]) for k in range(5))

    def scan_steps(self, actions):
        """The scanned loop of the split (the JAX package's ``use_scan``
        with ``shard``): ``actions`` (n, B, A) for all envs, split by rows
        and copied to each shard's device once, then per step each
        shard's actions copied into its graph and its graph replayed, one
        shard after another, each with its device current (one host call
        per shard and step) -> (env 0's first-camera frames (n, H, W, 3)
        uint8 from shard 0, each step's first-camera rgb mean over all
        envs) (``rollout.random_actions.scan_shards``)."""
        from gsworld_tpu_torch.rollout.random_actions import scan_shards
        if not self._wrapped:
            raise ValueError("the scanned loop renders: split a "
                             "GSWorldWrapper, not a bare env")
        parts = [p.to(dev) for p, dev in zip(
            torch.as_tensor(actions, dtype=torch.float32).tensor_split(
                len(self.mesh), dim=1), self.mesh)]
        return scan_shards(self.shards, parts)

    @property
    def state(self):
        """The env state of all envs on the mesh's first device."""
        return self._gather([self._shard_env(s).state for s in self.shards])
