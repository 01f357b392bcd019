"""The one traffic generator: it reads a traffic file's parameters and
draws from ``--seed`` with NumPy, one stream per use, so that one seed
gives the same inputs every time and the sizes never depend on it.

A closed loop's traffic file:
  ``num_envs``        envs stepped as one batch;
  ``episode_steps``   steps between two resets of every env;
  ``actions``         ``{"low": l, "high": h}``: each step's (num_envs,
                      action_dim) actions uniform in [l, h), the
                      normalized action space the env's controller maps
                      onto its joint targets (ManiSkill's
                      ``action_space.sample()``);
  ``warmup_steps``    steps of set-up after the first reset;
  ``trace_steps``     steps profiled in a ``--trace 1`` run;
  ``check``           what the correctness check samples (``steps``,
                      ``envs``) and the limits of its numbers.

A training cell's traffic file: ``trace_iters`` (iterations profiled in
a ``--trace 1`` run) and ``check`` (its limits); its inputs are the
configuration's views and initial points, drawn from the seed in
``reference/train_3dgs.py``.
"""

from __future__ import annotations

import numpy as np

from benchmark.harness import episode_seed, seed_rng


class ActionStream:
    """Actions of one run: ``next()`` -> (num_envs, action_dim) float32."""

    def __init__(self, seed: int, traffic: dict, action_dim: int):
        self.rng = seed_rng(seed, "actions")
        self.shape = (int(traffic["num_envs"]), int(action_dim))
        self.low = float(traffic["actions"]["low"])
        self.high = float(traffic["actions"]["high"])

    def next(self) -> np.ndarray:
        return self.rng.uniform(self.low, self.high,
                                self.shape).astype(np.float32)


class EpisodeSeeds:
    """The reset seeds of one run, one per episode."""

    def __init__(self, seed: int):
        self.rng = seed_rng(seed, "episodes")

    def next(self) -> int:
        return episode_seed(self.rng)


class Reservoir:
    """A uniform sample of ``k`` of the items offered, whatever their
    number, drawn from ``seed`` (Algorithm R)."""

    def __init__(self, k: int, seed: int, stream: str = "check"):
        self.k = k
        self.rng = seed_rng(seed, stream)
        self.items = []
        self.seen = 0

    def offer(self, make_item) -> None:
        """Offer the next item; ``make_item()`` is called only when it is
        kept."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(make_item())
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.k:
            self.items[j] = make_item()
