"""AlignFr3Env-v1, static part (port of
gsworld_tpu/envs/tasks/tabletop/franka/align.py): the actors in the order
the physics scene keeps them, and the placement constants of the
episode-init ranges.  Physics, reset and reward come with the physics
step."""

from __future__ import annotations

from gsworld_tpu_torch.envs.tasks.real_fr3 import RealFr3


class AlignFr3Env(RealFr3):
    actor_names = ("dtc_green_can_fr3", "dtc_red_tomato_can_fr3",
                   "spice_rack")
    x_offset = 0.615
    goal_height = 0.068
    green_half_height = 0.065
    red_half_height = 0.05
