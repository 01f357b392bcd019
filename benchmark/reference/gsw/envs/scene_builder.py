"""Table scene builder (port of gsworld_tpu/envs/scene_builder.py): a table
box with half sizes (2.418/2, 1.209/2, 0.9196429/2) whose top surface sits
at z=0, centered at ``x_offset``; ground plane at -table_height.  The table
top is a *bounded* contact plane (objects past the edge fall to the ground
plane)."""

from __future__ import annotations

import dataclasses

import numpy as np

TABLE_HALF = (2.418 / 2.0, 1.209 / 2.0, 0.9196429 / 2.0)
TABLE_HEIGHT = 0.9196429


@dataclasses.dataclass(frozen=True)
class TableSceneBuilderOffset:
    """Static plane set for the offset tabletop world."""

    x_offset: float = 0.615
    robot_init_qpos_noise: float = 0.02

    def planes(self) -> np.ndarray:
        """(P, 8) bounded planes: the tabletop (top at z=0, finite extent
        centered at x_offset) and the infinite ground at -table_height."""
        cx = self.x_offset
        hx, hy, _ = TABLE_HALF
        table = [0.0, 0.0, 1.0, 0.0, cx - hx, cx + hx, -hy, hy]
        inf = 1e9
        ground = [0.0, 0.0, 1.0, TABLE_HEIGHT, -inf, inf, -inf, inf]
        return np.asarray([table, ground], np.float32)

    def robot_root_pose(self, z: float = 0.0):
        return np.asarray([self.x_offset - 0.615, 0.0, z], np.float32)
