"""The task envs the benchmark's configurations name."""

from benchmark.reference.gsw.envs.registry import make  # noqa: F401
from benchmark.reference.gsw.envs.tasks.tabletop.franka import (  # noqa: F401
    align,
)
