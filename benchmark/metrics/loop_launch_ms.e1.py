"""``loop_launch_ms``, in the one-env loop, where it moves that cell's own rate
(``env_steps_per_s.e1``, under its own bound): read as ``loop_launch_ms``."""

from benchmark.harness import reader

read = reader("loop_launch_ms").read
