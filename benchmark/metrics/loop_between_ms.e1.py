"""``loop_between_ms``, in the one-env loop, where it moves that cell's own rate
(``env_steps_per_s.e1``, under its own bound): read as ``loop_between_ms``."""

from benchmark.harness import reader

read = reader("loop_between_ms").read
