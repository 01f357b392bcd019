"""``kernels_per_step.loop``, in the one-env loop, where it moves that cell's own rate
(``env_steps_per_s.e1``, under its own bound): read as ``kernels_per_step.loop``."""

from benchmark.harness import reader

read = reader("kernels_per_step.loop").read
