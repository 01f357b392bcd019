"""``device_idle_pct.loop``, in the one-env loop, where it moves that cell's own rate
(``env_steps_per_s.e1``, under its own bound): read as ``device_idle_pct.loop``."""

from benchmark.harness import reader

read = reader("device_idle_pct.loop").read
