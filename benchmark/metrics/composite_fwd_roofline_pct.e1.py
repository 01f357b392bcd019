"""``composite_fwd_roofline_pct``, in the one-env loop, where it moves that cell's own rate
(``env_steps_per_s.e1``, under its own bound): read as ``composite_fwd_roofline_pct``."""

from benchmark.harness import reader

read = reader("composite_fwd_roofline_pct").read
