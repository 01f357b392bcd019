"""``env_steps_per_s`` of the one-env loop, under a bound of its own (its
runs spread more than the 64-env loop's): read as ``env_steps_per_s``."""

from benchmark.harness import reader

read = reader("env_steps_per_s").read
