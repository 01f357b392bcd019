"""See the package docstring of gsworld_tpu_torch."""
