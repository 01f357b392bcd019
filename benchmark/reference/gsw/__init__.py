"""A frozen copy of gsworld_tpu_torch's eager modules (see
benchmark/reference/__init__.py)."""
