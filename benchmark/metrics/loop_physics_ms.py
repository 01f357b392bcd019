"""The physics inside the closed-loop step graph (ms): from the graph's
*begin* stamp to its *physics|render* stamp (``env._step_fn``: control,
physics, FK, task state, reward), over the kept steps of the program's
recorded stretch (``benchmark/spans.py``)."""

from benchmark.spans import readings


def read(rec):
    return readings(rec).get("loop_physics_ms")
