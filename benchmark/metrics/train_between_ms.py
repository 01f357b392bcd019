"""Device time between two train steps (ms): from one train step graph's
*end* stamp to the next one's *begin* stamp (the loss read, the step's
scalars, the camera and target copies, the launch), over the read
iterations of the program's recorded stretch (``benchmark/spans.py``)."""

from benchmark.spans import readings


def read(rec):
    return readings(rec).get("train_between_ms")
