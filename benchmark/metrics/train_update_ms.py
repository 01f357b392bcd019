"""The train step graph's update (ms): from its *backward|update* stamp
to its *end* stamp (Adam and the densify statistics), over the read
iterations of the program's recorded stretch (``benchmark/spans.py``)."""

from benchmark.spans import readings


def read(rec):
    return readings(rec).get("train_update_ms")
