"""The host's launch of the closed-loop step graph (ms): the mean
``gsw.step.launch`` span (``StepGraph.replay``'s ``graph.replay()``) over
the kept steps of the program's recorded stretch (``benchmark/spans.py``)."""

from benchmark.spans import readings


def read(rec):
    return readings(rec).get("loop_launch_ms")
