"""Device time between two closed-loop steps (ms): from one step graph's
*end* stamp to the next one's *begin* stamp, over the kept steps of the
program's recorded stretch (``benchmark/spans.py``): the host's turn
(the action copy, the state load, the launch, the clones, the caller)."""

from benchmark.spans import readings


def read(rec):
    return readings(rec).get("loop_between_ms")
