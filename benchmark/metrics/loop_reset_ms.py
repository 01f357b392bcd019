"""The reset on the device (ms): from the wrapper's reset graph's
*reset.begin* stamp to its *reset.end* stamp (``_reset_and_render``: the
observation of the laid-out state and the GS render of the new episode,
both cameras of every env), over a stretch of resets recorded by the
program (``benchmark/reset_spans.py``)."""

from benchmark.reset_spans import readings


def read(rec):
    return readings(rec).get("loop_reset_ms")
