"""The render inside the closed-loop step graph (ms): from its
*physics|render* stamp to its *end* stamp (the GS render of every env
and camera, and the state copy), over the kept steps of the program's
recorded stretch (``benchmark/spans.py``)."""

from benchmark.spans import readings


def read(rec):
    return readings(rec).get("loop_render_ms")
