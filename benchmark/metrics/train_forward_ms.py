"""The train step graph's forward (ms): from its *begin* stamp to its
*forward|backward* stamp (projection, binning, the compositor, the
loss), over the read iterations of the program's recorded stretch
(``benchmark/spans.py``)."""

from benchmark.spans import readings


def read(rec):
    return readings(rec).get("train_forward_ms")
