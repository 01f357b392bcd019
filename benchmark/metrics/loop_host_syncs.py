"""Operations per closed-loop step that make the host wait for the card:
the program's ``host.sync/*`` counters over the kept steps of its
recorded stretch (``benchmark/spans.py``)."""

from benchmark.spans import readings


def read(rec):
    return readings(rec).get("loop_host_syncs")
