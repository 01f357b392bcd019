"""Tracing / profiling (port of gsworld_tpu/utils/profiling.py), and the
port's own recording of where a step's time goes.

- ``trace(log_dir)``: context manager around ``torch.profiler`` (the CPU,
  and the card's kernels where CUDA is available); on exit it writes a
  Chrome trace, ``<log_dir>/trace.json``, viewable in Perfetto or
  chrome://tracing.  The profiler object is yielded for
  ``key_averages()``.
- ``StepTimer``: per-phase wall-clock stats with an FPS summary.
- ``span(name)``: a host span (name, start, end on ``perf_counter_ns``,
  parent, sequence id) kept in memory by the active ``recording()``.
  With no recording and no profiler running it costs one flag check;
  while a ``torch.profiler`` runs it also opens a ``record_function``
  range of the same name, so a profile holds the program's spans on the
  device trace's own clock.
- ``stamp(tag, device)``: a one-thread kernel (csrc/stamp.cu) that writes
  ``(tag, %globaltimer)`` into the card's stamp ring.  Being a kernel, it
  is captured into a CUDA graph and replays with it, with no host work
  at replay and no switch at capture: the graphs are the same whether or
  not anything is recorded.  ``Recording.device_spans`` drains the ring
  and pairs consecutive stamps into device spans on the host's clock,
  placed there by an anchor stamp at the recording's entry and exit that
  waits for a flag the host sets between two reads of its clock.
- ``counters``: one registry of integer counters by group
  (``kernel_launches/<kernel>``, ``graph.captures/<what>``,
  ``graph.replays/<what>``, ``host.sync/<site>``, ``stamps/lost``,
  ``dr.draws/<env>``).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch.autograd.profiler as _autograd_profiler


@contextlib.contextmanager
def trace(log_dir: str = "./gsworld_trace"):
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Accumulates per-phase timings; phases nest freely."""

    def __init__(self):
        self._acc: Dict[str, list] = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._acc[name].append(time.perf_counter() - t0)

    def fps(self, name: str, per_call_items: int = 1) -> float:
        ts = self._acc.get(name, [])
        total = sum(ts)
        return len(ts) * per_call_items / total if total else 0.0

    def summary(self) -> Dict[str, dict]:
        out = {}
        for name, ts in self._acc.items():
            arr = np.asarray(ts)
            out[name] = {
                "count": len(arr),
                "total_s": float(arr.sum()),
                "mean_ms": float(arr.mean() * 1e3),
                "p50_ms": float(np.percentile(arr, 50) * 1e3),
                "p95_ms": float(np.percentile(arr, 95) * 1e3),
            }
        return out

    def print_summary(self):
        for name, s in sorted(self.summary().items()):
            print(f"{name:30s} n={s['count']:5d} mean={s['mean_ms']:8.2f}ms "
                  f"p95={s['p95_ms']:8.2f}ms total={s['total_s']:7.2f}s")


# --------------------------------------------------------------------- #
# counters
# --------------------------------------------------------------------- #

class Counters:
    """Integer counters by group.  ``group(name)`` is the group's own
    plain dict (``utils/kernels.launch_counts`` is the
    ``kernel_launches`` group); ``snapshot()`` flattens every group into
    ``{"<group>/<key>": n}``."""

    def __init__(self):
        self.groups: Dict[str, Dict[str, int]] = {}

    def group(self, name: str, keys=()) -> Dict[str, int]:
        g = self.groups.setdefault(name, {})
        for k in keys:
            g.setdefault(k, 0)
        return g

    def add(self, group: str, key: str, n: int = 1):
        g = self.groups.setdefault(group, {})
        g[key] = g.get(key, 0) + n

    def snapshot(self) -> Dict[str, int]:
        return {f"{g}/{k}": v for g, d in self.groups.items()
                for k, v in d.items()}


def since(before: Dict[str, int], after: Dict[str, int]) -> Dict[str, int]:
    """The counters that moved from snapshot ``before`` to ``after``."""
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


counters = Counters()


def count(group: str, key: str, n: int = 1):
    counters.add(group, key, n)


def host_waits(site: str, device) -> None:
    """Count one operation at ``site`` that makes the host wait for
    ``device`` (``host.sync/<site>``): on a card; the CPU waits for
    nothing."""
    if device.type == "cuda":
        counters.add("host.sync", site)


# --------------------------------------------------------------------- #
# host spans and the recording
# --------------------------------------------------------------------- #

class SpanRecord(NamedTuple):
    name: str
    start_ns: int       # time.perf_counter_ns()
    end_ns: int
    parent: int         # seq of the span open around it, -1 for none
    seq: int            # order of entry within the recording


class DeviceSpan(NamedTuple):
    name: str           # DEVICE_SPANS' name of the pair, else "<a>..<b>"
    start_ns: int       # on the host's perf_counter_ns clock
    end_ns: int


class Gap(NamedTuple):
    span: DeviceSpan    # a stretch from one graph's end to the next begin
    host: str           # the innermost host span open at its midpoint


# the stamp tags; a ring entry holds its index
STAMP_TAGS = ("anchor",
              "loop.begin", "loop.physics|render", "loop.end",
              "train.begin", "train.forward|backward",
              "train.backward|update", "train.end",
              "reset.begin", "reset.end")
_TAG_INDEX = {t: i for i, t in enumerate(STAMP_TAGS)}
# consecutive stamps -> the device span between them
DEVICE_SPANS = {
    ("loop.begin", "loop.physics|render"): "loop.physics",
    ("loop.physics|render", "loop.end"): "loop.render",
    ("loop.end", "loop.begin"): "loop.between",
    ("train.begin", "train.forward|backward"): "train.forward",
    ("train.forward|backward", "train.backward|update"): "train.backward",
    ("train.backward|update", "train.end"): "train.update",
    ("train.end", "train.begin"): "train.between",
    ("reset.begin", "reset.end"): "loop.reset",
}
# the device spans from one step graph's end to the next one's begin
# (a reset between two loop steps lies inside their "between")
BETWEEN = ("loop.between", "train.between")
MAX_SPANS = 1 << 18


class _State:
    active: Optional["Recording"] = None
    pinned = None                     # the anchor flag's pinned tensor
    flag = None                       # and its NumPy view


class _NoSpan:
    """The span handed out while nothing records and no profiler runs."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("rec", "name", "parent", "seq", "start", "range")

    def __init__(self, rec, name):
        self.rec, self.name, self.range = rec, name, None

    def __enter__(self):
        rec = self.rec
        if rec is not None:
            self.parent = rec._open[-1] if rec._open else -1
            self.seq = rec._seq
            rec._seq += 1
            rec._open.append(self.seq)
        if _autograd_profiler._is_profiler_enabled:
            self.range = _autograd_profiler.record_function(self.name)
            self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        rec = self.rec
        if rec is not None:
            rec._open.pop()
            if len(rec.spans) < rec.limit:
                rec.spans.append(SpanRecord(self.name, self.start, end,
                                            self.parent, self.seq))
            else:
                rec.dropped += 1
        return False


def span(name: str):
    """A host span of ``name`` around a ``with`` block, kept by the active
    recording; a no-op object when nothing records and no profiler
    runs."""
    rec = _State.active
    if rec is None and not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(rec, name)


class Entries(NamedTuple):
    """Stamps drained from a ring: tag names, device times (ns) and ring
    sequence numbers, in order, and how many were lost to overrun."""
    tags: List[str]
    ns: np.ndarray
    slots: np.ndarray
    lost: int


class Recording:
    """What one ``recording()`` saw: host spans (``spans``, at most
    ``limit``; ``dropped`` counts the rest), the counters that moved
    (``counts()``) and, on a card, the device stamps of its stretch
    (``device_spans()``), placed on the span clock by an anchor stamp
    taken at entry and at exit."""

    def __init__(self, device=None, limit: int = MAX_SPANS):
        self.device = device          # the card whose stamps it reads
        self.limit = limit
        self.spans: List[SpanRecord] = []
        self.dropped = 0
        self._open: List[int] = []
        self._seq = 0
        self.counters_before = counters.snapshot()
        self.counters_after: Optional[Dict[str, int]] = None
        self.first_slot = 0           # the ring's count at entry
        # (ring sequence number of the anchor stamp, host ns before its
        # launch, host ns after the sync that followed it)
        self.anchor_windows: List[Tuple[int, int, int]] = []
        self.entries: Optional[Entries] = None
        self.anchor_error_ns = 0.0

    def counts(self) -> Dict[str, int]:
        """The counters that moved inside the recording (so far, while it
        is open)."""
        after = (counters.snapshot() if self.counters_after is None
                 else self.counters_after)
        return since(self.counters_before, after)

    def _anchor(self, warm: bool):
        """An anchor stamp -> its ring sequence number; its host window
        goes to ``anchor_windows``.  The stamp waits on a flag in pinned
        host memory that the host sets between two reads of its clock
        (``stamp_on_flag``).  Where the host set the flag so late that the
        stamp may have given up waiting (ANCHOR_TIMEOUT_NS), the window is
        the whole call to the sync after it.  ``warm`` first launches a
        stamp outside the recording's stretch, which loads the kernels
        (the first launch in a process takes milliseconds)."""
        import torch
        dev = self.device
        if warm:
            stamp("anchor", dev)
        torch.cuda.synchronize(dev)
        slot = int(stamp_ring(dev)[0])
        flag = _flag()
        flag[0] = 0
        t_call = time.perf_counter_ns()
        stamp_on_flag("anchor", dev)
        time.sleep(ANCHOR_LEAD_S)
        t0 = time.perf_counter_ns()
        flag[0] = 1
        t1 = time.perf_counter_ns() + FLAG_READ_NS
        torch.cuda.synchronize(dev)
        if t0 - t_call >= ANCHOR_TIMEOUT_NS:
            t0, t1 = t_call, time.perf_counter_ns()
        self.anchor_windows.append((slot, t0, t1))
        return slot

    def _drain(self) -> Entries:
        """The ring's stamps from entry on (one sync), once."""
        if self.entries is None:
            ring = None
            if self.device is not None:
                import torch
                torch.cuda.synchronize(self.device)
                ring = stamp_ring(self.device).cpu().numpy()
            self.take_ring(ring)
        return self.entries

    def take_ring(self, ring) -> None:
        """Take the stamps of ``ring`` (read to the host; None: no card)
        from the recording's entry on; stamps lost to overrun count as
        ``stamps/lost``, in the registry and among the recording's
        ``counts()``."""
        if ring is None:
            self.entries = Entries([], np.zeros(0, np.int64),
                                   np.zeros(0, np.int64), 0)
            return
        self.entries = ring_entries(ring, self.first_slot)
        if self.entries.lost:
            counters.add("stamps", "lost", self.entries.lost)
            if self.counters_after is not None:
                after = self.counters_after
                after["stamps/lost"] = (after.get("stamps/lost", 0)
                                        + self.entries.lost)

    def device_spans(self) -> List[DeviceSpan]:
        """Consecutive stamps of the stretch paired into device spans
        (``DEVICE_SPANS``' names), on the span clock; none on the CPU."""
        e = self._drain()
        if not e.tags:
            return []
        anchors = []
        for slot, t0, t1 in self.anchor_windows:
            hit = np.nonzero(e.slots == slot)[0]
            if hit.size:
                anchors.append((int(e.ns[hit[0]]), t0, t1))
        to_host, self.anchor_error_ns = anchor_map(anchors)
        return [DeviceSpan(n, to_host(s), to_host(t))
                for n, s, t in pair_stamps(e.tags, e.ns)]

    def attribute_gaps(self) -> List[Gap]:
        """For each stretch of the device timeline from one graph's end to
        the next one's begin (``BETWEEN``), the innermost host span open
        at its midpoint."""
        return [Gap(d, innermost(self.spans, (d.start_ns + d.end_ns) // 2))
                for d in self.device_spans() if d.name in BETWEEN]


@contextlib.contextmanager
def recording(device=None):
    """Record host spans, counters and (on a card) device stamps over the
    block -> the ``Recording``.  ``device``: the card whose stamp ring is
    read, by default the current card where CUDA is available; on the
    CPU only spans and counters are recorded.  One recording at a time,
    on the thread that opened it."""
    import torch
    if _State.active is not None:
        raise RuntimeError("a recording is already open")
    if device is None and torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    elif device is not None:
        device = torch.device(device)
        if device.type != "cuda":
            device = None
    rec = Recording(device)
    if device is not None:
        rec.first_slot = rec._anchor(warm=True)
    _State.active = rec
    try:
        yield rec
    finally:
        _State.active = None
        if device is not None:
            rec._anchor(warm=False)
        rec.counters_after = counters.snapshot()


def innermost(spans: List[SpanRecord], t_ns: int) -> str:
    """The name of the innermost span open at ``t_ns`` (the latest
    entered of those around it)."""
    best = None
    for s in spans:
        if s.start_ns <= t_ns <= s.end_ns and (best is None
                                               or s.seq > best.seq):
            best = s
    return best.name if best is not None else "outside every span"


def pair_stamps(tags: List[str], ns) -> List[Tuple[str, int, int]]:
    """Consecutive stamps -> (name, start ns, end ns): the pair's name in
    DEVICE_SPANS, else ``"<a>..<b>"``; pairs with an anchor are left
    out.  Where resets lie between two loop steps, the first step's end
    to the next one's begin is also their ``loop.between``."""
    out = []
    for i in range(1, len(tags)):
        a, b = tags[i - 1], tags[i]
        if "anchor" in (a, b):
            continue
        out.append((DEVICE_SPANS.get((a, b), f"{a}..{b}"), int(ns[i - 1]),
                    int(ns[i])))
        if (a, b) == ("reset.end", "loop.begin"):
            j = i - 1
            while j > 0 and tags[j].startswith("reset."):
                j -= 1
            if tags[j] == "loop.end":
                out.append(("loop.between", int(ns[j]), int(ns[i])))
    return out


def anchor_map(anchors: List[Tuple[int, int, int]]):
    """(device ns of an anchor stamp, and the host window (ns, ns) it lies
    in) for up to two anchors -> (device ns -> host ns, the anchor's
    error in ns: half its widest host window).  Two anchors far
    enough apart also correct the rate of the device clock against the
    host's."""
    if not anchors:
        raise ValueError("no anchor stamp survived: the device spans "
                         "cannot be placed on the host's clock")
    pts = [(g, 0.5 * (t0 + t1), 0.5 * (t1 - t0)) for g, t0, t1 in anchors]
    g0, h0, e0 = pts[0]
    rate, err = 1.0, e0
    if len(pts) > 1:
        g1, h1, e1 = pts[-1]
        err = max(e0, e1)
        if g1 > g0 and h1 - h0 > 1000.0 * (e0 + e1):
            rate = (h1 - h0) / (g1 - g0)
    return (lambda g: int(round(h0 + (int(g) - g0) * rate))), err


# --------------------------------------------------------------------- #
# device stamps
# --------------------------------------------------------------------- #

# the anchor: the host sets the flag ANCHOR_LEAD_S after the launch (the
# stamp is spinning by then); the card reads the flag across the bus
# within about FLAG_READ_NS of the write; it stops waiting after
# ANCHOR_TIMEOUT_NS
ANCHOR_LEAD_S = 0.001
FLAG_READ_NS = 2_000
ANCHOR_TIMEOUT_NS = 200_000_000


def _flag():
    """The process's anchor flag: one int32 in pinned host memory, as a
    NumPy view."""
    if _State.flag is None:
        import torch
        _State.pinned = torch.zeros(1, dtype=torch.int32).pin_memory()
        _State.flag = _State.pinned.numpy()
    return _State.flag


# the ring: 8192 words of 8 bytes (64 KiB); word 0 counts the stamps, and
# entry i of RING_SLOTS sits at words 2 + 2i (sequence << 8 | tag) and
# 3 + 2i (%globaltimer, ns)
RING_WORDS = 8192
RING_SLOTS = RING_WORDS // 2 - 1
_rings: Dict[int, "object"] = {}


def stamp_ring(device):
    """The card's stamp ring (int64 (RING_WORDS,)), made at its first use,
    which must lie outside any capture (``utils.cuda_graph.capture``
    makes it before it captures)."""
    import torch
    device = torch.device(device)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    ring = _rings.get(index)
    if ring is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the stamp ring must be made before a "
                               "capture")
        ring = _rings[index] = torch.zeros(
            RING_WORDS, dtype=torch.int64, device=torch.device("cuda", index))
    return ring


def ring_entries(ring, first: int) -> Entries:
    """The stamps of a ring read to the host (int64 (RING_WORDS,)) with
    sequence numbers from ``first`` on, oldest first; those overwritten
    since are counted as lost."""
    n = int(ring[0])
    lo = max(first, n - RING_SLOTS)
    seq = np.arange(lo, n, dtype=np.int64)
    idx = 2 + 2 * (seq % RING_SLOTS)
    word, ns = ring[idx], ring[idx + 1]
    if not np.array_equal(word >> 8, seq):
        raise RuntimeError("the stamp ring holds entries out of sequence")
    return Entries([STAMP_TAGS[int(t)] for t in word & 0xFF], ns, seq,
                   lo - first)


def stamp(tag: str, device) -> None:
    """Launch one stamp of ``tag`` (one of STAMP_TAGS) on ``device``'s
    current stream: a one-thread kernel that writes the tag and the
    card's %globaltimer into its ring.  Captured with the work around it,
    it replays with every replay of the graph.  A no-op on the CPU."""
    if device.type != "cuda":
        return
    import torch
    from gsworld_tpu_torch.utils import kernels
    lib = kernels.build_kernels()
    with torch.cuda.device(device):
        ring = stamp_ring(device)
        kernels.check(lib, lib.gsw_stamp(
            ring.data_ptr(), _TAG_INDEX[tag], RING_SLOTS,
            torch.cuda.current_stream(device).cuda_stream), "stamp")


def stamp_on_flag(tag: str, device) -> None:
    """Launch one stamp of ``tag`` that waits until the anchor flag
    (``_flag()``) is set, or ANCHOR_TIMEOUT_NS; raises where the flag
    cannot be mapped into the card's address space."""
    import torch
    from gsworld_tpu_torch.utils import kernels
    lib = kernels.build_kernels()
    _flag()
    with torch.cuda.device(device):
        kernels.check(lib, lib.gsw_stamp_on_flag(
            stamp_ring(device).data_ptr(), _State.pinned.data_ptr(),
            _TAG_INDEX[tag], RING_SLOTS, ANCHOR_TIMEOUT_NS,
            torch.cuda.current_stream(device).cuda_stream), "stamp on flag")
