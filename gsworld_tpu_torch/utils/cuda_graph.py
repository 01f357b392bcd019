"""Every CUDA graph of the port (the env and wrapper step and reset, the
render, the train step and densify, the planner's IK and collision check)
is an ``FnGraph``: one call of a function captured by ``capture``.

``graphed(graph, device)`` is the one place that decides graph or eager:
a call replays a graph where one is asked for (``graph``) on a CUDA
device; the CPU and ``graph=False`` run eagerly.

``capture(body, warm, device, what)`` runs ``warm()`` and then captures
``body()``, both with ``device`` current and on the device's capture
stream, a named side stream: the default capture stream belongs to the
device current at the first capture of the process, so a second card's
graph needs its own; and a memory pool hands a block freed in one
capture only to an allocation on the stream that freed it, so graphs
that share a pool capture on one stream.  The warm-up runs the same work
outside the capture (building the kernels and filling every lazy cache)
on clones.  A capture that fails raises: no caller falls back to eager
work on the card.  The device's stamp ring
(``utils.profiling.stamp_ring``) is made before the capture, so a
captured stamp writes into it; captures and replays are counted
(``graph.captures/<what>``, ``graph.replays/<what>``).

``FnGraph(fn, device, inputs, what)`` is the load -> replay -> clone
plumbing around one capture of ``fn(*inputs)``; ``cached_graph`` builds
one at an owner's first call and keeps it under a key; ``carry`` makes a
step's body carry its state from one replay to the next.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import torch

from gsworld_tpu_torch.utils import profiling


_capture_streams = {}


def graphed(graph: bool, device) -> bool:
    """Whether a call replays a CUDA graph: one asked for (``graph``) on a
    CUDA ``device``."""
    return bool(graph) and torch.device(device).type == "cuda"


def capture(body, warm, device, what: str, pool=None):
    """-> (the ``torch.cuda.CUDAGraph`` of ``body()``, what ``body()``
    returned at capture: the graph's static outputs).  ``pool`` (a
    ``torch.cuda.graph_pool_handle()``) is the memory pool the graph
    shares with others; None gives it its own."""
    with torch.cuda.device(device):
        index = torch.cuda.current_device()
        if index not in _capture_streams:
            _capture_streams[index] = torch.cuda.Stream()
        side = _capture_streams[index]
        profiling.stamp_ring(device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            warm()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=pool, stream=side):
                out = body()
        except RuntimeError as e:
            raise RuntimeError(
                f"{what} did not capture into a CUDA graph: an operation in "
                f"it synchronizes with the host (the traceback above names "
                f"it)") from e
    profiling.count("graph.captures", what)
    return graph, out


def device_guard(device: torch.device):
    """The device made current for CUDA work; nothing for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def tree_map(fn, x):
    """``x`` with ``fn`` applied to every tensor in it: tensors in nested
    dicts, lists, tuples, NamedTuples and dataclasses; anything else
    (None, numbers) kept as it is."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(tree_map(fn, v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(tree_map(fn, v) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: tree_map(fn, getattr(x, f.name))
            for f in dataclasses.fields(x)})
    return x


def clone_tree(x):
    """``x`` in tensors of its own."""
    return tree_map(torch.Tensor.clone, x)


def _pairs(dst, src, path="input"):
    """(dst tensor, src tensor) of two trees of one structure, the shapes
    equal, leaving out what ``dst`` and ``src`` share; another structure
    or shape raises ``ValueError``."""
    if src is dst:
        return
    if isinstance(dst, torch.Tensor):
        if (not isinstance(src, torch.Tensor) or src.shape != dst.shape
                or src.dtype != dst.dtype):
            raise ValueError(
                f"{path}: {getattr(src, 'shape', src)} "
                f"{getattr(src, 'dtype', '')} where the graph holds "
                f"{tuple(dst.shape)} {dst.dtype}")
        yield dst, src
    elif isinstance(dst, dict):
        if not isinstance(src, dict) or set(src) != set(dst):
            raise ValueError(f"{path}: {src!r:.80} where the graph holds "
                             f"the keys {sorted(dst)}")
        for k in dst:
            yield from _pairs(dst[k], src[k], f"{path}.{k}")
    elif isinstance(dst, (tuple, list)):
        if type(src) is not type(dst) or len(src) != len(dst):
            raise ValueError(f"{path}: {type(src).__name__} where the graph "
                             f"holds {type(dst).__name__} of {len(dst)}")
        for i, (d, s) in enumerate(zip(dst, src)):
            yield from _pairs(d, s, f"{path}[{i}]")
    elif dataclasses.is_dataclass(dst):
        if type(src) is not type(dst):
            raise ValueError(f"{path}: {type(src).__name__} where the graph "
                             f"holds {type(dst).__name__}")
        for f in dataclasses.fields(dst):
            yield from _pairs(getattr(dst, f.name), getattr(src, f.name),
                              f"{path}.{f.name}")
    elif (dst is None) != (src is None):
        raise ValueError(f"{path}: {src!r} where the graph holds {dst!r}")


def copy_tree(dst, src):
    """Copy ``src``'s tensors into ``dst``'s (one structure, shapes and
    dtypes, else ``ValueError``); a tensor or subtree that ``dst`` shares
    with ``src`` is left as it is."""
    for d, s in _pairs(dst, src):
        d.copy_(s)


def carry(step_fn):
    """``step_fn(state, *args) -> (new state, *rest)`` as the body of a
    step graph: the new state is copied into ``state`` and returned in its
    place.  Captured on a static state, one replay is one step and n
    replays are n steps."""
    def body(state, *args):
        out = step_fn(state, *args)
        copy_tree(state, out[0])
        return (state, *out[1:])
    return body


class FnGraph:
    """``fn(*inputs)`` captured into one CUDA graph whose static inputs
    are ``inputs`` themselves: tensors in nested dicts, tuples and
    dataclasses, None where a field is absent.  The body may write into
    them (``carry``; a train state updated in place).  A call copies its
    inputs into the static ones (``copy_tree``: what the graph holds
    already is not copied; None leaves that input as it was), replays
    and returns the outputs in tensors of their own, so a call's outputs
    survive the next call.  ``spans`` maps ``load``, ``launch`` and
    ``outputs`` to the names of their host spans
    (``utils.profiling.span``), where they have one.

    Captured by ``capture`` (in ``pool`` when given, under
    ``torch.no_grad``) after WARMUP calls of ``fn`` on clones of the
    inputs, which fill every lazy cache outside the capture and leave the
    inputs as they were.  A failed capture raises: nothing falls back to
    eager work."""

    WARMUP = 2

    def __init__(self, fn, device, inputs, what: str, pool=None,
                 spans=None):
        self.device = torch.device(device)
        self.what = what
        self.spans = spans or {}
        self.inputs = tuple(inputs)

        def warm():
            for _ in range(self.WARMUP):
                fn(*clone_tree(self.inputs))

        with torch.no_grad():
            self.graph, self.outputs = capture(
                functools.partial(fn, *self.inputs), warm, self.device,
                what, pool=pool)

    def _span(self, part):
        name = self.spans.get(part)
        return profiling.span(name) if name else contextlib.nullcontext()

    def load(self, *inputs):
        """Copy ``inputs`` into the graph's static inputs."""
        if len(inputs) != len(self.inputs):
            raise ValueError(f"{len(inputs)} inputs where {self.what} takes "
                             f"{len(self.inputs)}")
        with self._span("load"), device_guard(self.device):
            for dst, src in zip(self.inputs, inputs):
                if src is not None:
                    copy_tree(dst, src)

    def replay(self):
        """One replay of the loaded inputs; the static outputs
        (``outputs``) are overwritten."""
        with device_guard(self.device):
            with self._span("launch"):
                self.graph.replay()
        profiling.count("graph.replays", self.what)

    def __call__(self, *inputs):
        self.load(*inputs)
        self.replay()
        with self._span("outputs"), device_guard(self.device):
            return clone_tree(self.outputs)


def cached_graph(cache: dict, key, fn, device, inputs, what: str,
                 pool=None, spans=None) -> FnGraph:
    """``cache[key]``: the ``FnGraph`` of ``fn`` on ``device``, built at
    the first call on copies of ``inputs`` made there.  On a device where
    nothing captures (``graphed(True, device)`` false) it raises
    ``ValueError``."""
    if not graphed(True, device):
        raise ValueError(f"{what} runs on {device}: only a CUDA call is "
                         f"captured")
    g = cache.get(key)
    if g is None:
        device = torch.device(device)
        with device_guard(device):
            own = tree_map(lambda t: t.to(device, copy=True), tuple(inputs))
        g = cache[key] = FnGraph(fn, device, own, what, pool=pool,
                                 spans=spans)
    return g
