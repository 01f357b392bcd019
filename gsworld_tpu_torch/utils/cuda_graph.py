"""Capturing one call into a CUDA graph, as every graph of the port is
captured (the env and wrapper step and reset, the render, the train step
and densify, the planner's IK and collision check).

``capture(body, warm, device, what)`` runs ``warm()`` and then captures
``body()``, both with ``device`` current and on the device's capture
stream, a named side stream: the default capture stream belongs to the
device current at the first capture of the process, so a second card's
graph needs its own; and a memory pool hands a block freed in one
capture only to an allocation on the stream that freed it, so graphs
that share a pool capture on one stream.  The warm-up runs the same work
outside the capture (building the kernels and filling every lazy cache)
on the caller's clones.  A capture that fails raises: no caller falls
back to eager work on the card.  The device's stamp ring
(``utils.profiling.stamp_ring``) is made before the capture, so a
captured stamp writes into it; captures and replays are counted
(``graph.captures/<what>``, ``graph.replays/<what>``).

``FnGraph(fn, device, inputs, what)`` is the load -> replay -> clone
plumbing around one capture of a pure function ``fn(*inputs)``.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from gsworld_tpu_torch.utils import profiling


_capture_streams = {}


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
    equal; another structure or shape raises ``ValueError``."""
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


class FnGraph:
    """``fn(*inputs)``, a pure function of tensors, captured into one CUDA
    graph on static copies of ``inputs`` (made at construction; tensors
    in nested dicts, tuples and dataclasses, None where a field is
    absent).  A call copies its inputs into the static ones (the same
    structure and shapes, else ``ValueError``), replays and returns the
    outputs in tensors of their own, so a call's outputs survive the next
    call and the caller's inputs are neither aliased nor written.

    Captured by ``capture`` (in ``pool`` when given) after WARMUP calls of
    ``fn`` on clones of ``inputs``, which fill every lazy cache outside
    the capture.  A failed capture raises: nothing falls back to eager
    work."""

    WARMUP = 2

    def __init__(self, fn, device, inputs, what: str, pool=None):
        self.device = torch.device(device)
        self.what = what
        self.inputs = clone_tree(tuple(inputs))

        def warm():
            for _ in range(self.WARMUP):
                fn(*clone_tree(self.inputs))

        with torch.no_grad():
            self.graph, self.outputs = capture(
                lambda: fn(*self.inputs), warm, self.device, what, pool=pool)

    def load(self, *inputs):
        """Copy ``inputs`` into the graph's static inputs."""
        with device_guard(self.device):
            for dst, src in _pairs(self.inputs, tuple(inputs)):
                dst.copy_(src)

    def replay(self):
        """One replay of the loaded inputs; the static outputs
        (``outputs``) are overwritten."""
        with device_guard(self.device):
            self.graph.replay()
        profiling.count("graph.replays", self.what)

    def __call__(self, *inputs):
        self.load(*inputs)
        self.replay()
        with device_guard(self.device):
            return clone_tree(self.outputs)
