"""Capturing one step into a CUDA graph, as every graph of the port is
captured (the env and wrapper step, the train step, the planner's IK).

``capture(body, warm, device, what)`` runs ``warm()`` and then captures
``body()``, both with ``device`` current and on a named side stream: the
default capture stream belongs to the device current at the first
capture of the process, so a second card's graph needs its own.  The
warm-up runs the same work outside the capture (building the kernels and
filling every lazy cache) on the caller's clones.  A capture that fails
raises: no caller falls back to eager work on the card.
"""

from __future__ import annotations

import torch


def capture(body, warm, device, what: str):
    """-> (the ``torch.cuda.CUDAGraph`` of ``body()``, what ``body()``
    returned at capture: the graph's static outputs)."""
    with torch.cuda.device(device):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            warm()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, stream=side):
                out = body()
        except RuntimeError as e:
            raise RuntimeError(
                f"{what} did not capture into a CUDA graph: an operation in "
                f"it synchronizes with the host (the traceback above names "
                f"it)") from e
    return graph, out
