"""Capture and replay of CUDA graphs: what the predictor's graphs
(``predict.PredictorGraphs``) and the K-step dispatch's
(``train.DispatchGraphs``) share.  Each of them keeps its own policy of
when to warm, capture, replay and drop; this module holds how.

- ``GraphPool``: one capture stream and one memory pool, made on first
  use, shared by a family of graphs.  ``warm(fn)`` runs ``fn`` eagerly on
  that stream, so that what a capture cannot do (build kernels, create
  the stream's cuDNN and cuBLAS handles and workspaces, the optimizer's
  state, NCCL's communicators) is done before it.
- ``Graph``: one captured call.  The capture records the call's launches
  on the card and keeps its return value, whose tensors each replay
  writes again.  The kernels' launch counters (``ops.launch_counters``)
  are put back as the capture found them, raise or not, and each replay
  adds the launches the capture recorded, so that a counter keeps meaning
  launches that reached the card.
"""

from __future__ import annotations

import torch

from jointpose_torch import ops


class GraphPool:
    """A capture stream and a memory pool, made on first use on the current
    device, that a family of graphs shares."""

    def __init__(self):
        self.stream = None
        self.pool = None

    def handles(self):
        """(stream, pool), made now where there are none."""
        if self.stream is None:
            self.stream, self.pool = torch.cuda.Stream(), torch.cuda.graph_pool_handle()
        return self.stream, self.pool

    def warm(self, fn):
        """``fn()`` run eagerly on the capture stream, after the current
        stream's work and before the current stream's next."""
        stream = self.handles()[0]
        current = torch.cuda.current_stream()
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            out = fn()
        current.wait_stream(stream)
        return out

    def release(self) -> None:
        """Drop the stream and the pool: the next use makes new ones."""
        self.stream = None
        self.pool = None


class Graph:
    """``fn()`` captured into ``pool``, with ``generator`` (where given)
    registered, so that each replay advances it as an eager call would.
    ``out`` is ``fn``'s return value from the capture."""

    def __init__(self, pool: GraphPool, fn, generator: torch.Generator | None = None):
        stream, handle = pool.handles()
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self.graph.register_generator_state(generator)
        self.counters = ops.launch_counters()
        before = [getattr(holder, name) for holder, name in self.counters]
        try:
            # 'thread_local': other threads use the card while a capture runs
            # (an nccl mesh's watchdog queries the events of finished
            # collectives; a service's threads wait on its events), and the
            # default 'global' mode refuses their calls and invalidates the
            # capture.
            with torch.cuda.graph(self.graph, pool=handle, stream=stream,
                                  capture_error_mode="thread_local"):
                self.out = fn()
            self.launches = [getattr(holder, name) - n
                             for (holder, name), n in zip(self.counters, before)]
        finally:
            for (holder, name), n in zip(self.counters, before):
                setattr(holder, name, n)

    def replay(self) -> None:
        """Launch the graph and count the launches it holds."""
        self.graph.replay()
        for (holder, name), n in zip(self.counters, self.launches):
            setattr(holder, name, getattr(holder, name) + n)
