"""``jointpose_torch.graphs`` on the CPU, with stand-ins for the card's
graph, capture and streams: a capture puts the kernels' launch counters
back as it found them, raise or not, and each replay adds the launches
the capture recorded.  The graphs themselves are held on the card
(``test_torch_kernels_cuda.py``, ``chip_smoke.py``'s kstep phase)."""

import contextlib

import pytest
import torch

from jointpose_torch import graphs, ops
from jointpose_torch.ops import mrf_epilogue, warp


class StubGraph:
    """Stands for ``torch.cuda.CUDAGraph``: records what is asked of it."""

    def __init__(self):
        self.generators, self.replays = [], 0

    def register_generator_state(self, generator):
        self.generators.append(generator)

    def replay(self):
        self.replays += 1


class StubStream:
    def __init__(self, name, log):
        self.name, self.log = name, log

    def wait_stream(self, other):
        self.log.append((self.name, "waits for", other.name))


def test_counters_are_put_back_after_a_capture_and_replays_add_its_launches(monkeypatch):
    log, modes = [], []

    @contextlib.contextmanager
    def stub_capture(graph, pool=None, stream=None, capture_error_mode="global"):
        modes.append((capture_error_mode, pool, stream.name))
        yield

    capture_stream, current = StubStream("capture", log), StubStream("current", log)
    for attr, value in (("CUDAGraph", StubGraph), ("graph", stub_capture),
                        ("Stream", lambda: capture_stream), ("graph_pool_handle", lambda: "pool"),
                        ("current_stream", lambda: current),
                        ("stream", lambda s: contextlib.nullcontext())):
        monkeypatch.setattr(torch.cuda, attr, value)
    for holder, name in ops.launch_counters():  # put back after the test by monkeypatch
        monkeypatch.setattr(holder, name, 3)

    def call():
        warp.shear_warp.launches += 2
        mrf_epilogue.mrf_epilogue.launches += 1
        return "out"

    pool = graphs.GraphPool()
    assert pool.warm(call) == "out"
    assert log == [("capture", "waits for", "current"), ("current", "waits for", "capture")]
    assert (warp.shear_warp.launches, mrf_epilogue.mrf_epilogue.launches) == (5, 4)

    generator = torch.Generator()
    graph = graphs.Graph(pool, call, generator)
    assert graph.out == "out" and graph.graph.generators == [generator]
    assert modes == [("thread_local", "pool", "capture")]
    # The capture ran the call, and counted nothing that reached the card.
    assert (warp.shear_warp.launches, mrf_epilogue.mrf_epilogue.launches) == (5, 4)
    assert all(getattr(holder, name) == 3 for holder, name in ops.launch_counters()
               if (holder, name) not in ((warp.shear_warp, "launches"),
                                         (mrf_epilogue.mrf_epilogue, "launches")))
    graph.replay()
    graph.replay()
    assert graph.graph.replays == 2
    assert (warp.shear_warp.launches, mrf_epilogue.mrf_epilogue.launches) == (9, 6)

    def fails():
        warp.shear_warp.launches += 7
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        graphs.Graph(pool, fails)
    assert warp.shear_warp.launches == 9

    pool.release()
    assert (pool.stream, pool.pool) == (None, None)
    assert pool.handles() == (capture_stream, "pool")
