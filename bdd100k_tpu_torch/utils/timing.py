"""Device time of a call on the card, with the host's launch overhead left
out: the calls are captured in a CUDA graph and the graph is replayed
between CUDA events."""

from __future__ import annotations

import statistics

import torch


def graph_time_ms(fn, reps: int = 30, inner: int = 10) -> float:
    """Device ms of one call of fn: `inner` calls captured in one CUDA
    graph, the median over `reps` replays divided by `inner`."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as graphs need
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(statistics.median(times))
