"""Device timing on the card: the helper the tuner, the calibration and
``chip_smoke.py`` share.

A time is the mean of ``reps`` calls between two CUDA events.  With
``graph`` the calls are captured once in a CUDA graph and one replay is
timed, so the host's cost of a call (Python, argument checks) does not
leave the card idle between short kernels.  `rotation` sizes a set of
inputs that a call cycles through so that each call reads its operands
from HBM rather than from the 50 MB L2 the previous call left them in.
"""

from __future__ import annotations

import math
from typing import Callable

__all__ = ["L2_BYTES", "rotation", "time_ms"]

# an H100's L2 (data sheet: 50 MB)
L2_BYTES = 50 * 2**20


def rotation(set_bytes: float, *, l2_bytes: int = L2_BYTES, cap: int = 4096) -> int:
    """Input sets that a call of ``set_bytes`` of operands cycles through
    so that one pass over them moves twice the L2: a call's operands have
    been evicted by the time it comes round again (at most ``cap``)."""
    return max(1, min(cap, math.ceil(2 * l2_bytes / max(set_bytes, 1.0))))


def time_ms(fn: Callable[[int], object], reps: int, warmup: int = 2, graph: bool = False) -> float:
    """Mean device time of ``fn(i)`` over ``reps`` calls, i = 0 .. reps-1,
    by CUDA events.  With ``graph`` the calls are captured once in a CUDA
    graph and one replay is timed."""
    import torch

    # warm up on a side stream, as capturing autograd's backward requires
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(warmup):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for i in range(reps):
                fn(i)
        g.replay()  # first replay uploads the graph
        run = g.replay
    else:
        def run():
            for i in range(reps):
                fn(i)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
