"""Timing of a back-projection call (the tuner's measurement).

The counterpart of ``repro.tune.timing``: a median over an adaptive
number of calls.  A call on the card is timed with CUDA events around it
(the device's own clock, which sees the kernels and not the enqueue); a
call on the CPU with the host clock.  Which clock is chosen by where the
call's tensor arguments lie.
"""

from __future__ import annotations

import statistics
import time

import torch

__all__ = ["time_fn"]


def _on_cuda(args, kw) -> bool:
    return any(torch.is_tensor(a) and a.is_cuda
               for a in (*args, *kw.values()))


def time_fn(fn, *args, warmup: int = 2, iters: int = 5,
            min_total_s: float = 0.05, max_iters: int = 1000, **kw):
    """Median time (seconds) of ``fn(*args, **kw)``.

    Runs ``warmup`` untimed calls, then at least ``iters`` timed calls,
    and keeps sampling until the measured time reaches ``min_total_s``
    (or ``max_iters`` calls), so fast calls get a stable median and slow
    calls pay no extra iterations; ``min_total_s=0`` pins the count to
    ``iters``.
    """
    cuda = _on_cuda(args, kw)
    for _ in range(warmup):
        fn(*args, **kw)
    if cuda:
        torch.cuda.synchronize()
    times, total = [], 0.0
    while len(times) < iters or (total < min_total_s
                                 and len(times) < max_iters):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args, **kw)
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            fn(*args, **kw)
            dt = time.perf_counter() - t0
        times.append(dt)
        total += dt
    return float(statistics.median(times))
