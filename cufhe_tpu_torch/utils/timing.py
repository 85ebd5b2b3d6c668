"""Benchmark and profiling helpers: the cudaEvent timing harness of the
reference (test/test_util.h:30-72), on torch.cuda events, and a
torch.profiler trace. The counterpart of cufhe_tpu/utils/timing.py."""
from __future__ import annotations

import time
from contextlib import contextmanager

import torch


def time_fn(fn, *args, iters: int = 5, warmup: int = 1,
            device="cuda") -> float:
    """Median seconds per call of fn(*args). On a CUDA device each call is
    timed between two events on the current stream; device="cpu" times
    on the host clock."""
    for _ in range(warmup):
        fn(*args)
    times = []
    if torch.device(device).type == "cuda":
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


@contextmanager
def trace(path: str, cuda: bool = True):
    """torch.profiler over the body (CPU, and CUDA unless cuda=False); the
    trace is written to `path` as Chrome trace JSON."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(path)
