"""Benchmark and profiling helpers: the cudaEvent timing harness of the
reference (test/test_util.h:30-72), on torch.cuda events, and a
torch.profiler trace. The counterpart of cufhe_tpu/utils/timing.py."""
from __future__ import annotations

import time
from contextlib import contextmanager

import torch


def block(x):
    """Wait for the device work that produces x, a tensor or a nest of
    them (lists, tuples, dict values, objects with a tensor `.data`):
    synchronise every CUDA device they lie on. Returns x. The counterpart
    of cufhe_tpu.utils.timing.block (jax.block_until_ready)."""
    devices = set()

    def visit(v):
        if isinstance(v, torch.Tensor):
            if v.device.type == "cuda":
                devices.add(v.device)
        elif isinstance(v, dict):
            for item in v.values():
                visit(item)
        elif isinstance(v, (list, tuple)):
            for item in v:
                visit(item)
        elif isinstance(getattr(v, "data", None), torch.Tensor):
            visit(v.data)

    visit(x)
    for device in devices:
        torch.cuda.synchronize(device)
    return x


def time_fn(fn, *args, iters: int = 5, warmup: int = 1, device="cuda",
            between=None, sleep_cycles: int = 0) -> float:
    """Median seconds per call of fn(*args). On a CUDA device each call is
    timed between two events on the current stream; device="cpu" times
    on the host clock. between(), if given, runs before each call, the
    warm-up's too, outside the timed span (to evict the L2, say).
    sleep_cycles > 0 enqueues a sleep kernel of that many cycles ahead of
    the timed calls and waits only after the last, so the queue stays
    full and no host time falls inside a pair of events; the warm-up has
    by then loaded every kernel the calls launch, whose first launch can
    take the host longer than the sleep."""
    for _ in range(warmup):
        if between is not None:
            between()
        fn(*args)
    times = []
    if torch.device(device).type == "cuda":
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        if sleep_cycles:
            torch.cuda.synchronize()
            torch.cuda._sleep(sleep_cycles)
        for start, end in pairs:
            if between is not None:
                between()
            start.record()
            fn(*args)
            end.record()
            if not sleep_cycles:
                end.synchronize()
        torch.cuda.synchronize()
        times = [start.elapsed_time(end) / 1e3 for start, end in pairs]
    else:
        for _ in range(iters):
            if between is not None:
                between()
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


@contextmanager
def trace(path: str, cuda: bool = True):
    """torch.profiler over the body (CPU, and CUDA unless cuda=False); the
    trace is written to `path` as Chrome trace JSON, the program's
    cufhe.* spans (utils.spans) among the kernels."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(path)
