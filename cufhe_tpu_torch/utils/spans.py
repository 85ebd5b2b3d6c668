"""The program's spans and counters, at its layer boundaries.

span(name) marks a stretch of host code as a torch.profiler range, so it
lands in the same trace as the device's kernels, on their clock
(utils.timing.trace writes that trace as Chrome trace JSON). With no
profiler recording it returns one shared null context and builds nothing:
a flag read, about half a microsecond on the host, where a bare
record_function costs about 13. Spans are named cufhe.<layer>.<what>:

    cufhe.executor.run    run_schedule, each cycle of run_schedule_loop
    cufhe.executor.plan   the program's lookup, on every call; on its key's
                          first call also its build: slots, plan, index
                          uploads
    cufhe.executor.step   one step: gather, gate program, scatter
    cufhe.gate            gate_lvl0/1 (ops.bootstrap): the two-input gates
    cufhe.gate.mux        mux_lvl0/1 (ops.bootstrap): mux and nmux, two
                          rotations a row
    cufhe.key_switch      ops.keyswitch.key_switch
    cufhe.blind_rotate    ops.blind_rotate.blind_rotate (on CUDA the C
                          launch loop of cufhe_blind_rotate)

count(name, n) adds to one of the program's counters, which are always
on; counts() is a snapshot of them, zero for a name never counted:

    executor.plans        _Programs built (one a key: context, schedule,
                          batch, level, step chunk)
    executor.plan_hits    executor calls served by a _Program built before
    blind_rotate          rotations launched through the CUDA kernels
    blind_rotate.limbs4   of them with the exact four-limb key
    blind_rotate.limbs3   of them with the three-limb (pallas3) key
    blind_rotate.kar0/1/2 of them at each Karatsuba depth of the product
                          (2 at tfhepp_128bit, 1 at cggi19, 0 at concrete
                          and pallas3)
    rotdec                rotate-and-decompose kernel launches (n0 per
                          rotation, one per rotdec_cuda call)
    mux                   mux programs run (mux_lvl0/1: one a Context.mux
                          or nmux call, one a shard under a mesh)
    mux.rows              rows they muxed
    key_switch            key switch kernel launches (one a key switch on
                          CUDA: a lvl0 gate or mux 1, a lvl1 gate 1, a lvl1
                          mux 2; ops.keyswitch.key_switch_cuda)
"""
from __future__ import annotations

import collections
import contextlib

import torch
from torch.autograd import profiler as _profiler

_NULL = contextlib.nullcontext()
_COUNTS: collections.Counter = collections.Counter()


def span(name: str):
    """A context manager: torch.profiler.record_function(name) while a
    profiler records, else the shared null context."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NULL


def count(name: str, n: int = 1) -> None:
    _COUNTS[name] += n


def counts() -> collections.Counter:
    """A copy of every counter (a Counter: a name never counted reads 0,
    and `after - before` gives the counts in between)."""
    return collections.Counter(_COUNTS)
