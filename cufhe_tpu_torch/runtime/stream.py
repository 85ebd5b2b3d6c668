"""Streams: the reference's asynchronous model on CUDA streams and events.

The reference exposes Stream (one CUDA stream pinned to a GPU,
cufhe_gpu.cuh:152-189), StreamQuery (non-blocking completion poll,
cufhe_gates_gpu.cu:55-65) and Synchronize (device sweep, cufhe_gpu.cuh:68-74).
Here a Stream owns one torch.cuda.Stream; a Context method given stream=
enqueues its work there (models/api.py), and the ciphertext it returns
carries an event that every consumer waits for, so code written against
the reference's completion-polling pattern (test_intensive.cc:21-54) ports
directly. The counterpart of cufhe_tpu/runtime/stream.py.
"""
from __future__ import annotations

import itertools
import weakref
from typing import List, Optional

import torch

#: Live streams, for the global synchronize() sweep
_live: "weakref.WeakSet[Stream]" = weakref.WeakSet()
_round_robin = itertools.count()


class Stream:
    """An ordered lane of asynchronous gate work on one device.

    Stream() takes the CUDA devices round robin, as the reference assigns
    streamCount % _gpuNum (cufhe_gpu.cuh:154-158), and raises without
    CUDA. Stream(device="cpu") is an explicit synchronous lane: its work
    runs on the CPU when it is enqueued, so it is always complete."""

    def __init__(self, device: Optional[object] = None):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("Stream() needs a CUDA device; "
                                   "Stream(device='cpu') is the synchronous "
                                   "CPU lane")
            device = torch.device("cuda", next(_round_robin)
                                  % torch.cuda.device_count())
        device = torch.device(device)
        if device.type == "cuda":
            if device.index is None:        # F6: tensors report cuda:<i>
                device = torch.device("cuda", torch.cuda.current_device())
            self.cuda_stream: Optional[torch.cuda.Stream] = \
                torch.cuda.Stream(device=device)
        elif device.type == "cpu":
            self.cuda_stream = None
        else:
            raise ValueError(f"no streams on {device}")
        self.device = device
        self._pending: List[torch.cuda.Event] = []
        _live.add(self)

    def record(self, *cts) -> None:
        """Track ciphertexts (Ctxt) as this stream's work: their ready
        events, or for a ciphertext without one, an event recorded on this
        stream now. Context methods given stream= record their outputs."""
        if self.cuda_stream is None:
            return
        for ct in cts:
            ev = getattr(ct, "ready", None)
            if ev is None:
                ev = torch.cuda.Event()
                ev.record(self.cuda_stream)
            self._pending.append(ev)

    def query(self) -> bool:
        """StreamQuery analogue: True iff everything recorded and enqueued
        on this stream has completed (non-blocking; Event.query)."""
        if self.cuda_stream is None:
            return True
        if not all(ev.query() for ev in self._pending):
            return False
        self._pending.clear()
        return self.cuda_stream.query()

    def synchronize(self) -> None:
        """Block until everything recorded and enqueued on this stream has
        completed."""
        if self.cuda_stream is None:
            return
        for ev in self._pending:
            ev.synchronize()
        self._pending.clear()
        self.cuda_stream.synchronize()


def stream_query(stream: Stream) -> bool:
    """Free-function form of the reference's StreamQuery."""
    return stream.query()


def synchronize(*streams: Stream) -> None:
    """Synchronize() analogue: with no arguments, every live stream and
    then every CUDA device (the reference sweeps all devices); with
    streams, those lanes."""
    for st in streams if streams else list(_live):
        st.synchronize()
    if not streams and torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
