"""The program's own spans in a traced window, and the device's idle time
laid at their door.

cufhe_tpu_torch marks its layer boundaries with record_function ranges
named cufhe.<layer>.<what> (cufhe_tpu_torch/utils/spans.py). They reach
a Trace as host operations, on the device's clock. Each idle gap of the
device (as Trace.idle_gaps finds them) is assigned to the innermost
cufhe.* span open on the host when the gap opened: of the spans that
contain the gap's start, the one that started last. A gap that opens in a
parent's own time, after its child has closed, is the parent's; one that
opens outside every cufhe.* span is no layer's.

A window holding no cufhe.* span at all comes from a program that has
none: the readers return None there. A window holding some, but not the
ones a metric names, raises: a renamed span must never read as 0.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from .trace import Trace

#: the prefix of every span of the program
PREFIX = "cufhe."


class Spans:
    """The cufhe.* spans of a window, sorted by start (a parent before a
    child that starts with it), and the window's idle gaps."""

    def __init__(self, trace: Trace):
        idx = [i for i, n in enumerate(trace.host_names)
               if n.startswith(PREFIX)]
        order = sorted(idx, key=lambda i: (trace.host_start[i],
                                           -trace.host_end[i]))
        self.names = [trace.host_names[i] for i in order]
        self.start = trace.host_start[order] if order else np.array([])
        self.end = trace.host_end[order] if order else np.array([])
        self.window_s = trace.window_s
        # the gaps as Trace.idle_gaps finds them: from the latest end of
        # the operations so far to the next start
        ends = np.maximum.accumulate(trace.dev_end) if len(trace.dev_end) \
            else np.array([])
        g0 = np.concatenate([[trace.t0], ends])
        g1 = np.concatenate([trace.dev_start, [trace.t1]])
        keep = g1 > g0
        self.gap_start, self.gap_s = g0[keep], (g1 - g0)[keep]

    def __bool__(self) -> bool:
        return bool(self.names)

    def require(self, names: Sequence[str]) -> None:
        missing = sorted(set(names) - set(self.names))
        if missing:
            raise RuntimeError(f"no {missing} span in the traced window; "
                               f"the program's spans there are "
                               f"{sorted(set(self.names))}")

    def idle_s(self) -> Dict[str, float]:
        """Idle device seconds by the name of the span each gap opened
        in; gaps outside every span are left out."""
        # the gaps are in order of start, so those a span contains are one
        # run of them; a span that starts later overwrites its parent
        owner = np.full(len(self.gap_start), -1, dtype=np.int64)
        lo = np.searchsorted(self.gap_start, self.start, side="left")
        hi = np.searchsorted(self.gap_start, self.end, side="left")
        for i in range(len(self.names)):
            owner[lo[i]:hi[i]] = i
        inside = owner >= 0
        by_span = np.bincount(owner[inside], weights=self.gap_s[inside],
                              minlength=len(self.names))
        out: Dict[str, float] = {}
        for n, s in zip(self.names, by_span):
            out[n] = out.get(n, 0.0) + float(s)
        return out

    def total_s(self, name: str) -> tuple:
        """(host seconds of every `name` span together, their number)."""
        d = [e - s for n, s, e in zip(self.names, self.start, self.end)
             if n == name]
        return float(sum(d)), len(d)


def idle_pct(trace: Trace, names: Sequence[str]) -> Optional[float]:
    """The share of the window, in percent, that the device was idle in
    gaps that opened in the own time of a span named in `names`. None if
    the window holds no cufhe.* span; raises if it lacks one of `names`."""
    sp = Spans(trace)
    if not sp:
        return None
    sp.require(names)
    idle = sp.idle_s()
    return 100.0 * sum(idle.get(n, 0.0) for n in names) / sp.window_s


def span_s(trace: Trace, name: str) -> Optional[tuple]:
    """(host seconds of every `name` span in the window, their number).
    None if the window holds no cufhe.* span; raises if it lacks `name`."""
    sp = Spans(trace)
    if not sp:
        return None
    sp.require([name])
    return sp.total_s(name)
