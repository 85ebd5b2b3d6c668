"""What a traced run reads from torch.profiler: the device's operations in
the traced window, the host's operations beside them, and the sums the
per-layer metrics and the result's `breakdown` take from them.

`Trace.from_profiler` copies the profiler's events into plain arrays once;
everything else works on those, so the tests can build a Trace by hand.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
from typing import Dict, List, Sequence, Tuple

import numpy as np

#: the record_function name that marks the traced window; it opens after a
#: synchronise and closes after another
WINDOW = "fhebench.window"
#: the prefix of every span the benchmark records
SPAN_PREFIX = "fhebench."
LAYER_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "layers")


@dataclasses.dataclass
class Trace:
    """Device operations (kernels, copies, sets) and host operations, each
    as names and start/end times in seconds on one clock, clipped to the
    window [t0, t1]."""

    t0: float
    t1: float
    dev_names: List[str]
    dev_start: np.ndarray
    dev_end: np.ndarray
    host_names: List[str]
    host_start: np.ndarray
    host_end: np.ndarray

    @classmethod
    def from_events(cls, window: Tuple[float, float],
                    device: Sequence[Tuple[str, float, float]],
                    host: Sequence[Tuple[str, float, float]]) -> "Trace":
        t0, t1 = window

        def arrays(evs):
            evs = sorted(((n, max(s, t0), min(e, t1)) for n, s, e in evs
                          if e > t0 and s < t1), key=lambda x: x[1])
            return ([n for n, _, _ in evs],
                    np.array([s for _, s, _ in evs], dtype=np.float64),
                    np.array([e for _, _, e in evs], dtype=np.float64))
        return cls(t0, t1, *arrays(device), *arrays(host))

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        """The events of a finished torch.profiler.profile whose body ran
        one record_function(WINDOW)."""
        from torch.autograd import DeviceType
        device, host, window = [], [], None
        for ev in prof.profiler.kineto_results.events():
            name = ev.name()
            s, e = ev.start_ns() * 1e-9, ev.end_ns() * 1e-9
            if ev.device_type() == DeviceType.CUDA:
                # the device-side copy of a record_function span is no work
                if not (ev.is_user_annotation()
                        or name.startswith(SPAN_PREFIX)):
                    device.append((name, s, e))
            elif name == WINDOW:
                window = (s, e)
            else:
                host.append((name, s, e))
        if window is None:
            raise RuntimeError(f"the trace holds no {WINDOW} span")
        return cls.from_events(window, device, host)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_s(self) -> float:
        """Seconds in which at least one device operation ran: the length
        of the union of their intervals."""
        if not len(self.dev_start):
            return 0.0
        ends = np.maximum.accumulate(self.dev_end)
        # an interval opens a new run where it starts after every earlier end
        new = np.empty(len(ends), dtype=bool)
        new[0] = True
        new[1:] = self.dev_start[1:] > ends[:-1]
        idx = np.flatnonzero(new)
        run_end = np.append(ends[idx[1:] - 1], ends[-1])
        return float(np.sum(run_end - self.dev_start[idx]))

    def by_name(self) -> Dict[str, float]:
        """Device seconds by operation name."""
        out: Dict[str, float] = {}
        for n, d in zip(self.dev_names, self.dev_end - self.dev_start):
            out[n] = out.get(n, 0.0) + float(d)
        return out

    def matching_s(self, patterns: Sequence[str]) -> Tuple[float, float]:
        """(device seconds of the operations whose name a pattern finds,
        those of all others)."""
        rx = [re.compile(p) for p in patterns]
        inside = outside = 0.0
        for n, s in self.by_name().items():
            if any(r.search(n) for r in rx):
                inside += s
            else:
                outside += s
        return inside, outside

    def idle_gaps(self) -> Dict[str, float]:
        """Idle device seconds by what the host was doing when each gap
        opened: the innermost host operation running then, or "host
        between operations" where none was."""
        ends = np.maximum.accumulate(self.dev_end) if len(self.dev_end) \
            else np.array([])
        g0 = np.concatenate([[self.t0], ends])
        g1 = np.concatenate([self.dev_start, [self.t1]])
        keep = g1 > g0
        g0, g1 = g0[keep], g1[keep]
        out: Dict[str, float] = {}
        if not len(g0):
            return out
        # the host operation that began last before the gap: innermost
        # where it is still running
        i = np.searchsorted(self.host_start, g0, side="right") - 1
        ok = (i >= 0) & (self.host_end[np.maximum(i, 0)] > g0) if len(
            self.host_start) else np.zeros(len(g0), dtype=bool)
        for j, gap in enumerate(g1 - g0):
            name = self.host_names[i[j]] if ok[j] else \
                "host between operations"
            out[name] = out.get(name, 0.0) + float(gap)
        return out


def layers() -> Dict[str, List[str]]:
    """Every layer that layers/*.json names, with the kernel-name patterns
    of all its files (a later file adds patterns to a layer by giving the
    same "layer")."""
    out: Dict[str, List[str]] = {}
    for path in sorted(glob.glob(os.path.join(LAYER_DIR, "*.json"))):
        with open(path) as f:
            spec = json.load(f)
        out.setdefault(spec["layer"], []).extend(spec["patterns"])
    return out


def top(d: Dict[str, float], n: int = 10) -> List[list]:
    """The n largest entries, names cut to 160 characters (a templated
    kernel's name runs to a thousand)."""
    return [[k[:160], v]
            for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def layer_s(trace: Trace, layer: str) -> Tuple[float, float]:
    """(device seconds of a layer's kernels, of all others) in the window.
    Raises where the layer's patterns find no operation: a renamed kernel
    must not read as a layer that costs nothing."""
    patterns = layers()[layer]
    inside, outside = trace.matching_s(patterns)
    if inside <= 0.0:
        raise RuntimeError(f"layer {layer!r}: no device operation matches "
                           f"{patterns} in the traced window")
    return inside, outside


def check_layers(trace: Trace) -> None:
    """Raise if a layer's patterns match nothing in the window."""
    for layer in layers():
        layer_s(trace, layer)
