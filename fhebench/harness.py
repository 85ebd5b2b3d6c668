"""One run of one cell: load its files by name, set up, warm up, measure,
check, and assemble the result line.

Everything that belongs to one configuration, traffic mix, per-layer
metric or layer sits in its own file, found by the name BENCHMARK.json
gives it:

    configs/<config>.json       the parameter set, as published
    traffic/<traffic>.json      the mix: {"kind": ..., its parameters}
    traffic/<kind>.py           the driver of that kind of traffic
    metrics/<metric>.py         read(reading) -> number or None
    layers/*.json               {"layer": ..., "patterns": [...]}
    limits/<workload>.json      {number compared: its limit}
    reference/                  the plain reference that decides `correct`

The program under test, cufhe_tpu_torch, is imported only here and in the
traffic drivers, through its public entries.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Dict

import torch

from . import trace as T
from .reference import tfhe as R

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: top-level module names a run may not have loaded when its window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "cufhe_tpu")


def load_module(path: str, name: str):
    """The module in the file at `path` (a metric's name has dots, so its
    file is loaded by path), registered under `name`."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _json(path: str):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """A workload of BENCHMARK.json with the files it names."""

    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: Dict[str, dict]      # name -> metric entry
    per_layer: Dict[str, dict]
    limits: Dict[str, float]         # number compared -> its limit

    @classmethod
    def load(cls, workload: str) -> "Cell":
        bench = _json(os.path.join(ROOT, "BENCHMARK.json"))
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r}; the cells are "
                           f"{sorted(cells)}")
        w = cells[workload]
        cfg = next(c for c in bench["configs"] if c["name"] == w["config"])

        def here(metric):
            return workload in metric.get("workloads", [workload])
        e2e = {m["name"]: m for m in bench["end_to_end"] if here(m)}
        layer = {m["name"]: m for m in bench["per_layer"]
                 if m["moves"] in e2e and here(m)}
        return cls(workload, w["chips"],
                   _json(os.path.join(ROOT, cfg["file"])),
                   _json(os.path.join(HERE, "traffic",
                                      w["traffic"] + ".json")),
                   e2e, layer,
                   _json(os.path.join(HERE, "limits", workload + ".json")))


def port_params(cfg: dict):
    """The program's GateParams built from a configuration's values."""
    from cufhe_tpu_torch.params import (GateParams, KeySwitchParams,
                                        LweParams, TrlweParams)
    p = R.Params.from_config(cfg)
    return GateParams(
        name=cfg["name"],
        lvl0=LweParams(n=p.n0, k=1, alpha=p.alpha0, mu=p.mu0),
        lvl1=TrlweParams(nbit=p.nbit, k=p.k, l=p.l, Bgbit=p.Bgbit,
                         alpha=p.alpha1, mu=p.mu1),
        ks=KeySwitchParams(t=p.t, basebit=p.basebit))


class Session:
    """What a traffic driver works with: the parameters, the keys the
    benchmark made from the seed, and the program's Context over them."""

    def __init__(self, cfg: dict, seed: int, device, backend: str = "auto"):
        from cufhe_tpu_torch import golden
        from cufhe_tpu_torch.models.api import Context
        t0 = time.perf_counter()
        self.p = R.Params.from_config(cfg)
        self.seed = seed
        self.device = torch.device(device)
        self.sk = R.keygen(self.p, seed, self.device)
        ek = R.make_eval_key(self.p, self.sk, seed)
        # the reference's copy waits on the host until the window has closed
        self.ek = R.EvalKey(ek.bk.cpu(), ek.ksk.cpu())
        host = golden.EvalKey(port_params(cfg),
                              ek.bk.cpu().numpy().astype("uint32"),
                              ek.ksk.cpu().numpy().astype("uint32"))
        del ek
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)
        t1 = time.perf_counter()
        self.ctx = Context(host, backend=backend, device=self.device)
        #: seconds of set-up: the benchmark's keygen, the program's keys
        self.setup = {"keygen": t1 - t0,
                      "program keys": time.perf_counter() - t1}

    def generator(self, stream: int) -> torch.Generator:
        return R.generator(self.seed, stream, self.device)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @staticmethod
    def to_port(ct: torch.Tensor) -> torch.Tensor:
        """Reference words [.., d] in [0, 2^32) -> the program's int32."""
        return R._signed(ct).to(torch.int32).contiguous()

    @staticmethod
    def from_port(ct: torch.Tensor) -> torch.Tensor:
        return ct.to(torch.int64) & R.MASK

    def release(self) -> R.EvalKey:
        """Free the program's state; the reference's keys on the device."""
        self.ctx = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return R.EvalKey(self.ek.bk.to(self.device),
                         self.ek.ksk.to(self.device))


def driver(cell: Cell, session: Session):
    kind = cell.mix["kind"]
    mod = load_module(os.path.join(HERE, "traffic", kind + ".py"),
                      f"fhebench.traffic.{kind}")
    return mod.Driver(session, cell.mix)


@dataclasses.dataclass
class Reading:
    """What a per-layer metric reads: the traced window, the parameters
    and the driver's counts of the traced steps."""

    trace: T.Trace
    params: R.Params
    counts: dict


def read_per_layer(cell: Cell, reading: Reading) -> Dict[str, dict]:
    out = {}
    for name, m in cell.per_layer.items():
        mod = load_module(os.path.join(HERE, "metrics", name + ".py"),
                          "fhebench.metrics." + name.replace(".", "_"))
        value = mod.read(reading)
        if value is not None:
            out[name] = {"value": value, "unit": m["unit"]}
    return out


def card_query():
    """Start nvidia-smi on the run's card (name, power limit); its answer
    is read by card_line once the run has its result."""
    try:
        return subprocess.Popen(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "--id=0"], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        return f"nvidia-smi unavailable ({e})"


def card_line(query) -> str:
    if isinstance(query, str):
        return query
    try:
        return query.communicate(timeout=30)[0].strip()
    except subprocess.TimeoutExpired:
        query.kill()
        query.communicate()
        return "nvidia-smi gave no answer in 30 s"


def measure(drv, seconds: float, trace_steps: int):
    """The window: one step, then steps while fewer than `seconds` have
    passed, ended by a synchronise (the last step runs to its end and
    counts). With
    trace_steps > 0 the first that many steps run under torch.profiler
    inside a WINDOW span. Returns (steps, seconds, profile or None)."""
    prof = span = None
    if trace_steps:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if drv.session.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        drv.session.sync()
        prof = profile(activities=acts)
        prof.__enter__()
        span = record_function(T.WINDOW)
        span.__enter__()
    steps = 0
    t0 = time.perf_counter()
    while (not steps or time.perf_counter() - t0 < seconds
           or (span and steps < trace_steps)):
        with torch.profiler.record_function("fhebench.step"):
            drv.step()
        steps += 1
        if span is not None and steps == trace_steps:
            drv.session.sync()
            span.__exit__(None, None, None)
            prof.__exit__(None, None, None)
            span = None
    drv.session.sync()
    return steps, time.perf_counter() - t0, prof


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, backend: str = "auto") -> dict:
    """Set up, warm up, measure, check. Returns the result line's object
    (the device record without the card's name and count, which main adds)."""
    t0 = time.perf_counter()
    session = Session(cell.config, seed, device, backend)
    t1 = time.perf_counter()
    drv = driver(cell, session)
    t2 = time.perf_counter()
    per_step = drv.warm_up()
    setup_s = time.perf_counter() - t_start
    parts = {"start and imports": t0 - t_start, **session.setup,
             "traffic": t2 - t1, "warm-up": t_start + setup_s - t2}
    drv.plan(seconds, per_step)
    trace_steps = cell.mix["trace_steps"] if trace else 0
    steps, elapsed, prof = measure(drv, seconds, trace_steps)
    peak = (torch.cuda.max_memory_allocated(session.device)
            if session.device.type == "cuda" else 0)

    if trace:
        tr = T.Trace.from_profiler(prof)
        T.check_layers(tr)
        metrics = read_per_layer(cell, Reading(tr, session.p,
                                               drv.counts(trace_steps)))
        busy = tr.busy_s()
        dev = {"busy_s": busy, "window_s": tr.window_s}
        breakdown = {"device_ops": T.top(tr.by_name()),
                     "idle_gaps": T.top(tr.idle_gaps())}
    else:
        metrics = {n: {"value": v, "unit": cell.end_to_end[n]["unit"]}
                   for n, v in drv.end_to_end(steps, elapsed).items()}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        dev, breakdown = {}, None
    want = set(cell.per_layer if trace else cell.end_to_end)
    if not set(metrics) <= want:
        raise RuntimeError(f"metrics {sorted(set(metrics) - want)} are not "
                           f"the cell's")

    t_check = time.perf_counter()
    ek = session.release()
    values, attempted, failed = drv.check(ek)
    check_s = time.perf_counter() - t_check
    if set(values) != set(cell.limits):
        raise RuntimeError(f"checks {sorted(values)} against limits "
                           f"{sorted(cell.limits)}")
    checks = {n: {"value": v, "limit": cell.limits[n]}
              for n, v in values.items()}
    res = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
           "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": {"memory_peak_bytes": peak, **dev},
           "steps": steps, "window_s": elapsed, "check_s": check_s,
           "setup_parts": parts}
    if breakdown is not None:
        res["breakdown"] = breakdown
    res["checks"] = checks
    return res


def main(argv, t_start: float) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json "
                                 "once and print its result as JSON.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = Cell.load(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {cell.chips} CUDA device(s), found {n}: the benchmark "
              f"measures the card only", file=sys.stderr)
        return 2
    query = card_query()
    try:
        res = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       "cuda", t_start)
    finally:
        print(f"card: {card_line(query)}", file=sys.stderr)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"modules of JAX or of the JAX package were loaded: {loaded}",
              file=sys.stderr)
        return 3
    res["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                     "count": cell.chips, **res["device"]}
    print("set-up: " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                 res.pop("setup_parts").items()),
          file=sys.stderr)
    print(f"{cell.name} seed {args.seed}: {res.pop('steps')} steps in "
          f"{res.pop('window_s'):.3f} s, checked in "
          f"{res.pop('check_s'):.3f} s", file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res))
    return 0
