"""Full benchmark suite on the card: the counterpart of benchmarks/suite.py,
with its flags, sections and record keys.

  golden   device gates and mux against the golden model, uint32 for
           uint32 (golden_check.golden_diff)
  gates    all 10 two-input bootstrapped gates at both ciphertext levels
  chain    16-deep dependent NAND chain (Context.gate_chain), per gate
  latency  one NAND at batch 1, 64 and 256: one call to a synchronise, and
           per gate of a 20-deep dependent chain
  mux      mux and nmux at both levels
  linear   not (no bootstrap)
  refresh  TRLWE -> TRLWE noise refresh
  cmux     TRGSW-select on TRLWE pairs
  kernels  the blind rotation alone (ops.bootstrap.bootstrap_tlwe2trlwe,
           the CUDA kernel) and the key switch alone (ops.keyswitch.
           key_switch), each timed with CUDA events (utils.timing.time_fn)
  noise    the worst-gate and the integer adder's margins, failing red
           below MARGIN_FLOORS / INT_MARGIN_FLOORS (benchmarks.noise)

Each section decrypts what it times against the plaintext answer before it
reports. A section times its calls between two synchronises on the host
clock, as the JAX suite does, except `kernels`.

    python -m cufhe_tpu_torch.benchmarks.suite [--batch 1024] [--iters 2]
        [--backend auto] [--params tfhepp_128bit]
        [--sections golden,gates,chain,latency,mux,linear,refresh,cmux,
                    kernels,noise]

Prints a line per record and appends each record to the results file
(every record carries the card's name and power limit under "device").
Exits 1 on any decrypt error, golden mismatch or margin below its floor,
2 without a CUDA device. The section functions take a Run, whose context
may live on the CPU: the tests run them there at the tiny presets.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from .. import golden as G
from ..models.api import Context, TrlweCtxt, decrypt_bits, encrypt_bits
from ..torus import from_u32, to_u32

SECTIONS = ("golden", "gates", "chain", "latency", "mux", "linear",
            "refresh", "cmux", "kernels", "noise")
CHAIN_DEPTH = 16
LATENCY_DEPTH = 20
LATENCY_BATCHES = (1, 64, 256)


@dataclasses.dataclass
class Run:
    """One suite run: the context and keys it measures, its batch and
    iterations, and the records so far. `device` is what every record
    names: the card's record on CUDA, "cpu" on the CPU. `sink` receives
    each record as it is made; `pool` runs golden_diff's oracle."""
    ctx: Context
    sk: G.SecretKey
    ek: G.EvalKey
    batch: int
    iters: int
    device: object
    rng: np.random.Generator = dataclasses.field(
        default_factory=lambda: np.random.default_rng(7))
    sink: Optional[Callable[[dict], None]] = None
    pool: object = None
    results: list = dataclasses.field(default_factory=list)
    margin_fail: bool = False

    def __post_init__(self):
        B = self.batch
        self.bits0, self.bits1, self.bits2 = (self.rng.integers(0, 2, B)
                                              for _ in range(3))

    @property
    def params(self):
        return self.ctx.params

    def encrypt(self, bits, level: int = 0):
        return encrypt_bits(bits, self.sk, self.rng, level,
                            device=self.ctx.device)

    def sync(self) -> None:
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)

    def timed(self, fn, iters: int):
        """(seconds per call, last output) of `iters` calls of fn after a
        warm-up call, between two synchronises."""
        out = fn()
        self.sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        self.sync()
        return (time.perf_counter() - t0) / iters, out

    def add(self, rec: dict) -> dict:
        self.results.append(rec)
        if self.sink is not None:
            self.sink(rec)
        return rec

    def report(self, section, name, dt, ops, errors, level=None) -> dict:
        rec = {"section": section, "name": name,
               "ops_per_sec": round(ops / dt, 2),
               "ms_per_batch": round(dt * 1e3, 3), "batch": ops,
               "errors": int(errors), "backend": self.ctx.backend,
               "params": self.params.name, "device": self.device}
        if level is not None:
            rec["level"] = level
        print(f"{section:8s} {name:8s} lvl{level if level is not None else '-'}"
              f"  {rec['ops_per_sec']:>10.1f} ops/s   "
              f"{rec['ms_per_batch']:>9.2f} ms/batch   errors={errors}",
              flush=True)
        return self.add(rec)


def section_golden(run: Run) -> None:
    from .golden_check import golden_diff
    t0 = time.perf_counter()
    mism, total = golden_diff(run.ctx, run.sk, run.ek, run.rng,
                              pool=run.pool)
    run.report("golden", "u32_diff", time.perf_counter() - t0, total, mism)


def section_gates(run: Run) -> None:
    for level in (0, 1):
        a = run.encrypt(run.bits0, level)
        b = run.encrypt(run.bits1, level)
        for name in G.GATE_CONSTANTS:
            dt, out = run.timed(lambda: run.ctx.gate(name, a, b), run.iters)
            want = G.PLAIN_GATES[name](run.bits0, run.bits1)
            run.report("gates", name, dt, run.batch,
                       np.sum(decrypt_bits(out, run.sk) != want), level)


def section_chain(run: Run) -> None:
    for level in (0, 1):
        a = run.encrypt(run.bits0, level)
        b = run.encrypt(run.bits1, level)
        dt, out = run.timed(
            lambda: run.ctx.gate_chain("nand", a, b, CHAIN_DEPTH), run.iters)
        want = run.bits0.copy()
        for _ in range(CHAIN_DEPTH):
            want = 1 - (want & run.bits1)
        run.report("chain", f"nand_x{CHAIN_DEPTH}", dt / CHAIN_DEPTH,
                   run.batch, np.sum(decrypt_bits(out, run.sk) != want),
                   level)


def section_latency(run: Run) -> None:
    """b{B}: the median of single NAND calls, each to a synchronise;
    b{B}_chain: per gate of LATENCY_DEPTH dependent NANDs ended by one
    synchronise, the latency a sequential encrypted machine pays."""
    ctx = run.ctx
    for Bs in LATENCY_BATCHES:
        lb0, lb1 = run.rng.integers(0, 2, Bs), run.rng.integers(0, 2, Bs)
        a, b = run.encrypt(lb0), run.encrypt(lb1)
        out = ctx.nand(a, b)
        run.sync()
        ts = []
        for _ in range(max(run.iters, 5)):
            t0 = time.perf_counter()
            out = ctx.nand(a, b)
            run.sync()
            ts.append(time.perf_counter() - t0)
        want = 1 - (lb0 & lb1)
        run.report("latency", f"b{Bs}", sorted(ts)[len(ts) // 2], Bs,
                   np.sum(decrypt_bits(out, run.sk) != want))
        ts = []
        for _ in range(max(run.iters, 3)):
            out = ctx.nand(a, b)
            run.sync()
            t0 = time.perf_counter()
            for _ in range(LATENCY_DEPTH):
                out = ctx.nand(out, b)
            run.sync()
            ts.append((time.perf_counter() - t0) / LATENCY_DEPTH)
        for _ in range(LATENCY_DEPTH):
            want = 1 - (want & lb1)
        run.report("latency", f"b{Bs}_chain", sorted(ts)[len(ts) // 2], Bs,
                   np.sum(decrypt_bits(out, run.sk) != want))


def section_mux(run: Run) -> None:
    for level in (0, 1):
        c = run.encrypt(run.bits2, level)
        a = run.encrypt(run.bits0, level)
        b = run.encrypt(run.bits1, level)
        for name, neg in (("mux", False), ("nmux", True)):
            dt, out = run.timed(lambda: run.ctx.mux(c, a, b, negate=neg),
                                run.iters)
            want = np.where(run.bits2 == 1, run.bits0, run.bits1)
            if neg:
                want = 1 - want
            run.report("mux", name, dt, run.batch,
                       np.sum(decrypt_bits(out, run.sk) != want), level)


def section_linear(run: Run) -> None:
    a = run.encrypt(run.bits0)
    dt, out = run.timed(lambda: run.ctx.not_(a), max(run.iters, 10))
    run.report("linear", "not", dt, run.batch,
               np.sum(decrypt_bits(out, run.sk) != 1 - run.bits0), 0)


def section_refresh(run: Run) -> None:
    lp, key = run.params.lvl1, run.sk.lvl1
    tr = run.ctx.bootstrap_tlwe2trlwe(run.encrypt(run.bits0))
    dt, out = run.timed(lambda: run.ctx.refresh(tr), run.iters)
    got = np.array([G.trlwe_phase(t, lp, key)[0] for t in to_u32(out.data)])
    run.report("refresh", "refresh", dt, run.batch,
               np.sum((got.astype(np.int32) > 0) != run.bits0))


def section_cmux(run: Run) -> None:
    lp, key, rng = run.params.lvl1, run.sk.lvl1, run.rng
    plain1 = rng.integers(0, 2, lp.n)
    tg = run.ctx.prepare_trgsw(G.trgsw_encrypt(1, lp, key, rng))
    words = run.batch // 8
    c1 = np.stack([G.trlwe_encrypt_bits(plain1, lp, key, rng)
                   for _ in range(words)])
    c0 = np.stack([G.trlwe_encrypt_bits(1 - plain1, lp, key, rng)
                   for _ in range(words)])
    c1t, c0t = (TrlweCtxt(from_u32(c, run.ctx.device)) for c in (c1, c0))
    dt, out = run.timed(lambda: run.ctx.cmux(tg, c1t, c0t), run.iters)
    ph = G.trlwe_phase(to_u32(out.data[0]), lp, key)
    run.report("cmux", "cmux", dt, words,
               np.sum((ph.astype(np.int32) > 0) != plain1))


def section_kernels(run: Run) -> None:
    from ..ops.bootstrap import bootstrap_tlwe2trlwe
    from ..ops.keyswitch import key_switch
    from ..utils.timing import time_fn
    p, keys, dev = run.params, run.ctx.keys, run.ctx.device
    a = run.encrypt(run.bits0)
    dt = time_fn(bootstrap_tlwe2trlwe, a.data, p.lvl1.mu, keys, p,
                 run.ctx.backend, iters=run.iters, device=dev)
    run.report("kernels", "blindrot", dt, run.batch, 0)
    d1 = p.lvl1.k * p.lvl1.n
    tl = from_u32(run.rng.integers(0, 1 << 32, (run.batch, d1 + 1),
                                   dtype=np.uint64).astype(np.uint32), dev)
    dt = time_fn(key_switch, tl, keys.ksk_tiles, p, iters=run.iters,
                 device=dev)
    run.report("kernels", "keyswitch", dt, run.batch, 0)


def section_noise(run: Run) -> None:
    """Both margins against their floors; a miss sets run.margin_fail.
    digit_errors may reach 5: at the adder's ~4.8-sigma margin a single
    wrong digit in 256 x 32 rotations is expected now and then."""
    from .noise import (INT_MARGIN_FLOORS, MARGIN_FLOORS, margin_ok,
                        measure_int_adder_noise, measure_noise)
    p, dev = run.params, run.ctx.device
    rec = measure_noise(p, run.ctx.backend, batch=max(run.batch, 2048),
                        ek=run.ek, sk=run.sk, device=dev)
    floor = MARGIN_FLOORS.get(p.name)
    run.add({**rec, "section": "noise", "margin_floor_sigmas": floor,
             "device": run.device})
    sig, xerr = rec["worst_gate_margin_sigmas"], \
        rec["xor_of_bootstrapped_errors"]
    print(f"noise    margin   {sig} sigma (floor {floor}), xor errors {xerr}",
          flush=True)
    if xerr or not margin_ok(sig, floor):
        run.margin_fail = True
        print("NOISE MARGIN REGRESSION: failing red", flush=True)
    irec = measure_int_adder_noise(p, run.ctx.backend, ek=run.ek, sk=run.sk,
                                   device=dev)
    ifloor = INT_MARGIN_FLOORS.get(p.name)
    run.add({**irec, "section": "noise", "margin_floor_sigmas": ifloor,
             "device": run.device})
    isig = irec["next_add_margin_sigmas"]
    print(f"noise    int-add  {isig} sigma (floor {ifloor}), digit errors "
          f"{irec['digit_errors']}", flush=True)
    if irec["digit_errors"] > 5 or not margin_ok(isig, ifloor):
        run.margin_fail = True
        print("INTEGER NOISE MARGIN REGRESSION: failing red", flush=True)


SECTION_FNS = {"golden": section_golden, "gates": section_gates,
               "chain": section_chain, "latency": section_latency,
               "mux": section_mux, "linear": section_linear,
               "refresh": section_refresh, "cmux": section_cmux,
               "kernels": section_kernels, "noise": section_noise}


def run_sections(run: Run, sections) -> int:
    """Run the named sections in the suite's order; 1 if any record has an
    error or a margin is below its floor, else 0."""
    unknown = set(sections) - set(SECTIONS)
    if unknown:
        raise ValueError(f"unknown sections {sorted(unknown)}; the suite's "
                         f"are {SECTIONS}")
    for name in SECTIONS:
        if name in sections:
            SECTION_FNS[name](run)
    errors = sum(r.get("errors", 0) for r in run.results)
    return 1 if (errors or run.margin_fail) else 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--params", default="tfhepp_128bit")
    ap.add_argument("--sections", default=",".join(SECTIONS))
    args = ap.parse_args()
    sections = args.sections.split(",")

    from ._common import (RESULTS, append_result, device_record,
                          load_or_make_bench_keys, require_cuda)
    from .golden_check import golden_pool
    require_cuda()
    sk, ek = load_or_make_bench_keys(args.params)
    run = Run(Context(ek, backend=args.backend), sk, ek, args.batch,
              args.iters, device_record(), sink=append_result)
    print(f"suite: {args.params}, backend {args.backend}, batch "
          f"{args.batch}, iters {args.iters} on {run.device}", flush=True)
    pool = (golden_pool(ek, os.cpu_count() or 1) if "golden" in sections
            else contextlib.nullcontext())
    with pool as run.pool:
        rc = run_sections(run, sections)
    errors = sum(r.get("errors", 0) for r in run.results)
    print(f"\n{len(run.results)} measurements -> {RESULTS}; total errors: "
          f"{errors}", flush=True)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
