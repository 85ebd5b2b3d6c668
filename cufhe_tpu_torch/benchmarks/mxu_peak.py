"""Tensor-core peak probe: what int8 dot rate does this card reach through a
library product and through hand-written kernels of its two tensor-core
instructions, wgmma and mma.sync?

The counterpart of benchmarks/mxu_peak.py. The blind rotation is an int8
product (one step at tfhepp_128bit, batch 4096, is 4096 x 6144 x 8192), so
the rate its kernel could reach is judged against a ceiling measured here,
not against the datasheet.

    python -m cufhe_tpu_torch.benchmarks.mxu_peak

Prints one JSON line per case, with TMAC/s and the card's name and power
limit:

  * torch-int8         torch._int_mm, int8 x int8 -> int32, 8192^3
  * torch-int8-bf16acc int8 cast to bf16 inside the timed call, bf16 matmul
                       (float32 accumulation, bf16 result)
  * torch-bf16         bf16 x bf16 matmul (float32 accumulation)
  * torch-int8-kshape  S = 18 torch._int_mm products of the probe's shape
  * pallas-{pure,place,write,bf16}-w512, pallas-pure-w1024 (S = 9): the
    JAX probe's kernel cases, through the wgmma kernel
    (csrc/mxu_peak_wgmma.cu), each beside its plain PyTorch version
  * pallas-pure-k1step: the same case at the port's blind-rotation step
    shape, M = 4096, K = I*N = 6144, W = (k+1)*4*N = 8192, S = 1
  * mma_sync-pure-w512, mma_sync-pure-k1step: the same two shapes through
    the mma.sync kernel (csrc/mxu_peak.cu), the instruction the blind
    rotation's product uses, so one run reads both side by side

The library rows and the plain versions are references; the kernel rows
are the probe. Needs a CUDA device; there is no CPU mode of the probe. The
plain version mxu_peak_ref runs anywhere and is what the tests check
against the JAX probe's pallas_case.
"""
from __future__ import annotations

import json
import statistics
import sys

import numpy as np
import torch

from .._build import H100_SMS, call, check_cuda
from ..torus import int_mm

VARIANTS = ("pure", "place", "write", "bf16")
#: the two kernels, by the tensor-core instruction they issue
INSTRUCTIONS = ("wgmma", "mma_sync")
#: the JAX probe's operand ring (NBUF = min(3, S))
NBUF = 3
#: each kernel's tile multiples (M, W, K bytes: 128 int8 or 64 bf16 values)
TILE = {"wgmma": (128, 128, 128), "mma_sync": (128, 64, 128)}

#: (M, K, W, S, steps) of the JAX probe's full and small (MXU_PEAK_SMALL)
#: kernel cases
FULL = (2048, 1536, 512, 18, 32)
SMALL = (256, 256, 128, 2, 2)
#: the port's blind-rotation step at tfhepp_128bit, batch 4096
K1_STEP = (4096, 6144, 8192, 1, 4)


def make_operands(rng: np.random.Generator, variant: str, M: int, K: int,
                  W: int, S: int, device="cuda"):
    """The JAX probe's operands from the same generator: A [S, M, K] in
    [-100, 100), X [S, K, W] in [-32, 32), int8 (bf16 for 'bf16'), on
    `device`, by default the card."""
    A = rng.integers(-100, 100, (S, M, K), dtype=np.int64).astype(np.int8)
    X = rng.integers(-32, 32, (S, K, W), dtype=np.int64).astype(np.int8)
    dt = torch.bfloat16 if variant == "bf16" else torch.int8
    return (torch.from_numpy(A).to(device=device, dtype=dt),
            torch.from_numpy(X).to(device=device, dtype=dt))


def mxu_peak_ref(A: torch.Tensor, X: torch.Tensor, variant: str,
                 steps: int) -> torch.Tensor:
    """Plain PyTorch version of pallas_case's kernel: A [S, M, K], X
    [S, K, W] -> [M, W] int32, computed `steps` times as the kernel does.

    pure/write: sum_s A_s X_s as exact int32 products (torus.int_mm);
    write keeps the JAX kernel's ring of NBUF operand buffers, refilled
    from a staging copy (A itself, as the JAX probe passes it) after every
    product. place: a uint32 buffer,
    starting at 0, gains (sum_{s<S-1} P_s) << 8 + P_{S-1} every step
    (int32 arithmetic wraps like uint32). bf16: the products in float32 on
    bf16 values upcast, which is exact here (integer partial sums below
    2^24); TF32 must be off (PyTorch's default for matmul), or this raises.
    """
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: choose from {VARIANTS}")
    S = A.shape[0]
    if variant == "bf16":
        if A.is_cuda and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("the plain bf16 probe needs float32 matmul "
                               "without TF32")
        out = None
        for _ in range(steps):
            acc = torch.zeros((A.shape[1], X.shape[2]), dtype=torch.float32,
                              device=A.device)
            for s in range(S):
                acc += torch.matmul(A[s].float(), X[s].float())
            out = acc.to(torch.int32)
        return out
    if variant == "place":
        upd = torch.zeros((A.shape[1], X.shape[2]), dtype=torch.int32,
                          device=A.device)
        for _ in range(steps):
            for s in range(S):
                p = int_mm(A[s], X[s])
                upd += p if s == S - 1 else p << 8
        return upd
    nbuf = min(NBUF, S)
    ring = A[:nbuf].clone()
    out = None
    for _ in range(steps):
        acc = None
        for s in range(S):
            a = ring[s % nbuf] if variant == "write" else A[s]
            p = int_mm(a, X[s])
            acc = p if acc is None else acc + p
            if variant == "write":
                ring[(s + 1) % nbuf] = A[(s + 1) % S]
        out = acc
    return out


def prepare_x(X: torch.Tensor) -> torch.Tensor:
    """X [S, K, W] -> Xt [S, W, K] contiguous: the kernels' B operand,
    laid out once, before timing (both instructions want the contraction
    contiguous for 8-bit B: wgmma takes K-major int8 only, and ldmatrix.trans
    does not transpose 8-bit elements)."""
    return X.transpose(1, 2).contiguous()


def wgmma_plan(variant: str, M: int, K: int, W: int, S: int) -> dict:
    """The wgmma kernel's launch plan: block tile bm x bn (bn = 256 where W
    allows, 128 otherwise and for place, whose second accumulator needs the
    registers), and `split`, the number of blocks that share one output
    tile, each summing one range of a step's `slices` (s, k-slice) pairs
    (split_ranges) and adding its partial to the output. The split fills
    the card: tiles * split <= H100_SMS where the tiles allow."""
    kb = K * (2 if variant == "bf16" else 1)
    bm = TILE["wgmma"][0]
    bn = 256 if W % 256 == 0 and variant != "place" else 128
    tiles = (M // bm) * (W // bn)
    slices = S * (kb // TILE["wgmma"][2])
    split = max(1, min(slices, H100_SMS // tiles))
    return {"bm": bm, "bn": bn, "split": split, "slices": slices,
            "grid": (M // bm, W // bn, split)}


def split_ranges(slices: int, split: int) -> list:
    """[lo, hi) of the flattened pairs j = s * KT + kt that each block z of
    a split sums every step, as the kernel computes them."""
    return [(z * slices // split, (z + 1) * slices // split)
            for z in range(split)]


def smem_bytes(instruction: str, variant: str, M: int, K: int, W: int,
               S: int, steps: int) -> int:
    """Bytes one launch copies into shared memory: every block reads an A
    and a B tile, 128 bytes deep, per (s, k-slice) pair of its range, every
    step."""
    kb = K * (2 if variant == "bf16" else 1)
    bm, bn, bk = TILE[instruction]
    if instruction == "wgmma":
        bn = wgmma_plan(variant, M, K, W, S)["bn"]
    tiles = (M // bm) * (W // bn)
    return tiles * steps * S * (kb // bk) * (bm + bn) * bk


def mxu_peak_cuda(A: torch.Tensor, Xt: torch.Tensor, variant: str,
                  steps: int, instruction: str = "wgmma") -> torch.Tensor:
    """One launch of the probe kernel of `instruction`: the wgmma kernel
    (csrc/mxu_peak_wgmma.cu) or the mma.sync one (csrc/mxu_peak.cu). The
    same result as mxu_peak_ref(A, X, variant, steps) with
    Xt = prepare_x(X). A [S, M, K] (also the staging copy that 'write'
    reads), Xt [S, W, K], int8 (bf16 for 'bf16'), contiguous, on one CUDA
    device. Enqueued on the current stream; raises if the kernel cannot be
    built or launched, and never runs the other instruction instead."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: choose from {VARIANTS}")
    if instruction not in INSTRUCTIONS:
        raise ValueError(f"instruction {instruction!r}: choose from "
                         f"{INSTRUCTIONS}")
    dtype = torch.bfloat16 if variant == "bf16" else torch.int8
    S, M, K = A.shape
    W = Xt.shape[1]
    check_cuda({"A": (A, dtype, (S, M, K)), "Xt": (Xt, dtype, (S, W, K))})
    for name, t in (("A", A), ("Xt", Xt)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    kb = K * A.element_size()
    tm, tw, tk = TILE[instruction]
    if M % tm or W % tw or kb % tk:
        raise ValueError(f"{instruction}: M, W, K bytes must be multiples "
                         f"of {tm}, {tw}, {tk}: got {M}, {W}, {kb}")
    if variant == "write" and S % min(NBUF, S):
        raise ValueError(f"write needs S a multiple of {min(NBUF, S)}, "
                         f"so that every step reads A_s in order")
    if instruction == "wgmma":
        plan = wgmma_plan(variant, M, K, W, S)
        # blocks of a split add their partials into a zeroed output
        out = (torch.zeros if plan["split"] > 1 else torch.empty)(
            (M, W), dtype=torch.int32, device=A.device)
        call("cufhe_mxu_peak_wgmma", A.device, VARIANTS.index(variant),
             plan["bn"], A.data_ptr(), Xt.data_ptr(), A.data_ptr(),
             out.data_ptr(), M, K, W, S, steps, plan["split"])
    else:
        out = torch.empty((M, W), dtype=torch.int32, device=A.device)
        call("cufhe_mxu_peak", A.device, VARIANTS.index(variant),
             A.data_ptr(), Xt.data_ptr(), A.data_ptr(), out.data_ptr(), M, K,
             W, S, steps)
    mxu_peak_cuda.launches += 1
    mxu_peak_cuda.by_instruction[instruction] += 1
    return out


#: probe kernels launched (one per successful call), in all and per
#: instruction
mxu_peak_cuda.launches = 0
mxu_peak_cuda.by_instruction = dict.fromkeys(INSTRUCTIONS, 0)


def timed(fn, *args, reps: int = 5, inner: int = 4):
    """(seconds per call, last result): one warm-up, then the median over
    `reps` runs of `inner` calls between two CUDA events (the JAX probe's
    timed())."""
    fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    ts = []
    for _ in range(reps):
        start.record()
        for _ in range(inner):
            out = fn(*args)
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end) / 1e3 / inner)
    return statistics.median(ts), out


def library_cases(rng: np.random.Generator, device):
    """(name, fn, args, MACs) of the library rows (the JAX probe's
    xla_cases), on `device`."""
    n = 8192
    a8 = torch.from_numpy(rng.integers(-100, 100, (n, n), dtype=np.int64)
                          .astype(np.int8)).to(device)
    b8 = torch.from_numpy(rng.integers(-100, 100, (n, n), dtype=np.int64)
                          .astype(np.int8)).to(device)
    abf, bbf = a8.to(torch.bfloat16), b8.to(torch.bfloat16)
    macs = float(n) ** 3
    yield "torch-int8", torch._int_mm, (a8, b8), macs
    yield ("torch-int8-bf16acc",
           lambda a, b: torch.matmul(a.to(torch.bfloat16),
                                     b.to(torch.bfloat16)), (a8, b8), macs)
    yield "torch-bf16", torch.matmul, (abf, bbf), macs
    M, K, W, S, _ = FULL
    A, X = make_operands(rng, "pure", M, K, W, S, device)
    out = torch.empty((S, M, W), dtype=torch.int32, device=device)

    def kshape(a, x):
        for s in range(S):
            torch._int_mm(a[s], x[s], out=out[s])
        return out

    yield "torch-int8-kshape", kshape, (A, X), float(S) * M * K * W


INSTR_NAMES = {
    ("wgmma", False): "wgmma.m64n{bn}k32.s32.s8.s8",
    ("wgmma", True): "wgmma.m64n{bn}k16.f32.bf16.bf16",
    ("mma_sync", False): "mma.sync.m16n8k32.s32.s8",
    ("mma_sync", True): "mma.sync.m16n8k16.f32.bf16",
}


def kernel_cases(rng: np.random.Generator, device):
    """(name, instruction, variant, (M, K, W, S, steps), A, X) of the
    kernel rows."""
    M, K, W, S, steps = FULL
    for v in VARIANTS:
        yield (f"pallas-{v}-w{W}", "wgmma", v, FULL,
               *make_operands(rng, v, M, K, W, S, device))
    shape = (M, K, 1024, 9, steps)
    yield ("pallas-pure-w1024", "wgmma", "pure", shape,
           *make_operands(rng, "pure", M, K, 1024, 9, device))
    M1, K1, W1, S1, _ = K1_STEP
    yield ("pallas-pure-k1step", "wgmma", "pure", K1_STEP,
           *make_operands(rng, "pure", M1, K1, W1, S1, device))
    yield (f"mma_sync-pure-w{W}", "mma_sync", "pure", FULL,
           *make_operands(rng, "pure", M, K, W, S, device))
    yield ("mma_sync-pure-k1step", "mma_sync", "pure", K1_STEP,
           *make_operands(rng, "pure", M1, K1, W1, S1, device))


def run_probe(card: dict, emit=print) -> list:
    """Time every case on CUDA device 0; emit and return one record per
    case. Kernel rows also time the plain version and hold the kernel's
    last timed output equal to the plain one's (max_abs_err), so the
    comparison adds no launch."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    dev_info = {"name": torch.cuda.get_device_name(0),
                "power_limit": card["power_limit"]}
    rows = []
    for name, fn, args, macs in library_cases(rng, dev):
        t, _ = timed(fn, *args)
        rows.append({"case": name, "path": "library", "ms": t * 1e3,
                     "tmacs_per_sec": macs / t / 1e12, "device": dev_info})
        emit(json.dumps(rows[-1]))
    for name, instr, v, (M, K, W, S, steps), A, X in kernel_cases(rng, dev):
        macs = float(M) * K * W * S * steps
        t, got = timed(mxu_peak_cuda, A, prepare_x(X), v, steps, instr)
        t_plain, want = timed(mxu_peak_ref, A, X, v, steps, reps=3, inner=1)
        row = {"case": name, "path": "kernel", "instruction":
               INSTR_NAMES[instr, v == "bf16"], "shape": {
                   "M": M, "K": K, "W": W, "S": S, "steps": steps}}
        if instr == "wgmma":
            plan = wgmma_plan(v, M, K, W, S)
            row["instruction"] = row["instruction"].format(bn=plan["bn"])
            row["plan"] = {k: plan[k] for k in ("bm", "bn", "split")}
        row.update({
            "ms": t * 1e3, "tmacs_per_sec": macs / t / 1e12,
            "smem_gb": smem_bytes(instr, v, M, K, W, S, steps) / 1e9,
            "plain_ms": t_plain * 1e3,
            "plain_tmacs_per_sec": macs / t_plain / 1e12,
            "max_abs_err": int((got.long() - want.long()).abs().max()),
            "device": dev_info})
        rows.append(row)
        emit(json.dumps(row))
        del A, X, got, want
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: the probe measures the GPU only",
              file=sys.stderr)
        return 2
    from ..bench import card
    rows = run_probe(card())
    return 0 if all(r.get("max_abs_err", 0) == 0 for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
