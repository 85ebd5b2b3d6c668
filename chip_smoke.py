#!/usr/bin/env python3
"""Smoke test of the PyTorch port (cufhe_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure:
  1. the card's name and power limit (nvidia-smi);
  2. build of the CUDA kernels from csrc/ (nvcc, sm_90a), timed;
  3. the blind-rotation kernel against its plain PyTorch version, bit for
     bit, on random accumulators (8 rows) at five parameter sets;
  4. Context(ek, "cuda").nand on the four input pairs at tfhepp_128bit
     against the port's NumPy gate oracle golden.gate_lvl0, as uint32;
  5. the main path: encrypt -> a chain of lvl0 NANDs on device-resident
     outputs at batch 4096, tfhepp_128bit -> decrypt, with 0 decrypt
     errors and one kernel launch per gate; gates/s;
  6. one blind rotation at the main path's shape through the kernel and
     through the plain version: equal, and both timed with CUDA events.

Prints the card line, a {"kernels": [...]} line, and as the last line
{"ok": true, "device": {...}}. Exits non-zero without a CUDA device.
The client side (keygen, encrypt, decrypt) and the gate oracle are the
port's NumPy module cufhe_tpu_torch.golden; neither JAX nor the JAX package
is imported.
"""
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
BATCH = 4096
ITERS = 4
REPS = 2
SOURCE = "cufhe_tpu_torch/csrc/blind_rotate.cu"
REPLACES = "cufhe_tpu/ops/pallas_br.py:762"


def log(msg: str) -> None:
    print(msg, flush=True)


def u32_max_abs_err(x, y) -> int:
    import numpy as np
    from cufhe_tpu_torch.torus import to_u32
    d = to_u32(x).astype(np.int64) - to_u32(y).astype(np.int64)
    return int(np.abs(d).max()) if d.size else 0


def cuda_ms(fn, n: int = 1):
    """Run fn n times between two CUDA events; (last result, ms per run)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / n


def random_rotation_inputs(params, rows: int, seed: int, device):
    """Random accumulators [rows, k+1, N] and rotations abar [n0, rows]."""
    import numpy as np
    from cufhe_tpu_torch.torus import from_u32
    rng = np.random.default_rng(seed)
    lp = params.lvl1
    acc = rng.integers(0, 1 << 32, (rows, lp.k + 1, lp.n), dtype=np.uint64)
    abar = rng.integers(0, 2 * lp.n, (params.lvl0.dim, rows))
    return (from_u32(acc.astype(np.uint32), device),
            from_u32(abar.astype(np.uint32), device))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import numpy as np

    import cufhe_tpu_torch as T
    from cufhe_tpu_torch import _build
    from cufhe_tpu_torch import golden as G
    from cufhe_tpu_torch.bench import (card, expected_nand_chain,
                                       time_nand_chain)
    from cufhe_tpu_torch.ops import blind_rotate as BR
    from cufhe_tpu_torch.ops.keys import prepare_keys
    from cufhe_tpu_torch.torus import to_u32

    dev = torch.device("cuda")
    info = card()
    tag = f"[{info['name']}, power limit {info['power_limit']}]"
    log(info["nvidia_smi"])

    # 2. build
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.3f} s {tag} ({_build.build_dir()})")
    ptxas = (_build.build_dir() / "build.log").read_text().splitlines()
    for line in ptxas:
        if "registers" in line or "spill" in line:
            log("  " + line.strip())

    # 3. kernel vs plain version at five parameter sets, 8 rows
    max_err = 0
    presets = (T.PALLAS_TINY, T.PALLAS_TINY_K2, T.PALLAS_BG10, T.TINY,
               T.TFHEPP_128)
    eks = {}
    for i, params in enumerate(presets):
        sk = G.keygen(params, seed=100 + i)
        ek = G.make_eval_key(sk, seed=200 + i)
        eks[params.name] = (sk, ek)
        keys = prepare_keys(ek, dev)
        acc, abar = random_rotation_inputs(params, 8, 300 + i, dev)
        before = BR.blind_rotate_cuda.launches
        got = BR.blind_rotate_cuda(acc, abar, keys.bk_ext, params)
        want = BR.blind_rotate_ref(acc, abar, keys.bk_ext, params)
        torch.cuda.synchronize()
        err = u32_max_abs_err(got, want)
        launched = BR.blind_rotate_cuda.launches - before
        log(f"kernel vs plain {params.name}: max_abs_err {err} "
            f"(launches {launched})")
        if err != 0 or launched != 1:
            raise AssertionError(f"kernel disagrees at {params.name}")
        max_err = max(max_err, err)
        del keys

    # 4. the gate vs the golden model at tfhepp_128bit
    sk, ek = eks[T.TFHEPP_128.name]
    t0 = time.perf_counter()
    ctx = T.Context(ek, device="cuda")
    torch.cuda.synchronize()
    log(f"key preparation and upload at {T.TFHEPP_128.name}: "
        f"{time.perf_counter() - t0:.3f} s (host clock)")
    rng = np.random.default_rng(7)
    bits0, bits1 = [0, 1, 0, 1], [0, 0, 1, 1]
    a = T.encrypt_bits(bits0, sk, rng, device="cuda")
    b = T.encrypt_bits(bits1, sk, rng, device="cuda")
    got = to_u32(ctx.nand(a, b).data)
    want = np.stack([G.gate_lvl0("nand", x, y, ek)
                     for x, y in zip(to_u32(a.data), to_u32(b.data))])
    if not np.array_equal(got, want):
        raise AssertionError("nand disagrees with golden.gate_lvl0")
    log(f"nand vs golden.gate_lvl0 at {T.TFHEPP_128.name}: equal as uint32 "
        f"on {len(bits0)} input pairs, decrypts {G.decrypt_bit_batch(got, sk)}")

    # 5. the main path, counted
    rng = np.random.default_rng(8)
    bits0 = rng.integers(0, 2, BATCH)
    bits1 = rng.integers(0, 2, BATCH)
    BR.blind_rotate_cuda.launches = 0
    a = T.encrypt_bits(bits0, sk, rng, device="cuda")
    b = T.encrypt_bits(bits1, sk, rng, device="cuda")
    out = ctx.nand(a, b)
    out, times = time_nand_chain(ctx, out, b, ITERS, REPS)
    bits = T.decrypt_bits(out, sk)
    launches = BR.blind_rotate_cuda.launches
    gates = 1 + ITERS * REPS
    errors = int(np.sum(bits != expected_nand_chain(bits0, bits1, gates)))
    dt = statistics.median(times)
    log(f"main path: {gates} chained NANDs at batch {BATCH}, "
        f"{T.TFHEPP_128.name}: decrypt errors {errors}, kernel launches "
        f"{launches}; {BATCH / dt:.2f} gates/s ({dt * 1e3:.1f} ms per "
        f"batch, reps {[round(t * 1e3, 1) for t in times]} ms) {tag}")
    if errors or launches != gates:
        raise AssertionError("main path failed its checks")

    # 6. one blind rotation at the main path's shape: kernel vs plain
    acc, abar = random_rotation_inputs(T.TFHEPP_128, BATCH, 400, dev)
    got, ms = cuda_ms(lambda: BR.blind_rotate_cuda(acc, abar, ctx.keys.bk_ext,
                                                   T.TFHEPP_128))
    want, plain_ms = cuda_ms(lambda: BR.blind_rotate_ref(
        acc, abar, ctx.keys.bk_ext, T.TFHEPP_128))
    err = u32_max_abs_err(got, want)
    log(f"blind rotation at B={BATCH}, {T.TFHEPP_128.name}: kernel "
        f"{ms:.1f} ms, plain PyTorch {plain_ms:.1f} ms, max_abs_err {err} "
        f"{tag}")
    if err != 0:
        raise AssertionError("kernel disagrees at the main path's shape")
    max_err = max(max_err, err)

    for mod in ("jax", "cufhe_tpu"):
        if mod in sys.modules:
            raise AssertionError(f"{mod} was imported")
    log(json.dumps({"kernels": [{
        "name": "blind_rotate", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
