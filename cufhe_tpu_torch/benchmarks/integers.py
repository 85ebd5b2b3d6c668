"""Encrypted-integer benchmark on the card: radix adds via multi-output
PBS, the counterpart of benchmarks/integers.py (same flags, same fields).

Measures, at a production parameter set:
  * ripple-add throughput (word adds/s and blind rotations/s: a full
    adder is one rotation per digit, so the rotation rate should track the
    gate rate),
  * the digit noise of the sums and the implied decision margin of the
    next add,
  * a chained-add error count (every word of the chained result checked
    against plain integers),
  * optionally the multiplier (--mul-bits) and restoring divmod
    (--div-bits), each checked word by word.

Each timed operation ends in torch.cuda.synchronize (host clock), and its
blind-rotation kernel launches are counted (ops.blind_rotate).

    python -m cufhe_tpu_torch.benchmarks.integers [--bits 32] [--batch 256]
        [--chain 4] [--params tfhepp_128bit] [--msg-bits 1] [--buf-bits B]
        [--backend auto] [--mul-bits 0] [--div-bits 0]

Prints one JSON line with the card's name and power limit; needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def timed(fn):
    """(result, seconds, kernel launches) of fn() between two
    synchronises."""
    from ..ops import blind_rotate as BR
    torch.cuda.synchronize()
    BR.blind_rotate_cuda.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, BR.blind_rotate_cuda.launches


def digit_noise(x, want, sk, codec):
    """(phase errors of every digit against its plaintext value, wrong
    digits) of an IntCtxt whose words should be `want`."""
    from ..models.integers import digit_phases
    ph = digit_phases(x, sk)
    m = codec.msg_bits
    errs, bad = [], 0
    for i, row in enumerate(ph):
        for dgt, p in enumerate(row):
            wv = (want[i] >> (m * dgt)) & (codec.base - 1)
            diff = (int(p) - wv * codec.delta) % (1 << 32)
            if diff >= 1 << 31:
                diff -= 1 << 32
            errs.append(diff)
            got_v = int(round(int(p) / codec.delta)) % (
                1 << (codec.buf_bits + 1))
            bad += int((got_v & (codec.base - 1)) != wv)
    return errs, bad


def next_add_margin(std: float, params, codec) -> float:
    """Decision margin, in sigmas, of an adder fed three digits of noise
    std `std` plus the theta=1 mod-switch rounding."""
    lp = params.lvl1
    ms_var = params.lvl0.dim / 2 * (1 << (32 - lp.nbit)) ** 2 / 12
    sigma_in = float(np.sqrt(3 * std ** 2 + ms_var))
    return (codec.delta / 2) / sigma_in if sigma_in else float("inf")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bits", type=int, default=32)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--chain", type=int, default=4)
    ap.add_argument("--params", default="tfhepp_128bit")
    ap.add_argument("--msg-bits", type=int, default=1)
    ap.add_argument("--buf-bits", type=int, default=None,
                    help="carry-buffer bits (default msg_bits+1; the "
                         "multiplier at msg_bits>=2 needs 2*msg_bits)")
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--mul-bits", type=int, default=0,
                    help="also bench the multiplier at this width "
                         "(0 = skip; products are verified)")
    ap.add_argument("--div-bits", type=int, default=0,
                    help="also bench restoring divmod at this width "
                         "(0 = skip; quotients/remainders are verified)")
    args = ap.parse_args()
    if (args.mul_bits and args.msg_bits >= 2
            and (args.buf_bits or args.msg_bits + 1) < 2 * args.msg_bits):
        ap.error(f"--mul-bits at --msg-bits {args.msg_bits} needs "
                 f"--buf-bits >= {2 * args.msg_bits} (bivariate "
                 "digit-product phase space)")

    from ._common import bench_keys, device_record, require_cuda
    from .. import Context
    from ..models.integers import (IntCodec, IntContext, decrypt_uint,
                                   encrypt_uint)
    require_cuda()

    params, sk, ek = bench_keys(args.params)
    codec = IntCodec(msg_bits=args.msg_bits, buf_bits=args.buf_bits)
    ictx = IntContext(Context(ek, backend=args.backend), codec)

    rng = np.random.default_rng(17)
    B, bits = args.batch, args.bits
    D = codec.digits_for(bits)
    mod = 1 << bits
    xs = [int(v) for v in rng.integers(0, mod, B, dtype=np.uint64)]
    ys = [int(v) for v in rng.integers(0, mod, B, dtype=np.uint64)]
    x = encrypt_uint(xs, bits, sk, codec, rng=rng)
    y = encrypt_uint(ys, bits, sk, codec, rng=rng)

    # -- throughput: ripple add -----------------------------------------
    ictx.add(x, y)                          # builds the kernel, warms up
    ts = []
    for _ in range(3):
        s, dt, add_launches = timed(lambda: ictx.add(x, y))
        ts.append(dt)
    dt = sorted(ts)[len(ts) // 2]

    # -- noise: output digit phase errors + implied next-add margin ------
    errs, bad = digit_noise(s, [(a + b) % mod for a, b in zip(xs, ys)], sk,
                            codec)
    std = float(np.std(errs))

    # -- chained adds: every word verified --------------------------------
    acc_plain, acc = list(xs), x
    for _ in range(args.chain):
        acc = ictx.add(acc, y)
        acc_plain = [(a + b) % mod for a, b in zip(acc_plain, ys)]
    chain_bad = sum(g != w for g, w in zip(decrypt_uint(acc, sk), acc_plain))

    mul_stats = {}
    if args.mul_bits:
        mb = args.mul_bits
        mxs = [int(v) for v in rng.integers(0, 1 << mb, B, dtype=np.uint64)]
        mys = [int(v) for v in rng.integers(0, 1 << mb, B, dtype=np.uint64)]
        mx = encrypt_uint(mxs, mb, sk, codec, rng=rng)
        my = encrypt_uint(mys, mb, sk, codec, rng=rng)
        prod, mdt, launches = timed(lambda: ictx.mul(mx, my))
        got = decrypt_uint(prod, sk)
        mul_stats = {
            "mul_bits": mb,
            "muls_per_sec": B / mdt,
            "ms_per_mul_batch": mdt * 1e3,
            "mul_rotations_per_sec":
                3 * (mb // codec.msg_bits) ** 2 * B / mdt,
            "mul_launches": launches,
            "mul_word_errors":
                sum(g != a * b for g, a, b in zip(got, mxs, mys)),
        }

    div_stats = {}
    if args.div_bits:
        db = args.div_bits
        Dd = db // codec.msg_bits
        dxs = [int(v) for v in rng.integers(0, 1 << db, B, dtype=np.uint64)]
        dys = [int(v) for v in rng.integers(1, 1 << db, B, dtype=np.uint64)]
        dx = encrypt_uint(dxs, db, sk, codec, rng=rng)
        dy = encrypt_uint(dys, db, sk, codec, rng=rng)
        (q, r), ddt, launches = timed(lambda: ictx.divmod_(dx, dy))
        gq, gr = decrypt_uint(q, sk), decrypt_uint(r, sk)
        # the OUTPUT digit noise of q and r, and the margin if one fed an
        # adder
        derrs = []
        for ic, want in ((q, [a // b for a, b in zip(dxs, dys)]),
                         (r, [a % b for a, b in zip(dxs, dys)])):
            derrs += digit_noise(ic, want, sk, codec)[0]
        dstd = float(np.std(derrs))
        # per quotient digit: (base-1) trial subs + base-way select over
        # W=(D+1) digits (m=1: 3*D*(D+1))
        div_rots = (2 * codec.base - 1) * Dd * (Dd + 1)
        div_stats = {
            "div_bits": db,
            "divs_per_sec": B / ddt,
            "ms_per_div_batch": ddt * 1e3,
            "div_rotations_per_sec": div_rots * B / ddt,
            "div_launches": launches,
            "div_digit_noise_std_log2":
                float(np.log2(dstd)) if dstd else None,
            "div_next_add_margin_sigmas":
                next_add_margin(dstd, params, codec) if dstd else None,
            "div_word_errors":
                sum(int(g != a // b) + int(h != a % b)
                    for g, h, a, b in zip(gq, gr, dxs, dys)),
        }

    rec = {
        "metric": "encrypted_uint_add",
        "params": params.name, "backend": args.backend,
        "msg_bits": codec.msg_bits, "bits": bits, "batch": B,
        "adds_per_sec": B / dt,
        "rotations_per_sec": B * D / dt,
        "ms_per_add_batch": dt * 1e3,
        "rep_ms_per_add_batch": [t * 1e3 for t in ts],
        "add_launches": add_launches,
        "digit_noise_std_log2": float(np.log2(std)) if std else None,
        "digit_errors": bad,
        "next_add_margin_sigmas": next_add_margin(std, params, codec),
        "chain_depth": args.chain,
        "chain_word_errors": chain_bad,
        **mul_stats,
        **div_stats,
        "device": device_record(),
    }
    print(json.dumps(rec))
    errors = (bad + chain_bad + mul_stats.get("mul_word_errors", 0)
              + div_stats.get("div_word_errors", 0))
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
