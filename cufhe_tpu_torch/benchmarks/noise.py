"""Gate-output phase noise on the card: the counterpart of
benchmarks/noise.py (same records, same floors).

Decrypts gate outputs to their raw torus phase and reports the noise
around +-mu and the failure margin in sigmas it implies, for any backend:
the `ntt` backend's only difference from the exact path is its noise, so
this is the check that it keeps the parameters' margin (MARGIN_FLOORS).

    python -m cufhe_tpu_torch.benchmarks.noise [--batch 2048]
        [--params tfhepp_128bit] [--backend auto] [--cmux-depth 0]
        [--int-bits 0]

Prints one JSON line per record, each with the card's name and power
limit; needs a CUDA device (the measure_* functions also take
device="cpu", which the tests use at the tiny presets). Exits 1 if a
margin is below its floor or a decryption is wrong.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional

import numpy as np

#: margin floors of each shipping configuration (sigmas of the worst-gate
#: decision margin), the JAX package's (benchmarks/noise.py:35-40)
MARGIN_FLOORS = {
    "tfhepp_128bit": 6.0,
    "tfhepp_128bit_bg8": 5.0,
    "tfhepp_80bit": 12.0,
    "cggi19": 10.0,
}

#: integer-layer floors: sigmas of the next add's LUT decision margin
#: (benchmarks/noise.py:47-50)
INT_MARGIN_FLOORS = {
    "tfhepp_128bit": 4.5,
    "radix4_2048": 8.0,
}


def margin_ok(sigmas, floor) -> bool:
    """The red-gate predicate: no floor, or no margin measured, passes."""
    return floor is None or sigmas is None or sigmas >= floor


def centered_phases(ct, sk) -> np.ndarray:
    """Centered int64 torus phases b - <a, s> of a lvl0 Ctxt batch."""
    from ..torus import to_u32
    data = to_u32(ct.data).astype(np.int64)
    key = sk.lvl0.astype(np.int64)
    n0 = key.shape[0]
    ph = (data[:, n0] - data[:, :n0] @ key) % (1 << 32)
    ph[ph >= 1 << 31] -= 1 << 32
    return ph


def _log2(x: float) -> Optional[float]:
    return round(float(np.log2(x)), 2) if x else None


def measure_noise(params, backend: str = "auto", batch: int = 2048,
                  ek=None, sk=None, device="cuda") -> dict:
    """Phase noise of NAND outputs and the worst-gate margin: an XOR of two
    bootstrapped outputs doubles their noise, so |2 n0 + 2 n1| must stay
    under mu (margin mu / (2 sqrt 2 std))."""
    from .. import Context, decrypt_bits, encrypt_bits
    if ek is None or sk is None:
        from ._common import load_or_make_bench_keys
        sk, ek = load_or_make_bench_keys(params.name)
    ctx = Context(ek, backend=backend, device=device)
    rng = np.random.default_rng(11)
    bits0, bits1 = rng.integers(0, 2, batch), rng.integers(0, 2, batch)
    a = encrypt_bits(bits0, sk, rng, device=device)
    b = encrypt_bits(bits1, sk, rng, device=device)
    mu = params.lvl0.mu
    want = 1 - (bits0 & bits1)
    out = ctx.nand(a, b)
    noise = centered_phases(out, sk) - np.where(want == 1, mu, -mu)
    std = float(noise.std())
    x = ctx.xor(out, ctx.nand(b, a))            # want ^ want = 0
    xn = centered_phases(x, sk) + mu
    return {
        "metric": "gate_output_phase_noise",
        "params": params.name, "backend": backend, "batch": batch,
        "noise_std_log2": _log2(std),
        "max_abs_noise_log2": _log2(float(np.abs(noise).max())),
        "decrypt_margin_sigmas": round(mu / std, 2) if std else None,
        "worst_gate_margin_sigmas":
            round(mu / (2 * np.sqrt(2) * std), 2) if std else None,
        "decrypt_errors": int(np.sum(decrypt_bits(out, sk) != want)),
        "xor_of_bootstrapped_errors": int(np.sum(np.abs(xn) >= mu)),
        "xor_noise_std_log2": _log2(float(xn.std())),
    }


def measure_int_adder_noise(params, backend: str = "auto", batch: int = 256,
                            bits: int = 32, msg_bits: int = 1, ek=None,
                            sk=None, device="cuda") -> dict:
    """Digit noise of one ripple add and the decision margin of the next
    add fed three such digits (benchmarks/noise.py:125-176)."""
    from .. import Context
    from ..models.integers import IntCodec, IntContext, encrypt_uint
    from .integers import digit_noise, next_add_margin
    if ek is None or sk is None:
        from ._common import load_or_make_bench_keys
        sk, ek = load_or_make_bench_keys(params.name)
    codec = IntCodec(msg_bits=msg_bits)
    ictx = IntContext(Context(ek, backend=backend, device=device), codec)
    rng = np.random.default_rng(19)
    mod = 1 << bits
    xs = [int(v) for v in rng.integers(0, mod, batch, dtype=np.uint64)]
    ys = [int(v) for v in rng.integers(0, mod, batch, dtype=np.uint64)]
    s = ictx.add(encrypt_uint(xs, bits, sk, codec, rng=rng, device=device),
                 encrypt_uint(ys, bits, sk, codec, rng=rng, device=device))
    errs, bad = digit_noise(s, [(a + b) % mod for a, b in zip(xs, ys)], sk,
                            codec)
    std = float(np.std(errs))
    return {
        "metric": "int_adder_digit_noise",
        "params": params.name, "backend": backend, "batch": batch,
        "bits": bits, "msg_bits": codec.msg_bits,
        "digit_noise_std_log2": _log2(std),
        "digit_errors": bad,
        "next_add_margin_sigmas": round(next_add_margin(std, params, codec),
                                        2),
    }


def measure_cmux_tree_noise(params, backend: str = "auto", depth: int = 8,
                            batch: int = 64, ek=None, sk=None,
                            device="cuda") -> list:
    """Noise growth down a CMUX chain (a vertical-packing tree): each level
    adds one external product to the selected word, with no bootstrap.
    One record per depth: slot-phase noise, margin and slot errors."""
    from .. import Context, TrlweCtxt
    from .. import golden as G
    from ..torus import from_u32, to_u32
    if ek is None or sk is None:
        from ._common import load_or_make_bench_keys
        sk, ek = load_or_make_bench_keys(params.name)
    ctx = Context(ek, backend=backend, device=device)
    lp = params.lvl1
    mu = lp.mu
    rng = np.random.default_rng(13)

    def enc_words(bits):
        return TrlweCtxt(from_u32(np.stack([
            G.trlwe_encrypt_bits(w, lp, sk.lvl1, rng) for w in bits]),
            ctx.device))

    plain = rng.integers(0, 2, (batch, lp.n))
    cur = enc_words(plain)
    rows = []
    for d in range(1, depth + 1):
        alt = enc_words(rng.integers(0, 2, (batch, lp.n)))
        sel = int(rng.integers(2))
        tg = ctx.prepare_trgsw(G.trgsw_encrypt(sel, lp, sk.lvl1, rng))
        # the selected branch carries the chain; the other is fresh
        cur = ctx.cmux(tg, cur, alt) if sel == 1 else ctx.cmux(tg, alt, cur)
        ph = np.stack([G.trlwe_phase(w, lp, sk.lvl1)
                       for w in to_u32(cur.data)]).astype(np.int64)
        ph[ph >= 1 << 31] -= 1 << 32
        noise = ph - np.where(plain == 1, mu, -mu)
        std = float(noise.std())
        rows.append({
            "metric": "cmux_tree_noise",
            "params": params.name, "backend": backend,
            "depth": d, "words": batch,
            "noise_std_log2": _log2(std),
            "max_abs_noise_log2":
                _log2(float(max(np.abs(noise).max(), 1))),
            "margin_sigmas": round(mu / std, 2) if std else None,
            "slot_errors": int(np.sum(np.abs(noise) >= mu)),
        })
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--params", default="tfhepp_128bit")
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--cmux-depth", type=int, default=0,
                    help="also measure CMUX-tree noise to this depth")
    ap.add_argument("--int-bits", type=int, default=0,
                    help="also measure the integer adder's digit noise at "
                         "this word size (batch 256)")
    args = ap.parse_args()
    from ..params import PRESETS
    from ._common import (device_record, load_or_make_bench_keys,
                          require_cuda)
    require_cuda()
    sk, ek = load_or_make_bench_keys(args.params)
    params = ek.params
    card = device_record()
    rec = measure_noise(params, args.backend, args.batch, ek, sk)
    ok = (margin_ok(rec["worst_gate_margin_sigmas"],
                    MARGIN_FLOORS.get(params.name))
          and not rec["decrypt_errors"]
          and not rec["xor_of_bootstrapped_errors"])
    print(json.dumps({**rec, "margin_floor": MARGIN_FLOORS.get(params.name),
                      "device": card}), flush=True)
    if args.int_bits:
        rec = measure_int_adder_noise(PRESETS[args.params], args.backend,
                                      bits=args.int_bits, ek=ek, sk=sk)
        floor = INT_MARGIN_FLOORS.get(params.name)
        ok = ok and not rec["digit_errors"] and margin_ok(
            rec["next_add_margin_sigmas"], floor)
        print(json.dumps({**rec, "margin_floor": floor, "device": card}),
              flush=True)
    if args.cmux_depth:
        for row in measure_cmux_tree_noise(params, args.backend,
                                           args.cmux_depth, ek=ek, sk=sk):
            print(json.dumps({**row, "device": card}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
