"""Signed-limb codecs: uint32 torus values <-> small signed digits.

A copy of the NumPy helpers in cufhe_tpu/ops/limbs.py. That module is
reachable only through cufhe_tpu.ops, whose package __init__ imports JAX,
and the port never imports JAX.

A uint32 torus value x is represented as x = sum_l d_l * 2^(bits*l)
(mod 2^32) with balanced digits d_l in [-2^(bits-1), 2^(bits-1)), so both
operands of every int8 product are small signed integers and every partial
sum fits int32 exactly.
"""
from __future__ import annotations

import numpy as np

LIMB_BITS = 8
NLIMBS = 4  # 4 * 8 = 32 bits


def u32_to_signed_limbs(x: np.ndarray, nlimbs: int = NLIMBS,
                        bits: int = LIMB_BITS) -> np.ndarray:
    """[...]-shaped uint32 -> [..., nlimbs] int8 balanced digits.

    sum_l out[..., l] * 2**(bits*l) == x (mod 2**32) whenever
    nlimbs*bits >= 32 (the final carry is congruent to 0).
    """
    assert nlimbs * bits >= 32
    v = x.astype(np.int64)
    base = 1 << bits
    half = base >> 1
    out = np.empty(x.shape + (nlimbs,), dtype=np.int8)
    for l in range(nlimbs):
        d = ((v + half) % base) - half
        out[..., l] = d.astype(np.int8)
        v = (v - d) >> bits
    return out


def decomp_digit_limb_plan(Bgbit: int) -> tuple[int, int]:
    """(n_dec_limbs, dec_limb_bits) for splitting centered gadget digits
    (|d| <= 2^(Bgbit-1)) into int8-safe balanced limbs.

    Bgbit <= 8: digits already fit int8. Larger bases (Bg=1024) split into
    two balanced limbs.
    """
    if Bgbit <= 8:
        return 1, Bgbit
    nd = 2
    bits = (Bgbit + nd - 1) // nd + 1  # +1 headroom for balanced carry
    assert bits <= 8
    return nd, bits
