"""Identity key switch as a signed one-hot x KSK product: the counterpart of
cufhe_tpu/ops/keyswitch.py, bit-exact to it.

Each decomposed digit selects a KSK row through a {-1, 0, +1} coefficient
matrix, so the whole key switch is NLIMBS exact int8 x int8 -> int32
products. The coefficients are int8, not bf16 as on the TPU: on CUDA a
bf16 product may reduce in lower precision, while int8 with int32
accumulation is exact (the sums stay below K * 128 <= 2^21).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..params import GateParams
from ..torus import i32, int_mm
from .limbs import LIMB_BITS, NLIMBS


def ks_decompose_coeffs(a_in: torch.Tensor, params: GateParams) -> torch.Tensor:
    """[B, d1] int32 -> [B, t*numbase*d1] int8 selection coefficients.

    Digit val in [-halfbase, halfbase); val = +(m+1) selects row m with -1,
    val = -(m+1) selects row m with +1 (subtract for a positive digit).
    The contraction axis is (dig, m, j)-major, matching the KSK row order
    that keys.prepare_keys lays out.
    """
    kp = params.ks
    mask = (1 << kp.basebit) - 1
    halfbase = 1 << (kp.basebit - 1)
    tmp = a_in + i32(kp.decomp_offset + kp.roundoffset)
    blocks = []
    for dig in range(kp.t):
        val = ((tmp >> (32 - (dig + 1) * kp.basebit)) & mask) - halfbase
        for m in range(kp.numbase):
            blocks.append((val == -(m + 1)).to(torch.int8)
                          - (val == (m + 1)).to(torch.int8))
    return torch.cat(blocks, dim=1)                    # [B, t*nb*d1]


def _per_row(c, shape):
    """A pre-add constant: an int mod 2^32 (its int32 representative), or
    an int32 tensor of one value per row ([B] or [B, 1]) reshaped to
    `shape`."""
    return c.reshape(shape) if isinstance(c, torch.Tensor) else i32(c)


def key_switch(tlwe1: torch.Tensor, ksk_limbs: torch.Tensor,
               params: GateParams, pre=None,
               perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """KeySwitchFromTLWE / IdentityKeySwitchPreAdd, batched.

    tlwe1: [B, d1+1] int32; ksk_limbs: [NLIMBS, K, n0+1] int8;
    pre = (ca, cb, offset, other) fuses the gate linear combination: ca,
    cb and offset are ints mod 2^32 or int32 tensors with one value per
    row ([B] or [B, 1]), other is [B, d1+1]. perm, if given, gathers the
    d1 mask columns after the pre-add (keys.DeviceKeys.sei_perm: a
    natural-order input against ksk_limbs_sei). Returns [B, n0+1] int32.
    """
    d1 = params.lvl1.k * params.lvl1.n
    n0 = params.lvl0.dim
    if pre is not None:
        ca, cb, off, other = pre
        comb = _per_row(ca, (-1, 1)) * tlwe1 + _per_row(cb, (-1, 1)) * other
        a_in = comb[:, :d1]
        b_in = comb[:, d1] + _per_row(off, (-1,))
    else:
        a_in = tlwe1[:, :d1]
        b_in = tlwe1[:, d1]
    if perm is not None:
        a_in = a_in[:, perm]
    co = ks_decompose_coeffs(a_in, params)
    out = None
    for l in range(NLIMBS):
        prod = int_mm(co, ksk_limbs[l]) << (LIMB_BITS * l)
        out = prod if out is None else out + prod
    out[:, n0] += b_in
    return out
