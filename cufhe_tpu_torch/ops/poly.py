"""Batched polynomial ops over Z_{2^32}[X]/(X^N+1) on int32-held torus
values: the counterparts of cufhe_tpu/ops/poly.py, bit-exact to them.

Everything is batch-first, as there. Rotation is a gather plus a sign
select; the TPU's barrel shifter of static rolls has no purpose here.
"""
from __future__ import annotations

import torch

from ..params import TrlweParams
from ..torus import i32, int_mm
from .limbs import LIMB_BITS, NLIMBS, decomp_digit_limb_plan


def _neg_mask(i: torch.Tensor, a_bar: torch.Tensor, nbit: int,
              N: int) -> torch.Tensor:
    """Sign of X^a_bar at coefficient i: wraps past N flip the sign."""
    return (i < (a_bar & (N - 1))) ^ ((a_bar >> nbit) & 1).bool()


# ---------------------------------------------------------------------------
# Test vector and negacyclic monomial rotation
# ---------------------------------------------------------------------------

def batched_test_vector(bar: torch.Tensor, mu: int,
                        p: TrlweParams) -> torch.Tensor:
    """RotatedTestVector, batched. bar: [B] int32 in [1, 2N].

    Returns acc [B, k+1, N] with a = 0 and b = mu * X^(2N - bar); masking
    (bar >> nbit) to its low bit makes bar == 2N fall out of the formula.
    """
    N = p.n
    B = bar.shape[0]
    i = torch.arange(N, device=bar.device, dtype=torch.int32)[None, :]
    neg = _neg_mask(i, bar[:, None], p.nbit, N)
    mu_i = i32(mu)
    acc = torch.zeros((B, p.k + 1, N), dtype=torch.int32, device=bar.device)
    acc[:, p.k, :] = torch.where(neg, i32(-mu), mu_i)
    return acc


def rotate_by_xai(acc: torch.Tensor, a_bar: torch.Tensor,
                  p: TrlweParams) -> torch.Tensor:
    """acc * X^a_bar negacyclically, for all k+1 components.

    acc: [B, k+1, N] int32; a_bar: [B] int32 in [0, 2N).
    """
    N = p.n
    i = torch.arange(N, device=acc.device, dtype=torch.int32)[None, :]
    a = a_bar[:, None]
    src = ((i - a) & (N - 1)).long()                       # [B, N]
    x = torch.gather(acc, 2, src[:, None, :].expand_as(acc))
    neg = _neg_mask(i, a, p.nbit, N)[:, None, :]
    return torch.where(neg, -x, x)


# ---------------------------------------------------------------------------
# Gadget decomposition
# ---------------------------------------------------------------------------

def decompose(temp: torch.Tensor, p: TrlweParams) -> torch.Tensor:
    """Signed gadget decomposition of [B, k+1, N] (already offset by
    decomp_offset + roundoffset) -> [B, (k+1)*l, N] int32 digits in
    [-Bg/2, Bg/2), row index j*l + d."""
    mask = (1 << p.Bgbit) - 1
    half = 1 << (p.Bgbit - 1)
    digs = [((temp >> (32 - (d + 1) * p.Bgbit)) & mask) - half
            for d in range(p.l)]
    out = torch.stack(digs, dim=2)                         # [B, k+1, l, N]
    B, kp1, l, N = out.shape
    return out.reshape(B, kp1 * l, N)


def decompose_rotate_sub(acc: torch.Tensor, a_bar: torch.Tensor,
                         p: TrlweParams) -> torch.Tensor:
    """decompose(acc*(X^a_bar - 1) + offsets): [B, (k+1)l, N] int32."""
    off = i32(p.decomp_offset + p.decomp_roundoffset)
    temp = rotate_by_xai(acc, a_bar, p) - acc + off
    return decompose(temp, p)


def split_decomp_digits(dec: torch.Tensor, Bgbit: int):
    """Split centered digits into int8-safe balanced limbs.

    Returns (list of int8 tensors of dec's shape, limb_bits): one cast for
    Bgbit <= 8, two balanced limbs for larger bases.
    """
    nd, bits = decomp_digit_limb_plan(Bgbit)
    if nd == 1:
        return [dec.to(torch.int8)], bits
    base = 1 << bits
    half = base >> 1
    out = []
    v = dec
    for _ in range(nd):
        d = ((v + half) & (base - 1)) - half
        out.append(d.to(torch.int8))
        v = (v - d) >> bits
    return out, bits


# ---------------------------------------------------------------------------
# Exact negacyclic product
# ---------------------------------------------------------------------------

def negacyclic_conv_toeplitz(dec8: torch.Tensor, bk_limbs: torch.Tensor,
                             k: int) -> torch.Tensor:
    """Materialise the negacyclic Toeplitz operator and contract with
    exact int8 x int8 -> int32 products.

    dec8: [B, I, N] int8; bk_limbs: [NLIMBS, I, k+1, N] int8 (natural
    order). Returns [B, k+1, N] int32 = sum over I of dec * key mod 2^32.
    """
    B, I, N = dec8.shape
    dev = dec8.device
    r = torch.arange(N, device=dev)
    idx = (r[None, :] - r[:, None]) % N                    # [row, col]
    pos = r[None, :] >= r[:, None]                         # col >= row: +
    # T[limb, i, o, row, col] = +-bk[limb, i, o, (col-row) mod N]; the sign
    # is applied by splitting into masked plus and minus parts subtracted
    # in int32 (negating the int8 limb -128 would overflow).
    gath = bk_limbs[..., idx]                              # [L, I, k+1, N, N]
    zero = torch.zeros((), dtype=torch.int8, device=dev)
    Tp = torch.where(pos, gath, zero)
    Tn = torch.where(pos, zero, gath)

    def _flat(T):                       # [L, (i, row), (o, col)]
        return T.permute(0, 1, 3, 2, 4).reshape(NLIMBS, I * N, (k + 1) * N)

    Tp, Tn = _flat(Tp), _flat(Tn)
    lhs = dec8.reshape(B, I * N)
    out = torch.zeros((B, (k + 1) * N), dtype=torch.int32, device=dev)
    for l in range(NLIMBS):
        prod = int_mm(lhs, Tp[l]) - int_mm(lhs, Tn[l])
        out += prod << (LIMB_BITS * l)
    return out.reshape(B, k + 1, N)


# ---------------------------------------------------------------------------
# Sample extraction
# ---------------------------------------------------------------------------

def sample_extract_index0(acc: torch.Tensor, p: TrlweParams) -> torch.Tensor:
    """SampleExtractIndex<0>, batched: [B, k+1, N] -> [B, k*N + 1]."""
    B, _, N = acc.shape
    a = acc[:, :p.k, :]
    ext = torch.cat([a[:, :, :1], -a.flip(-1)[:, :, :N - 1]], dim=2)
    return torch.cat([ext.reshape(B, p.k * N), acc[:, p.k, :1]], dim=1)


def sample_extract_for_ks(acc: torch.Tensor, p: TrlweParams) -> torch.Tensor:
    """Sample extraction in key-switch input form: elementwise, no reverse.

        c[j, 0] = a[j, 0],  c[j, i] = -a[j, i]  (i >= 1)

    The negacyclic index reversal of the true extraction lives in the KSK
    rows (keys.prepare_keys builds ksk_tiles), so
    key_switch(sample_extract_for_ks(acc), ksk_tiles) equals
    key_switch(sample_extract_index0(acc), natural-order KSK).
    """
    B, _, N = acc.shape
    a = acc[:, :p.k, :]
    i = torch.arange(N, device=acc.device)[None, None, :]
    c = torch.where(i == 0, a, -a)
    return torch.cat([c.reshape(B, p.k * N), acc[:, p.k, :1]], dim=1)
