"""The plain lvl0 MUX gate in PyTorch: the benchmark's reference for MUX
traffic.

Written from TFHEpp's HomMUX and HomNMUX (gate.hpp, the lvl0 -> lvl1
bootstrap then the identity key switch back to lvl0) on the pieces of
fhebench.reference.tfhe, and independent of the program under test (it
imports nothing of it). For a selector c and data inputs x1, x0, all lvl0
ciphertexts of +-mu0:

    acc1 = BlindRotate(c + x1 - mu0)    test vector mu1: AND(c, x1)
    acc0 = BlindRotate(-c + x0 - mu0)   test vector mu1: ANDNY(c, x0)
    acc  = acc1 + acc0, then + mu1 on b's coefficient 0
    out  = IdentityKeySwitch(SampleExtract(acc, 0))

At most one of the two ANDs is true, so the sum plus mu1 is +mu1 where
the MUX is 1 and -mu1 where it is 0. NMUX (HomNMUX) negates the summed
accumulator and then subtracts mu1 from b.

One departure from TFHEpp: TFHEpp extracts each accumulator's coefficient
0 and sums the two lvl1 TLWEs, adding mu1 to the extracted body; here the
accumulators are summed first and mu1 is added to b's coefficient 0 before
the one extraction. Extraction is linear mod 2^32, so the words are the
same. The mod switch is TFHEpp's: the body truncated, every mask
coefficient rounded (as in fhebench.reference.tfhe.gate).
"""
from __future__ import annotations

import torch

from fhebench.reference import tfhe as R


def plain_mux(c, x1, x0, negate: bool = False):
    """The MUX (c ? x1 : x0), or its negation, on cleartext bits (0/1
    integer arrays or tensors)."""
    out = c * x1 + (1 - c) * x0
    return 1 - out if negate else out


def _rotate(p: R.Params, bk: torch.Tensor, tlwe: torch.Tensor) -> torch.Tensor:
    """BlindRotate of lvl0 samples tlwe [B, n0+1] (values in [0, 2^32))
    with the constant test vector mu1: the accumulator [B, k+1, N] whose
    coefficient 0 encrypts +mu1 where the phase lies in (0, 1/2) and -mu1
    elsewhere."""
    N, nbit = p.N, p.nbit
    b = tlwe[:, p.n0]
    bar = 2 * N - (b >> (32 - 1 - nbit))                # in (0, 2N]
    i = torch.arange(N, device=tlwe.device)
    # the test vector mu1 (1 + X + ... + X^(N-1)) times X^bar,
    # negacyclically: coefficient i is -mu1 where i - bar wraps past 0 an
    # odd number of times
    neg = (i[None, :] < (bar[:, None] & (N - 1))) ^ ((bar[:, None] >> nbit)
                                                     & 1).bool()
    acc = torch.zeros((tlwe.shape[0], p.k + 1, N), dtype=torch.int64,
                      device=tlwe.device)
    acc[:, p.k] = torch.where(neg, R.MOD - p.mu1, p.mu1)
    return R.blind_rotate(p, bk, tlwe[:, :p.n0], acc)


def mux(p: R.Params, ek: R.EvalKey, c: torch.Tensor, x1: torch.Tensor,
        x0: torch.Tensor, negate: bool = False) -> torch.Tensor:
    """MUX(c ? x1 : x0) of lvl0 ciphertexts [B, n0+1] (values in
    [0, 2^32)), or NMUX with negate: [B, n0+1] int64."""
    t1 = (c + x1) & R.MASK
    t1[:, p.n0] = (t1[:, p.n0] - p.mu0) & R.MASK
    t0 = (x0 - c) & R.MASK
    t0[:, p.n0] = (t0[:, p.n0] - p.mu0) & R.MASK
    acc = (_rotate(p, ek.bk, t1) + _rotate(p, ek.bk, t0)) & R.MASK
    if negate:
        acc = (-acc) & R.MASK
    acc[:, p.k, 0] = (acc[:, p.k, 0] + (-p.mu1 if negate else p.mu1)) \
        & R.MASK
    return R.key_switch(p, ek.ksk, R.sample_extract(p, acc))
