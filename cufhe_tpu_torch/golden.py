"""The port's NumPy client side and its gate oracle.

A copy of the lvl0-gate part of cufhe_tpu/golden.py, so that the port never
imports the JAX package: secret and evaluation key generation, batched
encryption and decryption of bits, and the plain NumPy lvl0 gate
(gate_lvl0) that the device path is checked against. With the same seeds
and parameters every function here returns exactly what its namesake in
cufhe_tpu/golden.py returns (tests/test_torch_golden.py).

All torus arithmetic is uint32 with wrap-around; signed intermediate work
is done in int64.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .params import GateParams, TrlweParams
from .rng import RngLike, resolve_rng

U32 = np.uint32
_MOD = 1 << 32


def _u32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.int64).astype(np.uint32)


# ---------------------------------------------------------------------------
# Keys, encryption, decryption
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SecretKey:
    params: GateParams
    lvl0: np.ndarray  # [k0*n0] uint32 in {0,1}
    lvl1: np.ndarray  # [k1, N]  uint32 in {0,1}


def keygen(params: GateParams, seed: Optional[int] = None) -> SecretKey:
    """Secret keygen. seed=None draws from the OS CSPRNG; pass a seed only
    for reproducible tests and fixtures."""
    rng = resolve_rng(seed)
    sk0 = rng.integers(0, 2, size=params.lvl0.dim, dtype=np.uint32)
    sk1 = rng.integers(0, 2, size=(params.lvl1.k, params.lvl1.n),
                       dtype=np.uint32)
    return SecretKey(params, sk0, sk1)


def _gaussian_torus(rng: RngLike, alpha: float, shape) -> np.ndarray:
    """Modular-Gaussian torus noise."""
    if alpha == 0.0:
        return np.zeros(shape, dtype=np.uint32)
    noise = rng.normal(0.0, alpha, size=shape)
    return np.round(noise * float(_MOD)).astype(np.int64).astype(np.uint32)


def tlwe_encrypt_batch(mus: np.ndarray, key: np.ndarray, alpha: float,
                       rng: Optional[RngLike] = None) -> np.ndarray:
    """Batch TLWE encryption: [B] torus messages -> [B, d+1] samples with
    b = <a, s> + mu + e."""
    rng = resolve_rng(rng=rng)
    mus = np.asarray(mus, dtype=np.uint32)
    d = key.shape[0]
    a = rng.integers(0, _MOD, size=(mus.shape[0], d),
                     dtype=np.uint64).astype(np.uint32)
    e = _gaussian_torus(rng, alpha, mus.shape[0])
    # <a, s> with a < 2^32, s in {0,1}, d <= 2048: fits int64 exactly
    b = _u32(a.astype(np.int64) @ key.astype(np.int64)
             + mus.astype(np.int64) + e.astype(np.int64))
    return np.concatenate([a, b[:, None]], axis=1)


def encrypt_bit_batch(bits: np.ndarray, sk: SecretKey,
                      rng: Optional[RngLike] = None) -> np.ndarray:
    """Encrypt a bit array as +-mu at lvl0 in one batch draw:
    [B, n0+1] uint32."""
    rng = resolve_rng(rng=rng)
    lp = sk.params.lvl0
    bits = np.asarray(bits).ravel()
    mus = np.where(bits == 1, U32(lp.mu), U32((-lp.mu) % _MOD))
    return tlwe_encrypt_batch(mus, sk.lvl0, lp.alpha, rng)


def decrypt_bit_batch(cts: np.ndarray, sk: SecretKey,
                      level: int = 0) -> np.ndarray:
    """Decrypt [B, d+1] ciphertexts to a bit array: 1 where the phase, read
    as int32, is positive."""
    key = sk.lvl0 if level == 0 else sk.lvl1.reshape(-1)
    d = key.shape[0]
    cts = np.asarray(cts)
    phase = _u32(cts[:, d].astype(np.int64)
                 - cts[:, :d].astype(np.int64) @ key.astype(np.int64))
    return (phase.astype(np.int32) > 0).astype(np.int64)


def _negacyclic_matrix(s: np.ndarray) -> np.ndarray:
    """[N, N] matrix S with (a @ S) = the negacyclic product a * s.
    S[u, v] = s[(v-u) mod N] * (-1 if v < u else 1)."""
    n = s.shape[0]
    u = np.arange(n)[:, None]
    v = np.arange(n)[None, :]
    S = s[(v - u) % n].astype(np.int64)
    return np.where(v < u, -S, S)


def _binary_key_polymul_batch(a: np.ndarray, s: np.ndarray) -> np.ndarray:
    """Exact batched negacyclic product a[i] * s for uint32 a, binary s:
    two float64 matmuls on 16-bit limbs of `a` (each partial sum < 2^26,
    so float64 is exact), recombined in int64."""
    S = _negacyclic_matrix(s).astype(np.float64)
    lo = (a & np.uint32(0xFFFF)).astype(np.float64)
    hi = (a >> np.uint32(16)).astype(np.float64)
    return ((hi @ S).astype(np.int64) << 16) + (lo @ S).astype(np.int64)


def trlwe_encrypt_zero_batch(m: int, p: TrlweParams, key: np.ndarray,
                             rng: Optional[RngLike] = None) -> np.ndarray:
    """m TRLWE encryptions of 0 in one draw: [m, k+1, N] uint32."""
    rng = resolve_rng(rng=rng)
    N, k = p.n, p.k
    a = rng.integers(0, _MOD, size=(m, k, N),
                     dtype=np.uint64).astype(np.uint32)
    b = np.zeros((m, N), dtype=np.int64)
    for j in range(k):
        b += _binary_key_polymul_batch(a[:, j], key[j])
    b = _u32(b + _gaussian_torus(rng, p.alpha, (m, N)).astype(np.int64))
    return np.concatenate([a, b[:, None, :].astype(np.uint32)], axis=1)


@dataclasses.dataclass
class EvalKey:
    """Server-side keys: raw (coefficient-domain) BK and KSK.

    bk:  [n0, (k+1)l, k+1, N] uint32: TRGSW(sk0[i]) for each lvl0 coefficient
    ksk: [k1*N, t, numbase, k0*n0+1] uint32: ksk[j, dig, m] encrypts
         sk1[j]*(m+1)*2^(32-(dig+1)basebit) under sk0 (a positive digit
         subtracts its row).
    """
    params: GateParams
    bk: np.ndarray
    ksk: np.ndarray


def make_eval_key(sk: SecretKey, seed: Optional[int] = None) -> EvalKey:
    """Vectorised keygen: all n0*(k+1)*l BK zero-TRLWEs and all
    d1*t*numbase KSK samples are drawn and combined as single batched
    operations. seed=None draws from the OS CSPRNG; seed only for tests."""
    p = sk.params
    rng = resolve_rng(seed)
    n0 = p.lvl0.dim
    lp = p.lvl1
    k, l, N = lp.k, lp.l, lp.n
    rows = (k + 1) * l

    # BK: bk[i, j*l+d] = TRLWE(0) + sk0[i] * 2^(32-(d+1)Bgbit) on
    # component j, coefficient 0 (the gadget).
    zeros = trlwe_encrypt_zero_batch(n0 * rows, lp, sk.lvl1, rng)
    bk = zeros.reshape(n0, rows, k + 1, N)
    h = (np.uint64(1) << np.uint64(32) - np.uint64(lp.Bgbit)
         * (np.arange(l, dtype=np.uint64) + 1)).astype(np.uint32)  # [l]
    gad = (sk.lvl0[:, None].astype(np.uint64)
           * h[None, :].astype(np.uint64)).astype(np.uint32)       # [n0, l]
    j_idx = np.repeat(np.arange(k + 1), l)          # component of row j*l+d
    d_idx = np.tile(np.arange(l), k + 1)
    bk[:, np.arange(rows), j_idx, 0] += gad[:, d_idx]

    # KSK: ksk[j, dig, m] = TLWE(dom[j] * (m+1) * 2^(32-(dig+1)basebit)).
    kp = p.ks
    dom = sk.lvl1.reshape(-1)  # extracted-LWE key = lvl1 coefficients in order
    d1 = dom.shape[0]
    shift = (np.uint64(32) - np.uint64(kp.basebit)
             * (np.arange(kp.t, dtype=np.uint64) + 1))
    scale = ((np.arange(kp.numbase, dtype=np.uint64) + 1)[None, :]
             << shift[:, None])                     # [t, numbase] (mod 2^64)
    mus = (dom.astype(np.uint64)[:, None, None]
           * scale[None, :, :]).astype(np.uint32)   # [d1, t, numbase]
    ksk = tlwe_encrypt_batch(mus.reshape(-1), sk.lvl0, p.lvl0.alpha, rng)
    return EvalKey(p, bk, ksk.reshape(d1, kp.t, kp.numbase, n0 + 1))


# ---------------------------------------------------------------------------
# The lvl0 gate, one ciphertext at a time
# ---------------------------------------------------------------------------

def negacyclic_polymul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Exact negacyclic product of two int64-safe length-N arrays, as int64
    (not reduced mod 2^32; the caller reduces)."""
    n = a.shape[0]
    full = np.convolve(a.astype(np.int64), b.astype(np.int64))
    out = full[:n].copy()
    out[: n - 1] -= full[n:]
    return out


def mod_switch_from_torus(phase, nbit: int) -> np.ndarray:
    """The top nbit+1 bits of the phase (no rounding)."""
    return (np.asarray(phase, dtype=np.uint32) >> U32(32 - 1 - nbit)).astype(
        np.uint32)


def rotated_test_vector(p: TrlweParams, bar: int, mu: int) -> np.ndarray:
    """The constant-mu test vector times X^bar, bar in [1, 2N]: [k+1, N]."""
    N = p.n
    out = np.zeros((p.k + 1, N), dtype=np.uint32)
    mu_u = U32(mu % _MOD)
    neg_mu = U32((-int(mu)) % _MOD)
    if bar == 2 * N:
        out[p.k, :] = mu_u
    else:
        i = np.arange(N)
        neg = (i < (bar & (N - 1))) ^ bool((bar >> p.nbit) & 1)
        out[p.k, :] = np.where(neg, neg_mu, mu_u)
    return out


def _rotate_by_xai(poly: np.ndarray, a_bar: int, p: TrlweParams) -> np.ndarray:
    """poly * X^{a_bar}, negacyclically (a gather and a sign)."""
    N = p.n
    i = np.arange(N)
    src = poly[(i - a_bar) % N]
    neg = (i < (a_bar & (N - 1))) ^ bool((a_bar >> p.nbit) & 1)
    return np.where(neg, _u32(-src.astype(np.int64)), src)


def decompose_rotate_sub(acc: np.ndarray, a_bar: int,
                         p: TrlweParams) -> np.ndarray:
    """acc * (X^a_bar - 1), then the signed gadget decomposition:
    [k+1, l, N] int32 digits in [-Bg/2, Bg/2)."""
    mask = U32((1 << p.Bgbit) - 1)
    half = 1 << (p.Bgbit - 1)
    off = U32((p.decomp_offset + p.decomp_roundoffset) % _MOD)
    out = np.empty((p.k + 1, p.l, acc.shape[1]), dtype=np.int32)
    for j in range(p.k + 1):
        temp = _u32(_rotate_by_xai(acc[j], a_bar, p).astype(np.int64)
                    - acc[j].astype(np.int64) + int(off))
        for d in range(p.l):
            sh = U32(32 - (d + 1) * p.Bgbit)
            out[j, d] = ((temp >> sh) & mask).astype(np.int64).astype(
                np.int32) - half
    return out


def external_product_accumulate(acc: np.ndarray, a_bar: int,
                                trgsw: np.ndarray,
                                p: TrlweParams) -> np.ndarray:
    """One CMUX step: acc += <decomp(acc * (X^a_bar - 1)), trgsw>."""
    dec = decompose_rotate_sub(acc, a_bar, p)
    upd = np.zeros((p.k + 1, p.n), dtype=np.int64)
    for j in range(p.k + 1):
        for d in range(p.l):
            row = trgsw[j * p.l + d]
            for o in range(p.k + 1):
                upd[o] += negacyclic_polymul(dec[j, d].astype(np.int64),
                                             row[o].astype(np.int64))
    return _u32(acc.astype(np.int64) + upd)


def blind_rotate(tlwe: np.ndarray, mu: int, ek: EvalKey,
                 pre: Optional[tuple] = None) -> np.ndarray:
    """Blind rotation of a lvl0 ciphertext [n0+1]; with `pre` =
    (ca, cb, offset, tlwe1) the gate linear combination is fused in.
    Returns the TRLWE accumulator [k+1, N]."""
    p = ek.params
    lp = p.lvl1
    n0 = p.lvl0.dim
    if pre is not None:
        ca, cb, offset, tlwe1 = pre
        comb = _u32(np.int64(ca) * tlwe.astype(np.int64)
                    + np.int64(cb) * tlwe1.astype(np.int64))
        b_in = _u32(int(comb[n0]) + offset)
        a_in = comb[:n0]
    else:
        b_in = tlwe[n0]
        a_in = tlwe[:n0]

    bar = 2 * lp.n - int(mod_switch_from_torus(b_in, lp.nbit))
    acc = rotated_test_vector(lp, bar, mu)
    roundoffset = 1 << (32 - 2 - lp.nbit)
    for i in range(n0):
        a_bar = int(mod_switch_from_torus(_u32(int(a_in[i]) + roundoffset),
                                          lp.nbit))
        acc = external_product_accumulate(acc, a_bar, ek.bk[i], lp)
    return acc


def sample_extract_index0(trlwe: np.ndarray, p: TrlweParams) -> np.ndarray:
    """The lvl1-domain TLWE [k*N + 1] of coefficient 0 of a TRLWE."""
    N, k = p.n, p.k
    out = np.empty(k * N + 1, dtype=np.uint32)
    for kk in range(k):
        a = trlwe[kk]
        ext = np.empty(N, dtype=np.uint32)
        ext[0] = a[0]
        ext[1:] = _u32(-a[N - 1:0:-1].astype(np.int64))
        out[kk * N:(kk + 1) * N] = ext
    out[k * N] = trlwe[k, 0]
    return out


def key_switch(tlwe1: np.ndarray, ek: EvalKey) -> np.ndarray:
    """Identity key switch of a lvl1-domain TLWE [k1*N + 1] to lvl0
    [n0+1]."""
    p = ek.params
    kp = p.ks
    d1 = p.lvl1.k * p.lvl1.n
    n0 = p.lvl0.dim
    res = np.zeros(n0 + 1, dtype=np.int64)
    res[n0] = int(tlwe1[d1])  # domain and target are both 32-bit torus
    mask = (1 << kp.basebit) - 1
    halfbase = 1 << (kp.basebit - 1)
    off = (kp.decomp_offset + kp.roundoffset) % _MOD
    tmp = _u32(tlwe1[:d1].astype(np.int64) + off)
    for j in range(d1):
        for dig in range(kp.t):
            val = int((int(tmp[j]) >> (32 - (dig + 1) * kp.basebit)) & mask) \
                - halfbase
            if val > 0:
                res -= ek.ksk[j, dig, val - 1].astype(np.int64)
            elif val < 0:
                res += ek.ksk[j, dig, -val - 1].astype(np.int64)
    return _u32(res)


#: gate -> (casign, cbsign, offset-multiplier-of-mu)
GATE_CONSTANTS = {
    "nand": (-1, -1, +1),
    "nor": (-1, -1, -1),
    "xnor": (-2, -2, -2),
    "and": (1, 1, -1),
    "or": (1, 1, +1),
    "xor": (2, 2, +2),
    "andny": (-1, 1, -1),
    "andyn": (1, -1, -1),
    "orny": (-1, 1, +1),
    "oryn": (1, -1, +1),
}

#: plaintext truth tables
PLAIN_GATES = {
    "nand": lambda a, b: 1 - (a & b),
    "nor": lambda a, b: 1 - (a | b),
    "xnor": lambda a, b: 1 - (a ^ b),
    "and": lambda a, b: a & b,
    "or": lambda a, b: a | b,
    "xor": lambda a, b: a ^ b,
    "andny": lambda a, b: (1 - a) & b,
    "andyn": lambda a, b: a & (1 - b),
    "orny": lambda a, b: (1 - a) | b,
    "oryn": lambda a, b: a | (1 - b),
    "mux": lambda c, a, b: a if c else b,
    "nmux": lambda c, a, b: 1 - (a if c else b),
    "not": lambda a: 1 - a,
    "copy": lambda a: a,
}


def gate_lvl0(name: str, in0: np.ndarray, in1: np.ndarray,
              ek: EvalKey) -> np.ndarray:
    """Two-input gate on lvl0 ciphertexts [n0+1]: blind rotation with the
    pre-add fused, sample extraction, key switch back to lvl0."""
    p = ek.params
    ca, cb, om = GATE_CONSTANTS[name]
    offset = (om * p.lvl0.mu) % _MOD
    acc = blind_rotate(in0, p.lvl1.mu, ek, pre=(ca, cb, offset, in1))
    return key_switch(sample_extract_index0(acc, p.lvl1), ek)
