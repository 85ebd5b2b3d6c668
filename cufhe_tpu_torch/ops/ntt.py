"""Negacyclic NTT over the RAINTT prime: the counterpart of
cufhe_tpu/ops/ntt.py, bit-exact to it.

The `ntt` gate backend (the reference's USE_SMALL_NTT_MODULUS mode) runs
its external product through these transforms: digits and the bootstrapping
key lifted to Z_p, p = 655360001 = 625 * 2^20 + 1, forward NTT, pointwise
Shoup multiply-accumulate, inverse NTT, back to the torus. It is a parity
path, not a speed path: the exact integer product of ops/blind_rotate.py is
what the port runs by default.

Host side (NumPy, copies of the JAX package's): the twiddle tables
(make_tables), the exact torus <-> Z_p switches and the forward transform
that prepares the key once (ntt_forward_host).

Tensor side (torch ops on the input's device): mod-p values and the uint32
values they mix with are held in int64, since torch's uint32 has no
arithmetic on the CPU (ROADMAP F1). Every high product is taken where it is
exact in int64 (below 2^63); every low product or sum that the JAX code
takes mod 2^32 is masked with & 0xFFFFFFFF.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

#: RAINTT prime (reference ntt_small_modulus.cuh:30): 625 * 2^20 + 1.
P = 655360001

_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Host-side tables and conversions (NumPy, exact)
# ---------------------------------------------------------------------------

def _find_generator(p: int = P) -> int:
    """Smallest generator of Z_p^* (p - 1 = 2^20 * 5^4)."""
    for g in range(2, 1000):
        if pow(g, (p - 1) // 2, p) != 1 and pow(g, (p - 1) // 5, p) != 1:
            return g
    raise RuntimeError("no generator found")


def _bit_reverse(x: np.ndarray) -> np.ndarray:
    n = len(x)
    bits = n.bit_length() - 1
    idx = np.array([int(f"{i:0{bits}b}"[::-1], 2) for i in range(n)])
    return x[idx]


@functools.lru_cache(maxsize=None)
def make_tables(nbit: int, p: int = P) -> dict:
    """Twiddle tables of the negacyclic NTT of length N = 2^nbit: uint32
    psi_rev / ipsi_rev (bit-reversed powers of the 2N-th root of unity and
    of its inverse) with their Shoup companions floor(w * 2^32 / p), and
    n_inv with its companion."""
    N = 1 << nbit
    assert (p - 1) % (2 * N) == 0, "2N must divide p-1"
    g = _find_generator(p)
    psi = pow(g, (p - 1) // (2 * N), p)
    psi_pows = np.array([pow(psi, i, p) for i in range(N)], dtype=np.uint64)
    ipsi = pow(psi, p - 2, p)
    ipsi_pows = np.array([pow(ipsi, i, p) for i in range(N)], dtype=np.uint64)
    psi_rev = _bit_reverse(psi_pows)
    ipsi_rev = _bit_reverse(ipsi_pows)
    n_inv = pow(N, p - 2, p)
    shoup = lambda w: ((w.astype(np.object_) << 32) // p).astype(np.uint64)  # noqa: E731
    return {
        "psi_rev": psi_rev.astype(np.uint32),
        "psi_rev_shoup": shoup(psi_rev).astype(np.uint32),
        "ipsi_rev": ipsi_rev.astype(np.uint32),
        "ipsi_rev_shoup": shoup(ipsi_rev).astype(np.uint32),
        "n_inv": np.uint32(n_inv),
        "n_inv_shoup": np.uint32((n_inv << 32) // p),
    }


def mod_to_torus(x: np.ndarray, p: int = P) -> np.ndarray:
    """round(x * 2^32 / p) mod 2^32, exact (NumPy u64): ntt_mod_to_torus32
    (ntt_small_modulus.cuh:58-73)."""
    x = np.asarray(x, dtype=np.uint64)
    return (((x << 32) + p // 2) // p).astype(np.uint32)


def torus_to_mod_host(a: np.ndarray, p: int = P) -> np.ndarray:
    """round(a * p / 2^32) mod p, exact (NumPy u64)."""
    q = ((np.asarray(a, dtype=np.uint64) * p + (1 << 31)) >> 32)
    return np.where(q >= p, q - p, q).astype(np.uint32)


def ntt_forward_host(a: np.ndarray, tables: dict, p: int = P) -> np.ndarray:
    """NumPy u64 forward negacyclic NTT, the structure of ntt_forward: the
    one-time preparation of the `ntt` backend's key (keys.prepare_keys)."""
    a = np.asarray(a, dtype=np.uint64) % p
    N = a.shape[-1]
    psi = tables["psi_rev"].astype(np.uint64)
    lead = a.shape[:-1]
    t, m = N, 1
    while m < N:
        t //= 2
        x = a.reshape(lead + (m, 2, t))
        w = psi[m:2 * m].reshape((1,) * len(lead) + (m, 1))
        u, v = x[..., 0, :], (x[..., 1, :] * w) % p
        a = np.stack([(u + v) % p, (u + p - v) % p],
                     axis=-2).reshape(lead + (N,))
        m *= 2
    return a.astype(np.uint32)


def shoup_precompute(b: np.ndarray, p: int = P) -> np.ndarray:
    """floor(b * 2^32 / p) for operands prepared on the host."""
    return ((np.asarray(b, dtype=np.uint64) << 32) // p).astype(np.uint32)


# ---------------------------------------------------------------------------
# Modular primitives on int64 tensors of uint32 values
# ---------------------------------------------------------------------------

def _mulhi_u32(a: torch.Tensor, b) -> torch.Tensor:
    """High 32 bits of the 64-bit product of two uint32 values, for any
    operands below 2^32: b is split at bit 16 so every int64 product stays
    below 2^48."""
    return (a * (b >> 16) + ((a * (b & 0xFFFF)) >> 16)) >> 16


def mulmod_shoup(x: torch.Tensor, w, w_shoup, p: int = P) -> torch.Tensor:
    """x * w mod p with w < p constant and w_shoup = floor(w * 2^32 / p)
    (Harvey/Shoup), for x < p, the values of the whole path: then
    w_shoup * x < 2^62, so its high half is one exact int64 product, and
    w * x - q * p is already in [0, 2p)."""
    q = (w_shoup * x) >> 32
    r = w * x - q * p
    return torch.where(r >= p, r - p, r)


def addmod(a: torch.Tensor, b: torch.Tensor, p: int = P) -> torch.Tensor:
    s = (a + b) & _M32
    return torch.where(s >= p, s - p, s)


def submod(a: torch.Tensor, b: torch.Tensor, p: int = P) -> torch.Tensor:
    return torch.where(a >= b, a - b, (a + p - b) & _M32)


def torus_to_mod(a: torch.Tensor, p: int = P) -> torch.Tensor:
    """round(a * p / 2^32) mod p for uint32 values a (torus32_to_ntt_mod,
    ntt_small_modulus.cuh:40-56): a * p < 2^62 is exact in int64."""
    prod = a * p
    r = ((prod >> 32) + ((prod & _M32) >> 31)) & _M32
    return torch.where(r >= p, r - p, r)


def mod_to_torus_jax(x: torch.Tensor, p: int = P) -> torch.Tensor:
    """The gate path's mod -> torus switch, x * floor(2^64 / p) >> 32 mod
    2^32, as uint32 values: within 2 torus LSB of the exact mod_to_torus
    and bit-exact to the JAX package's function of the same name, which
    the JAX `ntt` path uses."""
    inv = (1 << 64) // p                            # a 35-bit constant
    hi, lo = inv >> 32, inv & _M32
    return (x * hi + _mulhi_u32(x, lo)) & _M32


# ---------------------------------------------------------------------------
# Transforms, vectorized over leading axes
# ---------------------------------------------------------------------------

#: (id(tables), device) -> (tables, their twiddle tensors on device); the
#: entry holds the tables themselves, so an id is never reused while cached
_DEVICE_TABLES: dict = {}


def _table(tables: dict, name: str, device) -> torch.Tensor:
    """tables[name] as int64 on `device`, uploaded once per device: an
    upload from pageable host memory per transform would wait for the
    device every step."""
    key = (id(tables), device)
    if key not in _DEVICE_TABLES:
        _DEVICE_TABLES[key] = (tables, {
            k: torch.from_numpy(np.asarray(v, dtype=np.int64)).to(device)
            for k, v in tables.items() if np.ndim(v)})
    return _DEVICE_TABLES[key][1][name]


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 uint32 values -> the int32 tensor with the same bits (the
    port's torus form)."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def ntt_forward(a: torch.Tensor, tables: dict, p: int = P) -> torch.Tensor:
    """Negacyclic forward NTT, natural order in, bit-reversed order out.
    a: [..., N] int64 values < p. Cooley-Tukey with the psi twist folded
    into the twiddles; the JAX function's stages, one per power of two."""
    N = a.shape[-1]
    psi = _table(tables, "psi_rev", a.device)
    psi_s = _table(tables, "psi_rev_shoup", a.device)
    lead = tuple(a.shape[:-1])
    t, m = N, 1
    while m < N:
        t //= 2
        x = a.reshape(lead + (m, 2, t))
        w = psi[m:2 * m].reshape((m, 1))
        ws = psi_s[m:2 * m].reshape((m, 1))
        u, v = x[..., 0, :], mulmod_shoup(x[..., 1, :], w, ws, p)
        a = torch.stack([addmod(u, v, p), submod(u, v, p)],
                        dim=-2).reshape(lead + (N,))
        m *= 2
    return a


def ntt_inverse(a: torch.Tensor, tables: dict, p: int = P) -> torch.Tensor:
    """Inverse negacyclic NTT, bit-reversed order in, natural order out
    (Gentleman-Sande), scaled by N^-1."""
    N = a.shape[-1]
    ipsi = _table(tables, "ipsi_rev", a.device)
    ipsi_s = _table(tables, "ipsi_rev_shoup", a.device)
    lead = tuple(a.shape[:-1])
    t, m = 1, N
    while m > 1:
        m //= 2
        x = a.reshape(lead + (m, 2, t))
        w = ipsi[m:2 * m].reshape((m, 1))
        ws = ipsi_s[m:2 * m].reshape((m, 1))
        u, v = x[..., 0, :], x[..., 1, :]
        a = torch.stack([addmod(u, v, p),
                         mulmod_shoup(submod(u, v, p), w, ws, p)],
                        dim=-2).reshape(lead + (N,))
        t *= 2
    return mulmod_shoup(a, int(tables["n_inv"]), int(tables["n_inv_shoup"]),
                        p)


def pointwise_mul(a_ntt: torch.Tensor, b_ntt: torch.Tensor,
                  b_shoup: torch.Tensor, p: int = P) -> torch.Tensor:
    """a * b mod p pointwise, b with its Shoup companion (the key side of
    the NTT-domain multiply-accumulate)."""
    return mulmod_shoup(a_ntt, b_ntt, b_shoup, p)


def negacyclic_mul_mod_p(a: torch.Tensor, b_ntt: torch.Tensor,
                         b_shoup: torch.Tensor, tables: dict,
                         p: int = P) -> torch.Tensor:
    """Forward NTT -> pointwise -> inverse NTT: the negacyclic product
    a * b mod p, b already in NTT form. Kept for the JAX package's API: the
    gate path (bootstrap.blind_rotate_ntt) sums the products before its one
    inverse transform."""
    return ntt_inverse(pointwise_mul(ntt_forward(a, tables, p), b_ntt,
                                     b_shoup, p), tables, p)
