"""Cryptographically secure randomness for the client side.

A copy of cufhe_tpu/rng.py. Key generation and encryption draw from the
operating system's CSPRNG (``os.urandom``) unless a caller passes a seed
or an ``np.random.Generator``, which only tests and fixtures do: PCG64 is
reproducible but not cryptographically secure.

Only the ``np.random.Generator`` surface the client side uses is
implemented (``integers``, ``random`` and ``normal``); anything else
raises, so a new draw path fails loudly instead of falling back to PCG64.
"""
from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np


class SecureRandom:
    """np.random.Generator-compatible facade over the OS CSPRNG.

    ``integers`` uses rejection sampling for non-power-of-two ranges so
    draws are exactly uniform; ``normal`` is Box-Muller over 53-bit
    uniforms.
    """

    def _bytes(self, n: int) -> bytes:
        return os.urandom(n)

    def _raw_u64(self, count: int) -> np.ndarray:
        return np.frombuffer(self._bytes(8 * count), dtype=np.uint64)

    def integers(self, low: int, high: Optional[int] = None, size=None,
                 dtype=np.int64, endpoint: bool = False) -> np.ndarray:
        if high is None:
            low, high = 0, low
        if endpoint:
            high = high + 1
        span = int(high) - int(low)
        if span <= 0:
            raise ValueError("high must be > low")
        if span > (1 << 64):
            raise NotImplementedError("spans beyond 64 bits")
        shape = () if size is None else size
        count = int(np.prod(shape, dtype=np.int64)) if shape != () else 1
        out = np.empty(count, dtype=np.uint64)
        filled = 0
        if span & (span - 1) == 0:  # power of two: mask, no rejection
            out[:] = self._raw_u64(count) & np.uint64(span - 1)
            filled = count
        else:
            # rejection below the largest multiple of span that fits u64
            limit = (1 << 64) - ((1 << 64) % span)
            while filled < count:
                draw = self._raw_u64(count - filled + 8)
                ok = draw < np.uint64(limit)
                take = draw[ok][: count - filled]
                out[filled:filled + take.size] = take % np.uint64(span)
                filled += take.size
        res = (out.astype(np.int64) + int(low)) if low else out
        res = res.astype(dtype).reshape(shape)
        return res if size is not None else res[()]

    def random(self, size=None) -> np.ndarray:
        """Uniform [0, 1) doubles with 53 random bits."""
        shape = () if size is None else size
        count = int(np.prod(shape, dtype=np.int64)) if shape != () else 1
        u = self._raw_u64(count) >> np.uint64(11)
        res = (u.astype(np.float64) * (1.0 / (1 << 53))).reshape(shape)
        return res if size is not None else res[()]

    def normal(self, loc: float = 0.0, scale: float = 1.0,
               size=None) -> Union[float, np.ndarray]:
        shape = () if size is None else size
        count = int(np.prod(shape, dtype=np.int64)) if shape != () else 1
        n = (count + 1) // 2
        # u1 in (0, 1]: avoids log(0) without biasing the distribution
        u1 = 1.0 - self.random(n)
        u2 = self.random(n)
        r = np.sqrt(-2.0 * np.log(u1))
        z = np.concatenate([r * np.cos(2 * np.pi * u2),
                            r * np.sin(2 * np.pi * u2)])[:count]
        res = (loc + scale * z).reshape(shape)
        return res if size is not None else float(res[()])

    def __getattr__(self, name: str):
        raise AttributeError(
            f"SecureRandom implements only the draw methods the client side "
            f"uses; '{name}' is not one of them")


RngLike = Union[np.random.Generator, SecureRandom]


def resolve_rng(seed: Optional[int] = None,
                rng: Optional[RngLike] = None) -> RngLike:
    """A CSPRNG unless the caller explicitly asks for determinism:

    - both None  -> SecureRandom (the secure default);
    - seed given -> seeded PCG64 (reproducible test/fixture path);
    - rng given  -> used as-is (the caller owns the choice).
    """
    if rng is not None:
        return rng
    if seed is not None:
        return np.random.default_rng(seed)
    return SecureRandom()
