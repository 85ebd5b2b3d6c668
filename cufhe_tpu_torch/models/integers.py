"""Encrypted multi-bit integers on programmable bootstrapping.

The counterpart of cufhe_tpu/models/integers.py, bit-exact to it. An
integer is a little-endian vector of radix-2^m *digits*, each a lvl0 TLWE
encrypting value v in [0, 2^m) at phase v*Delta:

    Delta = 2^32 / 2^(b+1),  b = buf_bits = msg_bits + 1

The extra buffer bit b > m holds carries accumulated linearly (ciphertext
adds are exact on the torus), and the top padding bit keeps every legal
phase in [0, 2^31) so a negacyclic LUT is single-valued. A full adder is
one blind rotation through the multi-output bootstrap
(ops.bootstrap.pbs_many): t = x_d + y_d + carry is a plain ciphertext
sum, and the sum digit (t mod 2^m) and carry digit (t >> m) come out of
the same rotation as two interleaved LUTs.

Digits are int32 tensors [B, D, n0+1] on the context's device that wrap
mod 2^32 (the uint32 bits of the JAX package's arrays). What the JAX
package scans inside one compiled program (the carry chain, the rows of a
product, the steps of a division) is a Python loop of the same pbs_many
calls here, each one launch of the blind-rotation kernel on the card;
every digit tensor is made on the caller's current stream.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import golden as G
from ..ops import bootstrap as B
from ..torus import from_u32, i32, to_u32
from .api import Context, Ctxt, _ready_event

_MOD = 1 << 32


@dataclasses.dataclass(frozen=True)
class IntCodec:
    """Digit encoding: msg_bits per digit, one carry-buffer bit, one
    padding bit. buf_bits defaults to msg_bits + 1 (exactly the headroom
    a ripple full adder needs: x + y + carry <= 2^(m+1) - 1)."""
    msg_bits: int = 1
    buf_bits: Optional[int] = None

    def __post_init__(self):
        if self.buf_bits is None:
            object.__setattr__(self, "buf_bits", self.msg_bits + 1)
        if self.buf_bits < self.msg_bits + 1:
            raise ValueError(f"buf_bits {self.buf_bits} < msg_bits + 1")

    @property
    def base(self) -> int:
        return 1 << self.msg_bits

    @property
    def delta(self) -> int:
        return 1 << (31 - self.buf_bits)

    def digits_for(self, bits: int) -> int:
        return -(-bits // self.msg_bits)


@dataclasses.dataclass
class IntCtxt:
    """A batch of encrypted unsigned integers: digits [B, D, n0+1] int32,
    little-endian radix-2^msg_bits. Digits are always *clean* (fresh from
    encryption or a bootstrap, value < 2^msg_bits)."""
    digits: torch.Tensor
    codec: IntCodec

    @property
    def batch(self) -> int:
        return self.digits.shape[0]

    @property
    def ndigits(self) -> int:
        return self.digits.shape[1]

    @property
    def bits(self) -> int:
        return self.ndigits * self.codec.msg_bits


# ---------------------------------------------------------------------------
# Test-polynomial (LUT) construction (NumPy, a copy of the JAX package's)
# ---------------------------------------------------------------------------

def build_tv(outs: Sequence[np.ndarray], buf_bits: int, N: int) -> np.ndarray:
    """Interleave J LUTs into one test polynomial for pbs_many.

    outs: J arrays of 2^buf_bits uint32 torus outputs. Slot geometry:
    value v sits at phase v*Delta -> windows [v*dw - dw/2, v*dw + dw/2)
    with dw = N >> buf_bits coefficients per slot; tv[x] = outs[x % J][v(x)]
    so extraction at coefficient j (window w + j, w 2^theta-aligned) reads
    LUT j. The tail x >= N - dw/2 is the negacyclic wrap of v=0's negative
    noise lobe: extraction negates there, so it stores -outs[j][0]."""
    J = len(outs)
    dw = N >> buf_bits
    assert dw >= 2 * J, (dw, J, "LUT slots too narrow for interleaving")
    x = np.arange(N)
    v = (x + dw // 2) // dw                     # 0 .. 2^buf_bits
    nslots = 1 << buf_bits
    tv = np.zeros(N, dtype=np.uint32)
    for j in range(J):
        o = np.asarray(outs[j], dtype=np.uint32)
        assert o.shape == (nslots,)
        col = np.where(v < nslots, o[np.minimum(v, nslots - 1)],
                       (-o[0].astype(np.int64)) % _MOD).astype(np.uint32)
        sel = (x % J) == j
        tv[sel] = col[sel]
    return tv


def _enc_vals(vals: np.ndarray, codec: IntCodec) -> np.ndarray:
    return ((np.asarray(vals, dtype=np.uint64) * codec.delta) % _MOD).astype(
        np.uint32)


# ---------------------------------------------------------------------------
# Client side
# ---------------------------------------------------------------------------

def encrypt_uint(values: Sequence[int], bits: int, sk: G.SecretKey,
                 codec: IntCodec = IntCodec(),
                 rng: Optional[np.random.Generator] = None, *,
                 device="cuda") -> IntCtxt:
    """Encrypt a batch of unsigned integers (client side) onto `device`,
    by default the card, where Context keeps its keys."""
    D = codec.digits_for(bits)
    m = codec.msg_bits
    digs = np.array([[(int(val) >> (m * d)) & (codec.base - 1)
                      for d in range(D)] for val in values],
                    dtype=np.uint32)                        # [B, D]
    mus = _enc_vals(digs, codec).reshape(-1)
    cts = G.tlwe_encrypt_batch(mus, sk.lvl0, sk.params.lvl0.alpha, rng)
    return IntCtxt(from_u32(cts.reshape(len(values), D, -1), device), codec)


def encrypt_int(values: Sequence[int], bits: int, sk: G.SecretKey,
                codec: IntCodec = IntCodec(),
                rng: Optional[np.random.Generator] = None, *,
                device="cuda") -> IntCtxt:
    """Encrypt SIGNED integers as two's complement mod 2^bits. (Python's
    arithmetic right shift makes encrypt_uint's digit extraction already
    produce the two's-complement digits for negative inputs; this alias
    documents the intent and range-checks.)"""
    for v in values:
        if not -(1 << (bits - 1)) <= int(v) < (1 << (bits - 1)):
            raise ValueError(f"{v} out of range for int{bits}")
    return encrypt_uint(values, bits, sk, codec, rng=rng, device=device)


def decrypt_int(x: IntCtxt, sk: G.SecretKey) -> list:
    """Decrypt as SIGNED two's-complement integers."""
    mod = 1 << x.bits
    return [v - mod if v >= mod // 2 else v for v in decrypt_uint(x, sk)]


def digit_phases(x: IntCtxt, sk: G.SecretKey) -> np.ndarray:
    """The phases b - <a, s> mod 2^32 of every digit, [B, D] int64 (one
    transfer to the host; golden.tlwe_phase of each digit)."""
    data = to_u32(x.digits).astype(np.int64)
    n0 = sk.lvl0.shape[0]
    # a < 2^32, s in {0,1}, n0 <= 1024: every partial sum fits int64
    return (data[..., n0] - data[..., :n0] @ sk.lvl0.astype(np.int64)) % _MOD


def decrypt_uint(x: IntCtxt, sk: G.SecretKey) -> list:
    """Decrypt a batch of encrypted integers (client side)."""
    codec = x.codec
    m = codec.msg_bits
    # phases < 2^32 and delta a power of two: the quotient is exact in
    # float64, and np.round rounds half to even as Python's round does
    v = np.round(digit_phases(x, sk) / codec.delta).astype(np.int64)
    v = (v % (1 << (codec.buf_bits + 1))) & (codec.base - 1)
    return [sum(int(d) << (m * i) for i, d in enumerate(row)) for row in v]


# ---------------------------------------------------------------------------
# Server side
# ---------------------------------------------------------------------------

class IntContext:
    """Server-side encrypted-integer evaluator over a gate Context.

    Every method is a few batched pbs_many calls on the context's device:
    the digits of a word share one rotation wherever the JAX package's
    program does, and the carry chain of add/sub is a loop of one rotation
    per digit. Every rotation runs on the context's backend, cut across
    the devices of its mesh if it has one (_pbs); a released key raises
    (Context.release_keys) before the first."""

    def __init__(self, ctx: Context, codec: IntCodec = IntCodec()):
        self.ctx = ctx
        self.codec = codec
        p = ctx.params
        N = p.lvl1.n
        m, b = codec.msg_bits, codec.buf_bits
        vs = np.arange(1 << b)

        def tv(outs):
            return from_u32(build_tv(outs, b, N), ctx.device)

        #: full-adder LUT pair: sum digit + carry from one rotation
        self._tv_add = tv([_enc_vals(vs & (codec.base - 1), codec),
                           _enc_vals(vs >> m, codec)])
        #: "differs" indicator: t = x + comp(y) == 2^m-1 iff x == y
        self._tv_ne = tv([_enc_vals((vs != codec.base - 1).astype(np.uint32),
                                    codec)])
        #: OR of two {0,1} digits (t = u + v in {0,1,2})
        self._tv_or = tv([_enc_vals((vs >= 1).astype(np.uint32), codec)])
        #: bivariate AND of two 1-bit digits (t = u + v == 2)
        self._tv_and2 = tv([_enc_vals((vs >= 2).astype(np.uint32), codec)])
        #: scaled select for msg_bits >= 2: t = 2*digit + flag, flag odd ->
        #: the digit, else 0 (t <= 2*base - 1 < 2^b always fits)
        self._tv_sel = tv([_enc_vals(np.where((vs & 1) == 1, vs >> 1, 0),
                                     codec)])
        #: the select table actually used by _select_digits (m=1 keeps the
        #: unscaled bivariate-AND form: lowest noise)
        self._tv_pick = self._tv_and2 if m == 1 else self._tv_sel
        if m >= 2:
            #: amount-digit -> bits: J=m interleaved LUTs, one rotation
            self._tv_bits = tv([_enc_vals((vs >> j) & 1, codec)
                                for j in range(m)])
            #: one-bit left shift: lo=(2v) mod base, hi=top bit (carry up)
            self._tv_sh1l = tv([_enc_vals((vs << 1) & (codec.base - 1), codec),
                                _enc_vals((vs >> (m - 1)) & 1, codec)])
            #: one-bit right shift: lo=v>>1, hi=low bit moved to the top
            self._tv_sh1r = tv([_enc_vals((vs & (codec.base - 1)) >> 1, codec),
                                _enc_vals((vs & 1) << (m - 1), codec)])
            #: top-bit flip of a clean digit (signed<->unsigned order map)
            self._tv_flip = tv([_enc_vals(
                (vs ^ (codec.base >> 1)) & (codec.base - 1), codec)])
        else:
            self._tv_bits = self._tv_sh1l = self._tv_sh1r = self._tv_sel
        if codec.buf_bits >= 2 * m:
            #: bivariate digit product (t = base*x + y): lo/hi digits of
            #: x*y from one rotation, which needs 2m bits of phase space
            xv, yv = (vs >> m) & (codec.base - 1), vs & (codec.base - 1)
            self._tv_mul = tv([_enc_vals((xv * yv) & (codec.base - 1), codec),
                               _enc_vals((xv * yv) >> m, codec)])
        else:
            self._tv_mul = None

    # -- helpers ---------------------------------------------------------
    @property
    def _n0(self) -> int:
        return self.ctx.params.lvl0.dim

    def _pbs(self, t: torch.Tensor, tv: torch.Tensor, J: int,
             theta: Optional[int] = None) -> torch.Tensor:
        """pbs_many on the context's parameters, backend and keys, through
        its mesh if it has one (the rows cut across the shards, tv read
        whole by each): [J, rows, n0+1]. Raises if the keys were
        released."""
        p, path = self.ctx.params, self.ctx._path
        return self.ctx._map(lambda k, x, v: B.pbs_many(
            x, v, J, k, p, path, theta=theta), [t], (tv,), out_dim=1)

    def _check(self, *xs: IntCtxt):
        for x in xs[1:]:
            if x.codec != xs[0].codec or x.digits.shape != xs[0].digits.shape:
                raise ValueError("operand codec/shape mismatch")
        if xs[0].codec != self.codec:
            raise ValueError("ciphertext codec differs from context codec")
        self._on_device(*xs)

    def _on_device(self, *xs: IntCtxt) -> None:
        for x in xs:
            if x.digits.device != self.ctx.device:
                raise ValueError(f"digits on {x.digits.device}, context on "
                                 f"{self.ctx.device}")

    def _zeros(self, *shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.int32, device=self.ctx.device)

    def _plus(self, x: torch.Tensor, value: int) -> torch.Tensor:
        """x with `value` (mod 2^32) added to every body, out of place."""
        out = x.clone()
        out[..., self._n0] += i32(value)
        return out

    def trivial_uint(self, values: Sequence[int], bits: int) -> IntCtxt:
        """Noiseless server-side constants (trivial ciphertexts)."""
        codec = self.codec
        D = codec.digits_for(bits)
        m = codec.msg_bits
        n0 = self._n0
        digs = np.array([[(int(v) >> (m * d)) & (codec.base - 1)
                          for d in range(D)] for v in values])
        data = np.zeros((len(values), D, n0 + 1), dtype=np.uint32)
        data[:, :, n0] = _enc_vals(digs, codec)
        return IntCtxt(from_u32(data, self.ctx.device), codec)

    def _trivial_digit(self, B_: int, value: int) -> torch.Tensor:
        """A noiseless digit ciphertext [B, n0+1] of `value`."""
        out = self._zeros(B_, self._n0 + 1)
        out[:, self._n0] = i32(value * self.codec.delta)
        return out

    def _comp_digits(self, y: torch.Tensor) -> torch.Tensor:
        """Digitwise (2^m - 1) - v: ciphertext negation + constant, exact
        and noise-preserving (the two's-complement step of sub)."""
        return self._plus(-y, (self.codec.base - 1) * self.codec.delta)

    def _ripple(self, addends: Sequence[torch.Tensor], c0: torch.Tensor):
        """Carry chain over the digit axis of the addends (each [B, W,
        n0+1]): per digit, one rotation of t = sum of the addends' digits +
        carry gives (sum digit, carry). Returns (sums [B, W, n0+1],
        carry-out [B, n0+1])."""
        c, sums = c0, []
        for d in range(addends[0].shape[1]):
            t = c
            for a in addends:
                t = t + a[:, d]
            sc = self._pbs(t, self._tv_add, 2, theta=1)
            sums.append(sc[0])
            c = sc[1]
        return torch.stack(sums, dim=1), c

    # -- add / sub -------------------------------------------------------
    def add_full(self, x: IntCtxt, y: IntCtxt,
                 carry_in: int = 0) -> tuple:
        """Ripple add, one rotation per digit: returns (sum, carry_digit).
        The carry digit is a clean {0,1} digit ciphertext [B, n0+1] (the
        overflow bit; feed to digit_to_bool for the gate domain)."""
        self._check(x, y)
        c0 = self._trivial_digit(x.batch, carry_in)
        sums, cout = self._ripple([x.digits, y.digits], c0)
        return IntCtxt(sums, self.codec), cout

    def add(self, x: IntCtxt, y: IntCtxt) -> IntCtxt:
        """x + y mod 2^bits (wrapping)."""
        return self.add_full(x, y)[0]

    def sub_full(self, x: IntCtxt, y: IntCtxt) -> tuple:
        """x - y via two's complement: (difference, ge_digit) where
        ge_digit is the final carry: a clean {0,1} digit encrypting
        x >= y."""
        self._check(x, y)
        c0 = self._trivial_digit(x.batch, 1)
        sums, cout = self._ripple([x.digits, self._comp_digits(y.digits)],
                                  c0)
        return IntCtxt(sums, self.codec), cout

    def sub(self, x: IntCtxt, y: IntCtxt) -> IntCtxt:
        return self.sub_full(x, y)[0]

    def add_scalar(self, x: IntCtxt, value: int) -> IntCtxt:
        return self.add(x, self.trivial_uint([value] * x.batch, x.bits))

    def sub_scalar(self, x: IntCtxt, value: int) -> IntCtxt:
        return self.sub(x, self.trivial_uint([value] * x.batch, x.bits))

    def neg(self, x: IntCtxt) -> IntCtxt:
        """Two's-complement negation mod 2^bits."""
        return self.sub(self.trivial_uint([0] * x.batch, x.bits), x)

    # -- comparisons -----------------------------------------------------
    def digit_to_bool(self, digit: torch.Tensor) -> Ctxt:
        """{0,1} digit -> gate-domain bool (phase +-mu0): a pure linear
        rescale, p' = 2^(b-1) * p - mu0 (noise x 2^(b-1))."""
        out = self._plus(digit * (1 << (self.codec.buf_bits - 1)),
                         -self.ctx.params.lvl0.mu)
        return Ctxt(out, 0, _ready_event(out))

    def bool_to_digit(self, ct: Ctxt) -> torch.Tensor:
        """Gate-domain bool -> clean {0,1} digit (one bootstrap: sign LUT
        delta/2, then +delta/2), after the work that made `ct`."""
        half = self.codec.delta // 2
        tv = torch.full((self.ctx.params.lvl1.n,), i32(half),
                        dtype=torch.int32, device=self.ctx.device)
        return self._plus(self.ctx.programmable_bootstrap(ct, tv).data, half)

    def ge(self, x: IntCtxt, y: IntCtxt) -> Ctxt:
        """x >= y as a gate-domain bool (cost: one sub)."""
        return self.digit_to_bool(self.sub_full(x, y)[1])

    def lt(self, x: IntCtxt, y: IntCtxt) -> Ctxt:
        out = self.ge(x, y)
        return Ctxt(-out.data, 0, _ready_event(out.data))

    def eq(self, x: IntCtxt, y: IntCtxt) -> Ctxt:
        """x == y as a gate-domain bool: per-digit "differs" indicators
        (one rotation for all digits of the batch) + an OR tree of
        bivariate rotations + a linear NOT."""
        self._check(x, y)
        n0 = self._n0
        Bt, D = x.batch, x.ndigits
        t = (x.digits + self._comp_digits(y.digits)).reshape(Bt * D, n0 + 1)
        ind = self._pbs(t, self._tv_ne, 1,
                        theta=0)[0].reshape(Bt, D, n0 + 1)
        ne = self._or_digits([ind[:, i] for i in range(D)])
        return self.digit_to_bool(self._plus(-ne, self.codec.delta))

    def eq_scalar(self, x: IntCtxt, value: int) -> Ctxt:
        return self.eq(x, self.trivial_uint([value] * x.batch, x.bits))

    # -- select / min / max ----------------------------------------------
    def select(self, cond: Ctxt, x: IntCtxt, y: IntCtxt) -> IntCtxt:
        """cond ? x : y, digitwise: each output digit is
        (s PICK x_d) + (NOT s PICK y_d). The two rotation sets of every
        digit share one pbs_many call and the results sum linearly
        (exactly one term is nonzero). Cost: 2 rotations/digit in one
        launch + 1 launch/word for the cond bridge.

        `cond` is a gate-domain bool (Ctxt, phase +-mu) broadcast over all
        digits of each word."""
        self._check(x, y)
        # a gate bool (phase +-mu0) cannot be rescaled down to digit scale
        # linearly (mu0 = 2^29 is not invertible mod 2^32): one bootstrap
        # bridges cond to a clean {0,1} digit
        sdig = self.bool_to_digit(cond)                   # [B, n0+1]
        out = self._select_digits(sdig, x.digits, y.digits)
        return IntCtxt(out, self.codec)

    # -- signed views (two's complement) -----------------------------------
    def _flip_msb(self, x: IntCtxt) -> IntCtxt:
        """Add 2^(bits-1) mod 2^bits: maps signed order onto unsigned
        order. For msg_bits=1 the top digit's bit flip is the linear digit
        complement (negate + constant). For msg_bits>=2 the top BIT of the
        top digit flips via one LUT rotation per word."""
        if self.codec.msg_bits == 1:
            top = self._comp_digits(x.digits[:, -1:])
        else:
            top = self._pbs(x.digits[:, -1], self._tv_flip, 1,
                            theta=0)[0][:, None, :]
        return IntCtxt(torch.cat([x.digits[:, :-1], top], dim=1), x.codec)

    def ge_signed(self, x: IntCtxt, y: IntCtxt) -> Ctxt:
        """Signed x >= y: flip both MSBs then compare unsigned."""
        return self.ge(self._flip_msb(x), self._flip_msb(y))

    def lt_signed(self, x: IntCtxt, y: IntCtxt) -> Ctxt:
        out = self.ge_signed(x, y)
        return Ctxt(-out.data, 0, _ready_event(out.data))

    def min_signed(self, x: IntCtxt, y: IntCtxt) -> IntCtxt:
        return self.select(self.ge_signed(x, y), y, x)

    def max_signed(self, x: IntCtxt, y: IntCtxt) -> IntCtxt:
        return self.select(self.ge_signed(x, y), x, y)

    def abs_(self, x: IntCtxt) -> IntCtxt:
        """|x| for signed x (two's complement; |-2^(bits-1)| wraps to
        itself as in hardware): one comparison against zero + one neg +
        one select."""
        zero = self.trivial_uint([0] * x.batch, x.bits)
        return self.select(self.ge_signed(x, zero), x, self.neg(x))

    def min_(self, x: IntCtxt, y: IntCtxt) -> IntCtxt:
        """Elementwise minimum: one sub (the comparison) + one select."""
        return self.select(self.ge(x, y), y, x)

    def max_(self, x: IntCtxt, y: IntCtxt) -> IntCtxt:
        """Elementwise maximum: one sub + one select."""
        return self.select(self.ge(x, y), x, y)

    # -- LUTs and structure ----------------------------------------------
    def apply_lut(self, x: IntCtxt, table: Sequence[int]) -> IntCtxt:
        """Digitwise LUT: out_d = table[x_d] (one rotation per digit, all
        digits of the batch in one pbs_many call)."""
        self._check(x)
        codec = self.codec
        if len(table) != codec.base:
            raise ValueError(f"a digit LUT has {codec.base} entries, got "
                             f"{len(table)}")
        p = self.ctx.params
        n0 = self._n0
        vs = np.arange(1 << codec.buf_bits)
        outs = _enc_vals(np.asarray(table, dtype=np.uint64)[
            vs % codec.base], codec)
        tv = from_u32(build_tv([outs], codec.buf_bits, p.lvl1.n),
                      self.ctx.device)
        Bt, D = x.batch, x.ndigits
        flat = x.digits.reshape(Bt * D, n0 + 1)
        out = self._pbs(flat, tv, 1, theta=0)[0]
        return IntCtxt(out.reshape(Bt, D, n0 + 1), codec)

    def shift_digits(self, x: IntCtxt, by: int) -> IntCtxt:
        """Shift by whole digits (left = towards high digits); vacated
        digits are trivial zeros. Free (no bootstraps)."""
        return IntCtxt(self._digit_shift(x.digits, by), x.codec)

    def _select_digits(self, g, a, b_):
        """Digitwise g ? a : b_ where g is a CLEAN {0,1} digit [B, n0+1]
        and a/b_ are [B, W, n0+1]. Both rotation sets share one pbs_many
        call; the results sum linearly (exactly one term per digit is
        nonzero).

        msg_bits=1 uses the bivariate-AND form t = digit + flag (lowest
        noise: both fresh); msg_bits>=2 uses the scaled form
        t = 2*digit + flag with the odd-selector LUT (t < 2^b always)."""
        n0 = self._n0
        Bt, W = a.shape[0], a.shape[1]
        ns = self._plus(-g, self.codec.delta)
        if self.codec.msg_bits == 1:
            t1 = (a + g[:, None, :]).reshape(Bt * W, n0 + 1)
            t0 = (b_ + ns[:, None, :]).reshape(Bt * W, n0 + 1)
        else:
            t1 = (a * 2 + g[:, None, :]).reshape(Bt * W, n0 + 1)
            t0 = (b_ * 2 + ns[:, None, :]).reshape(Bt * W, n0 + 1)
        r = self._pbs(torch.cat([t1, t0]), self._tv_pick, 1,
                      theta=0)[0]
        return (r[:Bt * W] + r[Bt * W:]).reshape(Bt, W, n0 + 1)

    def _or_digits(self, cols: List[torch.Tensor]) -> torch.Tensor:
        """OR tree over clean {0,1} digit ciphertexts [B, n0+1]: each
        round batches every pair's t = u + v rotation into one pbs_many
        call."""
        n0 = self._n0
        cols = list(cols)
        while len(cols) > 1:
            nxt, pairs = [], []
            for i in range(0, len(cols) - 1, 2):
                pairs.append(cols[i] + cols[i + 1])
            if len(cols) % 2:
                nxt.append(cols[-1])
            ors = self._pbs(torch.cat(pairs), self._tv_or, 1,
                            theta=0)[0]
            cols = list(ors.reshape(len(pairs), cols[0].shape[0],
                                    n0 + 1).unbind(0)) + nxt
        return cols[0]

    # -- mul ---------------------------------------------------------------
    def _mul_rows(self, xd, yd) -> torch.Tensor:
        """Schoolbook product for msg_bits=1: per row r, one rotation of
        the bivariate AND of every x digit with y_r, placed at digit r of a
        2D-digit zero register and rippled into the accumulator."""
        n0 = self._n0
        Bt, D = xd.shape[0], xd.shape[1]
        acc = self._zeros(Bt, 2 * D, n0 + 1)
        c0 = self._zeros(Bt, n0 + 1)
        for r in range(D):
            t = (xd + yd[:, r][:, None, :]).reshape(Bt * D, n0 + 1)
            row = self._pbs(t, self._tv_and2, 1, theta=0)[0]
            shifted = self._zeros(Bt, 2 * D, n0 + 1)
            shifted[:, r:r + D] = row.reshape(Bt, D, n0 + 1)
            acc = self._ripple([acc, shifted], c0)[0]
        return acc

    def _mul_rows_multi(self, xd, yd) -> torch.Tensor:
        """Schoolbook product for msg_bits >= 2 (needs buf_bits >= 2m):
        each partial-product row is a bivariate LUT t = base*x_d + y_r
        whose ONE rotation yields both the lo and hi digits of x_d * y_r;
        lo and the digit-shifted hi accumulate through a two-addend ripple
        (t = acc + lo + hi + c < 3*base + carry <= 2^b)."""
        n0 = self._n0
        Bt, D = xd.shape[0], xd.shape[1]
        acc = self._zeros(Bt, 2 * D, n0 + 1)
        c0 = self._zeros(Bt, n0 + 1)
        for r in range(D):
            t = (xd * self.codec.base
                 + yd[:, r][:, None, :]).reshape(Bt * D, n0 + 1)
            lo, hi = self._pbs(t, self._tv_mul, 2, theta=1)
            lo_sh = self._zeros(Bt, 2 * D, n0 + 1)
            hi_sh = self._zeros(Bt, 2 * D, n0 + 1)
            lo_sh[:, r:r + D] = lo.reshape(Bt, D, n0 + 1)
            hi_sh[:, r + 1:r + 1 + D] = hi.reshape(Bt, D, n0 + 1)
            acc = self._ripple([acc, lo_sh, hi_sh], c0)[0]
        return acc

    def mul(self, x: IntCtxt, y: IntCtxt) -> IntCtxt:
        """Schoolbook product (full 2*bits width): partial-product rows as
        bivariate rotations, accumulated with ripple adds, D(2D+1)
        rotations at msg_bits=1. msg_bits>=2 needs a codec with
        buf_bits >= 2*msg_bits (phase space for the bivariate digit
        product), e.g. IntCodec(msg_bits=2, buf_bits=4)."""
        self._check(x, y)
        if self.codec.msg_bits == 1:
            acc = self._mul_rows(x.digits, y.digits)
        else:
            if self._tv_mul is None:
                raise ValueError(
                    f"mul at msg_bits={self.codec.msg_bits} needs "
                    f"buf_bits >= {2 * self.codec.msg_bits} (bivariate "
                    f"digit-product phase space); use e.g. IntCodec("
                    f"msg_bits={self.codec.msg_bits}, "
                    f"buf_bits={2 * self.codec.msg_bits})")
            acc = self._mul_rows_multi(x.digits, y.digits)
        return IntCtxt(acc, self.codec)

    # -- divmod --------------------------------------------------------------
    def _div_steps(self, r, xd, yd):
        """Restoring division for msg_bits=1 over the dividend digits xd
        (high digit first): per quotient bit, one (D+1)-digit trial
        subtraction and one digitwise select. r is the W=D+1 digit
        remainder register; returns (quotient digits, r)."""
        # divisor zero-extended to W digits, complemented once for the
        # two's-complement trial subtraction of every step
        zero = self._zeros(xd.shape[0], 1, self._n0 + 1)
        cyW = self._comp_digits(torch.cat([yd, zero], dim=1))
        c0 = self._trivial_digit(xd.shape[0], 1)
        qbits = []
        for i in reversed(range(xd.shape[1])):
            # r2 = 2r + next dividend bit; the dropped top digit is always
            # an encryption of 0 (the loop invariant keeps r < 2^D)
            r2 = torch.cat([xd[:, i][:, None], r[:, :-1]], dim=1)
            diff, ge = self._ripple([r2, cyW], c0)
            r = self._select_digits(ge, diff, r2)
            qbits.append(ge)
        return torch.stack(qbits[::-1], dim=1), r

    def _div_steps_multi(self, r, xd, yd):
        """Restoring division with radix-2^m quotient DIGITS: per step,
        the base-1 multiples j*y (exact ripple adds, once per call) are
        trial-subtracted from the shifted remainder in one batched
        ripple; the quotient digit is the LINEAR sum of the monotone ge_j
        flags, and the next remainder is a one-hot select over the base
        candidates (e_j = ge_j - ge_{j+1} is an exact linear {0,1}
        combination)."""
        n0 = self._n0
        base = self.codec.base
        Bt, D = yd.shape[0], yd.shape[1]
        W = D + 1
        yW = torch.cat([yd, self._zeros(Bt, 1, n0 + 1)], dim=1)
        mults = [yW]
        c0 = self._zeros(Bt, n0 + 1)
        for _ in range(2, base):                   # j*y, exact W-digit adds
            mults.append(self._ripple([mults[-1], yW], c0)[0])
        comp_flat = torch.stack([self._comp_digits(mj) for mj in mults]
                                ).reshape((base - 1) * Bt, W, n0 + 1)
        one = self._trivial_digit(Bt, 1)
        c1 = self._trivial_digit((base - 1) * Bt, 1)
        qds = []
        for i in reversed(range(xd.shape[1])):
            r2 = torch.cat([xd[:, i][:, None], r[:, :D]], dim=1)
            r2t = r2[None].expand(base - 1, Bt, W, n0 + 1).reshape(
                (base - 1) * Bt, W, n0 + 1)
            diffs, ges = self._ripple([r2t, comp_flat], c1)
            diffs = diffs.reshape(base - 1, Bt, W, n0 + 1)
            ges = ges.reshape(base - 1, Bt, n0 + 1)
            # linear, value in [0, base); the int32 sum wraps mod 2^32
            qds.append(ges.sum(dim=0, dtype=torch.int32))
            e = ([one - ges[0]]
                 + [ges[j] - ges[j + 1] for j in range(base - 2)]
                 + [ges[base - 2]])
            cands = torch.cat([r2[None], diffs], dim=0)
            es = torch.stack(e)                    # [base, Bt, n0+1]
            t = (cands * 2 + es[:, :, None, :]).reshape(base * Bt * W,
                                                        n0 + 1)
            terms = self._pbs(t, self._tv_sel, 1, theta=0)[0]
            r = terms.reshape(base, Bt, W, n0 + 1).sum(dim=0,
                                                       dtype=torch.int32)
        return torch.stack(qds[::-1], dim=1), r

    def divmod_(self, x: IntCtxt, y: IntCtxt, *,
                segment: int | None = None) -> tuple:
        """Restoring division: returns (x // y, x % y).
        msg_bits=1: per quotient bit, one (D+1)-digit trial subtraction +
        one digitwise select, D(D+2) rotations in all. msg_bits>=2: radix-
        2^m quotient digits via base-1 batched trial subtractions + a
        one-hot select (_div_steps_multi). Division by an encrypted zero
        follows the restoring-hardware convention: quotient = 2^bits - 1,
        remainder = x.

        `segment` (or env CUFHE_DIV_SEG; 0/None = the whole divide at
        once) cuts the quotient digits into calls of at most `segment`
        digits, the remainder register carried between them: bit-exact
        to the unsegmented divide (the JAX package's per-dispatch cap)."""
        self._check(x, y)
        D = x.ndigits
        seg = segment if segment is not None else \
            int(os.environ.get("CUFHE_DIV_SEG", "0"))
        seg = seg or D
        steps = (self._div_steps if self.codec.msg_bits == 1
                 else self._div_steps_multi)
        r = self._zeros(x.batch, D + 1, self._n0 + 1)
        qparts = []
        hi = D
        while hi > 0:
            lo = max(0, hi - seg)
            qc, r = steps(r, x.digits[:, lo:hi], y.digits)
            qparts.append(qc)                  # top chunk first
            hi = lo
        q = torch.cat(qparts[::-1], dim=1)
        return IntCtxt(q, self.codec), IntCtxt(r[:, :D], self.codec)

    def div(self, x: IntCtxt, y: IntCtxt) -> IntCtxt:
        return self.divmod_(x, y)[0]

    def mod(self, x: IntCtxt, y: IntCtxt) -> IntCtxt:
        return self.divmod_(x, y)[1]

    # -- shifts ------------------------------------------------------------
    def _digit_shift(self, cur: torch.Tensor, k: int) -> torch.Tensor:
        """Shift by k whole digits (left = towards high digits); vacated
        digits are trivial zeros."""
        Bt, D = cur.shape[0], cur.shape[1]
        if abs(k) >= D:
            return torch.zeros_like(cur)
        pad = self._zeros(Bt, abs(k), self._n0 + 1)
        if k > 0:
            return torch.cat([pad, cur[:, :D - k]], dim=1)
        if k < 0:
            return torch.cat([cur[:, -k:], pad], dim=1)
        return cur

    def _shift1(self, cur, sign: int, tv_sh1):
        """One-BIT shift within radix-2^m digits (msg_bits >= 2): ONE
        rotation per digit produces (lo, carry) LUT pairs; the result is
        the linear sum lo_d + carry-from-neighbour, clean since the carry
        fills exactly the bit position the shift vacated."""
        n0 = self._n0
        Bt, D = cur.shape[0], cur.shape[1]
        lo, hi = self._pbs(cur.reshape(Bt * D, n0 + 1), tv_sh1, 2,
                           theta=1)
        lo = lo.reshape(Bt, D, n0 + 1)
        hi = hi.reshape(Bt, D, n0 + 1)
        zero = self._zeros(Bt, 1, n0 + 1)
        if sign > 0:   # left: result_d = lo_d + topbit(x_{d-1})
            hi_sh = torch.cat([zero, hi[:, :-1]], dim=1)
        else:          # right: result_d = lo_d + lowbit(x_{d+1}) << (m-1)
            hi_sh = torch.cat([hi[:, 1:], zero], dim=1)
        return lo + hi_sh

    def _shift_by(self, x: IntCtxt, amount: IntCtxt, sign: int) -> IntCtxt:
        """Barrel shifter over the amount's BITS. Amount bits with
        2^i >= total bits can only saturate the result to zero: they
        collapse into one OR tree + one final select against zeros.
        msg_bits>=2 extracts the m bits of each amount digit with one J=m
        rotation, and odd stage widths pay sub-digit 1-bit shifts
        (_shift1)."""
        if x.codec != self.codec or amount.codec != self.codec:
            raise ValueError("ciphertext codec differs from context codec")
        if amount.batch != x.batch:
            raise ValueError("shift amount batch differs from operand batch")
        self._on_device(x, amount)
        n0 = self._n0
        m = self.codec.msg_bits
        Bt, D, S = x.batch, x.ndigits, amount.ndigits
        total_bits = D * m
        tv_sh1 = self._tv_sh1l if sign > 0 else self._tv_sh1r
        ad = amount.digits
        if m == 1:
            bits = [ad[:, i] for i in range(S)]
        else:
            # the JAX package's default theta for J = m outputs
            outs = self._pbs(ad.reshape(Bt * S, n0 + 1), self._tv_bits,
                             m).reshape(m, Bt, S, n0 + 1)
            bits = [outs[j, :, i]                  # bit i*m+j, little-endian
                    for i in range(S) for j in range(m)]
        cur = x.digits
        sat_bits = []
        for i, bit in enumerate(bits):
            if (1 << i) >= total_bits:
                sat_bits.append(bit)
                continue
            q, r = divmod(1 << i, m)
            shifted = self._digit_shift(cur, sign * q)
            for _ in range(r):                     # r < m sub-digit steps
                shifted = self._shift1(shifted, sign, tv_sh1)
            cur = self._select_digits(bit, shifted, cur)
        if sat_bits:
            sat = self._or_digits(sat_bits)
            cur = self._select_digits(sat, torch.zeros_like(cur), cur)
        return IntCtxt(cur, self.codec)

    def shift_left(self, x: IntCtxt, amount: IntCtxt) -> IntCtxt:
        """x << amount with an ENCRYPTED shift amount: a barrel shifter of
        amount.ndigits stages (stage i selects between x and the static
        2^i-bit shift under bit i of the amount), 2*D rotations per stage
        in one launch. Amounts >= bits yield 0 (bits shifted past the top
        are dropped, vacated digits are trivial zeros)."""
        return self._shift_by(x, amount, +1)

    def shift_right(self, x: IntCtxt, amount: IntCtxt) -> IntCtxt:
        """Logical x >> amount with an ENCRYPTED amount (see shift_left)."""
        return self._shift_by(x, amount, -1)
