"""Plain AES-128 (FIPS-197): the reference for the Bristol AES-128 cell.

Written from the standard, independent of the netlist generator and of
the program under test. `outputs` maps the circuit's input bits to the
bits the circuit must give, in the netlist's bit order: inputs are the
plaintext then the key, outputs the ciphertext, bytes in FIPS order and
bits LSB first within each byte.
"""
from __future__ import annotations

import functools

import numpy as np

RCON = (0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36)


def gf_mul(a: int, b: int) -> int:
    """Product in GF(2^8) modulo x^8 + x^4 + x^3 + x + 1."""
    r = 0
    while b:
        if b & 1:
            r ^= a
        b >>= 1
        a <<= 1
        if a & 0x100:
            a ^= 0x11B
    return r


@functools.lru_cache(None)
def sbox() -> tuple:
    """S(x) = A x^-1 + 0x63 (FIPS-197 section 5.1.1)."""
    inv = [0] * 256
    for x in range(1, 256):
        inv[x] = next(y for y in range(1, 256) if gf_mul(x, y) == 1)
    out = []
    for x in range(256):
        w, s = inv[x], 0
        for i in range(8):
            bit = ((w >> i) ^ (w >> ((i + 4) % 8)) ^ (w >> ((i + 5) % 8))
                   ^ (w >> ((i + 6) % 8)) ^ (w >> ((i + 7) % 8))
                   ^ (0x63 >> i)) & 1
            s |= bit << i
        out.append(s)
    return tuple(out)


def encrypt_block(pt: bytes, key: bytes) -> bytes:
    """One AES-128 block; state byte r + 4c is row r, column c."""
    S = sbox()
    state = list(pt)
    words = [list(key[4 * i:4 * i + 4]) for i in range(4)]

    def add_round_key(s, ws):
        return [s[r + 4 * c] ^ ws[c][r] for c in range(4) for r in range(4)]

    state = add_round_key(state, words)
    for rnd in range(10):
        state = [S[b] for b in state]
        state = [state[r + 4 * ((c + r) % 4)]
                 for c in range(4) for r in range(4)]
        if rnd < 9:
            mixed = []
            for c in range(4):
                col = state[4 * c:4 * c + 4]
                for r in range(4):
                    s0, s1, s2, s3 = (col[(r + i) % 4] for i in range(4))
                    mixed.append(gf_mul(s0, 2) ^ gf_mul(s1, 3) ^ s2 ^ s3)
            state = mixed
        sub = [S[words[3][(j + 1) % 4]] for j in range(4)]
        sub[0] ^= RCON[rnd]
        ws = [[words[0][j] ^ sub[j] for j in range(4)]]
        for i in range(1, 4):
            ws.append([words[i][j] ^ ws[i - 1][j] for j in range(4)])
        words = ws
        state = add_round_key(state, words)
    return bytes(state)


def _bytes(bits: np.ndarray) -> bytes:
    return bytes(int(sum(int(bits[8 * i + j]) << j for j in range(8)))
                 for i in range(len(bits) // 8))


def outputs(bristol: str, inputs: np.ndarray) -> np.ndarray:
    """Ciphertext bits [B, 128] of input bits [B, 256] (plaintext, key).
    The netlist text is not read: the standard is the reference."""
    del bristol
    out = []
    for row in np.asarray(inputs):
        ct = encrypt_block(_bytes(row[:128]), _bytes(row[128:]))
        out.append([(b >> i) & 1 for b in ct for i in range(8)])
    return np.array(out, dtype=np.int64)
