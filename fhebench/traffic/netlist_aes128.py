"""The AES-128 encryption netlist, as Bristol Fashion text: the traffic of
the `aes128_*` mixes.

A frozen copy of the generator that the program ships
(cufhe_tpu_torch/runtime/netlists.py, `aes128_bristol`), kept here so that
the circuit a cell evaluates cannot change with the program. Inputs are
the plaintext (128 bits) then the key (128 bits), output the ciphertext
(128 bits); bytes in FIPS-197 order, bits LSB first within each byte.
Every gate is XOR, AND, INV or EQW: INV and EQW cost no bootstrap, XOR and
AND one each. The S-box is the tower-field GF((2^4)^2) inverter; its
tables are derived numerically here, and fhebench/tests check the whole
circuit against FIPS-197.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Sequence, Tuple

GF16_POLY = 0x13


def _clmul_mod(a: int, b: int, poly: int, nbits: int) -> int:
    r = 0
    while b:
        if b & 1:
            r ^= a
        b >>= 1
        a <<= 1
        if a >> nbits:
            a ^= poly
    return r


def g16_mul(a: int, b: int) -> int:
    return _clmul_mod(a, b, GF16_POLY, 4)


@functools.lru_cache(None)
def g16_inv_table() -> Tuple[int, ...]:
    inv = [0] * 16
    for x in range(1, 16):
        for y in range(1, 16):
            if g16_mul(x, y) == 1:
                inv[x] = y
    return tuple(inv)


# Tower field GF((2^4)^2) = GF(16)[z]/(z^2 + z + LAMBDA)
# Element u (8-bit): a = u >> 4 (z coefficient), b = u & 15.
# ---------------------------------------------------------------------------

@functools.lru_cache(None)
def _lambda() -> int:
    squares_plus = {g16_mul(b, b) ^ b for b in range(16)}
    for lam in range(1, 16):
        if lam not in squares_plus:     # z^2 + z + lam irreducible
            return lam
    raise AssertionError


def t_mul(u: int, v: int) -> int:
    lam = _lambda()
    a1, b1, a2, b2 = u >> 4, u & 15, v >> 4, v & 15
    aa = g16_mul(a1, a2)
    hi = g16_mul(a1, b2) ^ g16_mul(a2, b1) ^ aa
    lo = g16_mul(b1, b2) ^ g16_mul(aa, lam)
    return (hi << 4) | lo


def _t_pow(u: int, e: int) -> int:
    r = 1
    for _ in range(e):
        r = t_mul(r, u)
    return r


@functools.lru_cache(None)
def _iso_matrices() -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(M, Minv) as column tuples: M maps GF(2^8) poly-basis bit-vectors to
    tower bit-vectors via delta(x^i) = beta^i, beta a tower-field root of
    the AES polynomial. Columns are 8-bit ints."""
    beta = None
    for u in range(2, 256):
        if (_t_pow(u, 8) ^ _t_pow(u, 4) ^ _t_pow(u, 3) ^ u ^ 1) == 0:
            beta = u
            break
    assert beta is not None
    cols = tuple(_t_pow(beta, i) for i in range(8))
    # invert over GF(2)
    mat = [list((c >> r) & 1 for c in cols) for r in range(8)]  # rows
    aug = [mat[r] + [1 if r == c else 0 for c in range(8)]
           for r in range(8)]
    for c in range(8):
        piv = next(r for r in range(c, 8) if aug[r][c])
        aug[c], aug[piv] = aug[piv], aug[c]
        for r in range(8):
            if r != c and aug[r][c]:
                aug[r] = [x ^ y for x, y in zip(aug[r], aug[c])]
    inv_cols = tuple(sum(aug[r][8 + c] << r for r in range(8))
                     for c in range(8))
    return cols, inv_cols


def _apply_cols(cols: Sequence[int], v: int) -> int:
    r = 0
    for i, c in enumerate(cols):
        if (v >> i) & 1:
            r ^= c
    return r


# ---------------------------------------------------------------------------
# Bristol Fashion writer
# ---------------------------------------------------------------------------

class BristolWriter:
    """Emits a Bristol Fashion netlist; one output wire per gate, outputs
    copied (EQW) to the tail wire range as the format requires."""

    def __init__(self):
        self._n_inputs = 0
        self._in_widths: List[int] = []
        self._lines: List[str] = []
        self._next = 0

    def inputs(self, width: int) -> List[int]:
        assert not self._lines, "declare inputs before gates"
        ws = list(range(self._next, self._next + width))
        self._next += width
        self._n_inputs += width
        self._in_widths.append(width)
        return ws

    def gate(self, op: str, *ins: int) -> int:
        out = self._next
        self._next += 1
        self._lines.append(
            f"{len(ins)} 1 {' '.join(str(w) for w in ins)} {out} {op}")
        return out

    def xor(self, a: int, b: int) -> int:
        return self.gate("XOR", a, b)

    def and_(self, a: int, b: int) -> int:
        return self.gate("AND", a, b)

    def inv(self, a: int) -> int:
        return self.gate("INV", a)

    def xor_many(self, ws: Sequence[int]) -> int:
        assert ws
        ws = list(ws)
        while len(ws) > 1:           # balanced tree (minimizes level depth)
            nxt = [self.xor(ws[i], ws[i + 1])
                   for i in range(0, len(ws) - 1, 2)]
            if len(ws) % 2:
                nxt.append(ws[-1])
            ws = nxt
        return ws[0]

    def finalize(self, outputs: Sequence[int]) -> str:
        outs = [self.gate("EQW", w) for w in outputs]  # tail-position copies
        n_gates = len(self._lines)
        n_wires = self._next
        assert outs == list(range(n_wires - len(outs), n_wires))
        header = [
            f"{n_gates} {n_wires}",
            f"{len(self._in_widths)} "
            + " ".join(str(w) for w in self._in_widths),
            f"1 {len(outs)}",
        ]
        return "\n".join(header + self._lines) + "\n"


# ---------------------------------------------------------------------------
# Circuit building blocks (bytes = 8 wires, LSB first)
# ---------------------------------------------------------------------------

def _linear_map(w: BristolWriter, cols: Sequence[int],
                bits: Sequence[int]) -> List[int]:
    """y = M x over GF(2); cols[i] = i-th column of M as a packed int."""
    n_out = max(c.bit_length() for c in cols)
    out = []
    for r in range(n_out):
        terms = [bits[i] for i, c in enumerate(cols) if (c >> r) & 1]
        out.append(w.xor_many(terms))
    return out


def _mul16_circuit(w: BristolWriter, xb: Sequence[int],
                   yb: Sequence[int]) -> List[int]:
    """GF(16) product: 16 shared ANDs + per-bit XOR trees (bilinear form
    of g16_mul on the basis products)."""
    prods = {(i, j): w.and_(xb[i], yb[j]) for i in range(4) for j in range(4)}
    out = []
    for r in range(4):
        terms = [prods[i, j] for i in range(4) for j in range(4)
                 if (g16_mul(1 << i, 1 << j) >> r) & 1]
        out.append(w.xor_many(terms))
    return out


@functools.lru_cache(None)
def _inv16_anf() -> Tuple[Tuple[int, ...], ...]:
    """ANF (Möbius transform) of each output bit of the GF(16) inverter:
    anf[r] = tuple of monomial masks (nonzero) whose XOR gives bit r."""
    table = g16_inv_table()
    anfs = []
    for r in range(4):
        f = [(table[x] >> r) & 1 for x in range(16)]
        for i in range(4):                      # Möbius transform
            for x in range(16):
                if (x >> i) & 1:
                    f[x] ^= f[x ^ (1 << i)]
        anfs.append(tuple(m for m in range(16) if f[m] and m))
        assert f[0] == 0                        # inv(0)=0: no constant term
    return tuple(anfs)


def _inv16_circuit(w: BristolWriter, xb: Sequence[int]) -> List[int]:
    """GF(16) inversion from its ANF with a shared monomial pool."""
    needed = sorted({m for anf in _inv16_anf() for m in anf
                     if bin(m).count("1") >= 2})
    mono: Dict[int, int] = {1 << i: xb[i] for i in range(4)}
    for m in needed:                            # ascending => submask ready
        low = m & -m
        rest = m ^ low
        mono[m] = w.and_(mono[rest], mono[low])
    return [w.xor_many([mono[m] for m in anf]) for anf in _inv16_anf()]


def sbox_circuit(w: BristolWriter, byte: Sequence[int]) -> List[int]:
    """AES S-box on 8 wires via the tower-field inverter."""
    M, Minv = _iso_matrices()
    lam = _lambda()
    t = _linear_map(w, M, byte)                 # tower basis
    b, a = t[:4], t[4:]
    ab = [w.xor(a[i], b[i]) for i in range(4)]
    # sq_lam: v -> lam * v^2 (linear)
    sq_lam_cols = tuple(g16_mul(lam, g16_mul(1 << j, 1 << j))
                        for j in range(4))
    sa = _linear_map(w, sq_lam_cols, a)
    m1 = _mul16_circuit(w, b, ab)
    n = [w.xor(sa[i], m1[i]) for i in range(4)]  # norm = lam a^2 + b(a+b)
    d = _inv16_circuit(w, n)
    oh = _mul16_circuit(w, a, d)                 # inverse z-part
    ol = _mul16_circuit(w, ab, d)                # inverse 1-part
    inv_bits = ol + oh
    # output affine: rows of A (FIPS-197) composed with Minv, then +0x63
    aff_cols = []
    for j in range(8):
        col = 0
        for i in range(8):
            col |= (((j == i) ^ (j == (i + 4) % 8) ^ (j == (i + 5) % 8)
                     ^ (j == (i + 6) % 8) ^ (j == (i + 7) % 8)) & 1) << i
        aff_cols.append(col)
    comb_cols = tuple(_apply_cols(aff_cols, c) for c in Minv)
    out = _linear_map(w, comb_cols, inv_bits)
    return [w.inv(out[i]) if (0x63 >> i) & 1 else out[i] for i in range(8)]


def _xor_bytes(w: BristolWriter, x: Sequence[int],
               y: Sequence[int]) -> List[int]:
    return [w.xor(a, b) for a, b in zip(x, y)]


def _xtime(w: BristolWriter, b: Sequence[int]) -> List[int]:
    """Multiply a byte by x (0x02): shift + conditional 0x1B reduction —
    purely linear at the bit level (wiring + 4 XORs with b7)."""
    t = b[7]
    out = [t, w.xor(b[0], t), b[1], w.xor(b[2], t), w.xor(b[3], t),
           b[4], b[5], b[6]]
    return out


def _mix_column(w: BristolWriter, col: Sequence[Sequence[int]]
                ) -> List[List[int]]:
    """MixColumns on one 4-byte column (FIPS-197 §5.1.3):
    s'_r = 2 s_r + 3 s_{r+1} + s_{r+2} + s_{r+3}."""
    out = []
    for r in range(4):
        s0, s1, s2, s3 = (col[(r + i) % 4] for i in range(4))
        two_s0 = _xtime(w, s0)
        two_s1 = _xtime(w, s1)
        three_s1 = _xor_bytes(w, two_s1, s1)
        acc = _xor_bytes(w, two_s0, three_s1)
        acc = _xor_bytes(w, acc, s2)
        acc = _xor_bytes(w, acc, s3)
        out.append(acc)
    return out


RCON = (0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36)
def bristol() -> str:
    """Generate the full AES-128 encryption netlist (Bristol Fashion).

    Inputs: plaintext (128 bits) then key (128 bits); bytes in FIPS order,
    LSB-first within each byte. Output: ciphertext (128 bits)."""
    w = BristolWriter()
    pt = w.inputs(128)
    kb = w.inputs(128)
    state = [pt[8 * i:8 * (i + 1)] for i in range(16)]   # byte i = r + 4c
    words = [[kb[8 * (4 * i + j):8 * (4 * i + j) + 8] for j in range(4)]
             for i in range(4)]                          # w[i] = 4 bytes

    def ark(state, words4):
        # round-key byte (r, c) = byte r of word c
        out = [None] * 16
        for c in range(4):
            for r in range(4):
                out[r + 4 * c] = _xor_bytes(w, state[r + 4 * c],
                                            words4[c][r])
        return out

    def next_words(prev4, rcon):
        rot = [prev4[3][(j + 1) % 4] for j in range(4)]  # RotWord
        sub = [sbox_circuit(w, bte) for bte in rot]       # SubWord
        # rcon on byte 0: XOR-with-constant = INV on set bits
        sub0 = [w.inv(sub[0][i]) if (rcon >> i) & 1 else sub[0][i]
                for i in range(8)]
        sub = [sub0] + sub[1:]
        w0 = [_xor_bytes(w, prev4[0][j], sub[j]) for j in range(4)]
        ws = [w0]
        for i in range(1, 4):
            ws.append([_xor_bytes(w, prev4[i][j], ws[i - 1][j])
                       for j in range(4)])
        return ws

    state = ark(state, words)
    for rnd in range(10):
        state = [sbox_circuit(w, b) for b in state]               # SubBytes
        state = [state[r + 4 * ((c + r) % 4)]
                 for c in range(4) for r in range(4)]             # ShiftRows
        if rnd < 9:                                               # MixColumns
            mixed = []
            for c in range(4):
                mixed.extend(_mix_column(w, state[4 * c:4 * c + 4]))
            state = mixed
        words = next_words(words, RCON[rnd])
        state = ark(state, words)

    return w.finalize([bit for byte in state for bit in byte])


# ---------------------------------------------------------------------------
# Plaintext AES reference (verification oracle for the netlist)
# ---------------------------------------------------------------------------
