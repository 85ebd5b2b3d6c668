"""Standard-netlist generators (Bristol Fashion): AES-128 and SHA-256.

The reference's raison d'être is circuit evaluation for the Virtual Secure
Platform (reference README.md:2-7) but it ships no netlist tooling; here
the two canonical MPC/FHE benchmark circuits — a full AES-128 encryption
block and a one-block SHA-256 digest — are generated as Bristol Fashion
text, loaded through the importer, scheduled by the native C++ core, and
executed batched on the card (cufhe_tpu_torch.benchmarks.aes and .sha256).

A copy of cufhe_tpu/runtime/netlists.py (the port imports nothing of the
JAX package); tests/test_torch_runtime.py holds the generated netlists and
the plaintext references equal to the original's.

The S-box is synthesized via the canonical tower-field decomposition
GF(2^8) -> GF((2^4)^2) (the construction behind compact hardware S-boxes):
all field tables, the basis-change matrices, and the GF(16) inverter's ANF
are derived numerically at generation time, so the construction is
self-verifying against the table S-box (tests/test_aes.py checks the
generated circuit against FIPS-197 vectors bit-for-bit).

Every gate is XOR/AND/INV/EQW — INV costs nothing encrypted (pure
negation), XOR/AND are one bootstrap each (~6,360 AND + ~25,000 XOR).
"""
from __future__ import annotations

import functools
from typing import Dict, List, Sequence, Tuple

# ---------------------------------------------------------------------------
# GF(2^8) / GF(2^4) numeric helpers (generation-time only)
# ---------------------------------------------------------------------------

AES_POLY = 0x11B
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


def g8_mul(a: int, b: int) -> int:
    return _clmul_mod(a, b, AES_POLY, 8)


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


@functools.lru_cache(None)
def aes_sbox_table() -> Tuple[int, ...]:
    """S(x) = Aff(x^-1) over GF(2^8) — the spec definition (FIPS-197 §5.1.1),
    independent of the tower-field circuit it verifies."""
    inv = [0] * 256
    for x in range(1, 256):
        for y in range(1, 256):
            if g8_mul(x, y) == 1:
                inv[x] = y
                break
    out = []
    for x in range(256):
        w = inv[x]
        s = 0
        for i in range(8):
            bit = ((w >> i) ^ (w >> ((i + 4) % 8)) ^ (w >> ((i + 5) % 8))
                   ^ (w >> ((i + 6) % 8)) ^ (w >> ((i + 7) % 8))
                   ^ (0x63 >> i)) & 1
            s |= bit << i
        out.append(s)
    return tuple(out)


# ---------------------------------------------------------------------------
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


def aes128_bristol() -> str:
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

def aes128_encrypt_block(pt: bytes, key: bytes) -> bytes:
    """Table-based AES-128 (FIPS-197), for verifying the generated circuit."""
    sbox = aes_sbox_table()
    state = list(pt)
    words = [list(key[4 * i:4 * i + 4]) for i in range(4)]

    def ark(s, ws):
        return [s[r + 4 * c] ^ ws[c][r] for c in range(4) for r in range(4)]

    state = ark(state, words)
    for rnd in range(10):
        state = [sbox[b] for b in state]
        state = [state[r + 4 * ((c + r) % 4)]
                 for c in range(4) for r in range(4)]
        if rnd < 9:
            mixed = []
            for c in range(4):
                col = state[4 * c:4 * c + 4]
                for r in range(4):
                    s0, s1, s2, s3 = (col[(r + i) % 4] for i in range(4))
                    mixed.append(g8_mul(s0, 2) ^ g8_mul(s1, 3) ^ s2 ^ s3)
            state = mixed
        rot = [words[3][(j + 1) % 4] for j in range(4)]
        sub = [sbox[b] for b in rot]
        sub[0] ^= RCON[rnd]
        w0 = [words[0][j] ^ sub[j] for j in range(4)]
        ws = [w0]
        for i in range(1, 4):
            ws.append([words[i][j] ^ ws[i - 1][j] for j in range(4)])
        words = ws
        state = ark(state, words)
    return bytes(state)


def bits_of(data: bytes) -> List[int]:
    """Byte string -> bit list (byte order preserved, LSB-first per byte)."""
    return [(b >> i) & 1 for b in data for i in range(8)]


def bytes_of(bits: Sequence[int]) -> bytes:
    return bytes(sum(int(bits[8 * i + j]) << j for j in range(8))
                 for i in range(len(bits) // 8))


# ---------------------------------------------------------------------------
# SHA-256 (one padded block) netlist
# ---------------------------------------------------------------------------
#: FIPS 180-4 round constants / initial hash value.
SHA256_K = (
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5,
    0x3956c25b, 0x59f111f1, 0x923f82a4, 0xab1c5ed5,
    0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174,
    0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
    0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7,
    0xc6e00bf3, 0xd5a79147, 0x06ca6351, 0x14292967,
    0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
    0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3,
    0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5,
    0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f, 0x682e6ff3,
    0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
)
SHA256_IV = (0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
             0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19)


def _add32(w: BristolWriter, a: Sequence[int],
           b: Sequence[int]) -> List[int]:
    """a + b mod 2^32, ripple carry over LSB-first words: 61 AND + 93 XOR
    (the minimum-bootstrap adder — parallel-prefix forms trade ~5x more
    AND bootstraps for depth, the wrong trade when every gate costs a
    bootstrap and the executor batches whole levels)."""
    s = [w.xor(a[0], b[0])]
    c = w.and_(a[0], b[0])
    for i in range(1, 32):
        t = w.xor(a[i], b[i])
        s.append(w.xor(t, c))
        if i < 31:
            c = w.xor(w.and_(a[i], b[i]), w.and_(c, t))
    return s


def _addc32(w: BristolWriter, a: Sequence[int], k: int) -> List[int]:
    """a + (public constant k) mod 2^32: a half-adder chain specialized on
    k's bits — XNOR/OR where k_i = 1, XOR/AND where k_i = 0, and nothing
    at all while the carry is still known-zero (~60 gates vs 154 for the
    generic adder; used for the 64 round-constant additions)."""
    s: List[int] = []
    c = None                                   # None = carry known zero
    for i in range(32):
        ki = (k >> i) & 1
        last = i == 31
        if c is None:
            if ki:
                s.append(w.inv(a[i]))
                c = None if last else a[i]
            else:
                s.append(a[i])                 # pass-through, no gate
        elif ki:
            s.append(w.gate("XNOR", a[i], c))
            if not last:
                c = w.gate("OR", a[i], c)
        else:
            s.append(w.xor(a[i], c))
            if not last:
                c = w.and_(a[i], c)
    return s


def _rotr(x: Sequence[int], n: int) -> List[int]:
    """Rotate right by n: pure rewiring, zero gates (result bit i is input
    bit (i+n) mod 32 in LSB-first order)."""
    return [x[(i + n) % 32] for i in range(32)]


def _bsig(w: BristolWriter, x: Sequence[int], r1: int, r2: int,
          r3: int) -> List[int]:
    """Big sigma: rotr(r1) ^ rotr(r2) ^ rotr(r3)."""
    a, b, c = _rotr(x, r1), _rotr(x, r2), _rotr(x, r3)
    return [w.xor_many([a[i], b[i], c[i]]) for i in range(32)]


def _ssig(w: BristolWriter, x: Sequence[int], r1: int, r2: int,
          sh: int) -> List[int]:
    """Small sigma: rotr(r1) ^ rotr(r2) ^ shr(sh). The shift's vacated top
    bits contribute nothing, so those positions XOR only two terms."""
    a, b = _rotr(x, r1), _rotr(x, r2)
    return [w.xor_many([a[i], b[i]] + ([x[i + sh]] if i + sh < 32 else []))
            for i in range(32)]


def _ch(w: BristolWriter, e, f, g) -> List[int]:
    """Ch(e,f,g) = g ^ (e & (f ^ g)) — one AND per bit."""
    return [w.xor(g[i], w.and_(e[i], w.xor(f[i], g[i]))) for i in range(32)]


def _maj(w: BristolWriter, a, b, c) -> List[int]:
    """Maj(a,b,c) = a ^ ((a^b) & (a^c)) — one AND per bit."""
    return [w.xor(a[i], w.and_(w.xor(a[i], b[i]), w.xor(a[i], c[i])))
            for i in range(32)]


def _sha256_rounds(w: BristolWriter, inp: Sequence[int],
                   hwords) -> List[int]:
    """Message schedule + 64 rounds + feed-forward on 512 block-input
    wires. hwords: 8 chaining words ([32]-wire lists for the compression
    form, plain ints for the fixed-IV form — constant ints let round 0's
    adds and the feed-forward specialize to ~40%-size constant adders).
    Returns the 256 output-H wires (big-endian digest byte order)."""
    def word_in(t):
        # SHA words are big-endian: word t byte j is block byte 4t+j
        return [inp[8 * (4 * t + 3 - i // 8) + i % 8] for i in range(32)]

    W = [word_in(t) for t in range(16)]
    for t in range(16, 64):
        s0 = _ssig(w, W[t - 15], 7, 18, 3)
        s1 = _ssig(w, W[t - 2], 17, 19, 10)
        W.append(_add32(w, _add32(w, s1, W[t - 7]),
                        _add32(w, s0, W[t - 16])))

    c0 = c1 = None

    def as_wires(v):
        nonlocal c0, c1
        if not isinstance(v, int):
            return v
        if c0 is None:
            c0, c1 = w.gate("EQ", 0), w.gate("EQ", 1)
        return [c1 if (v >> i) & 1 else c0 for i in range(32)]

    a, b, c, d, e, f, g, h = (as_wires(v) for v in hwords)
    for t in range(64):
        T1 = _add32(w, _addc32(w, _add32(w, h, _ch(w, e, f, g)),
                               SHA256_K[t]),
                    _add32(w, _bsig(w, e, 6, 11, 25), W[t]))
        T2 = _add32(w, _bsig(w, a, 2, 13, 22), _maj(w, a, b, c))
        h, g, f, e = g, f, e, _add32(w, d, T1)
        d, c, b, a = c, b, a, _add32(w, T1, T2)

    out_bits: List[int] = []
    for h_in, x in zip(hwords, (a, b, c, d, e, f, g, h)):
        word = (_addc32(w, x, h_in) if isinstance(h_in, int)
                else _add32(w, x, h_in))       # H'_i = H_i + working var
        for byte_i in range(4):                # big-endian digest bytes
            out_bits.extend(word[8 * (3 - byte_i) + bit] for bit in range(8))
    return out_bits


def sha256_block_bristol() -> str:
    """Generate a one-block SHA-256 netlist (Bristol Fashion).

    Input: one 512-bit padded message block (bytes in message order,
    LSB-first per byte — the bits_of convention); output: the 256-bit
    digest, byte order matching hashlib.sha256().digest(). The initial
    hash value is fixed to the FIPS IV (single-block messages, i.e. up to
    55 message bytes after sha256_pad), message-schedule expansion and all
    64 rounds per FIPS 180-4.
    """
    w = BristolWriter()
    inp = w.inputs(512)
    return w.finalize(_sha256_rounds(w, inp, SHA256_IV))


def sha256_compress_bristol() -> str:
    """Generate the chainable SHA-256 compression function: inputs are a
    512-bit message block then the 256-bit incoming hash state (digest
    byte order); output is the 256-bit updated state. Arbitrary-length
    messages = sha256_pad_blocks + one execution per block, feeding each
    output state into the next block's state input (the first block's
    state input is the IV, sha256_iv_bits)."""
    w = BristolWriter()
    inp = w.inputs(512)
    hin = w.inputs(256)
    # state wires arrive in digest byte order: word i byte j at bit
    # offset 8*(4*i+j), big-endian within the word
    hwords = [[hin[32 * i + 8 * (3 - b // 8) + b % 8] for b in range(32)]
              for i in range(8)]
    return w.finalize(_sha256_rounds(w, inp, hwords))


def sha256_iv_bits() -> List[int]:
    """The FIPS initial hash value as 256 state-input bits (digest order),
    for the first sha256_compress_bristol execution."""
    return bits_of(b"".join(v.to_bytes(4, "big") for v in SHA256_IV))


def sha256_pad(msg: bytes) -> bytes:
    """FIPS 180-4 padding for messages that fit one block (<= 55 bytes)."""
    assert len(msg) <= 55, "one-block circuit: message must be <= 55 bytes"
    return (msg + b"\x80" + b"\x00" * (55 - len(msg))
            + (8 * len(msg)).to_bytes(8, "big"))


def sha256_pad_blocks(msg: bytes) -> List[bytes]:
    """FIPS 180-4 padding for any message length: the 64-byte block
    sequence to run through sha256_compress_bristol."""
    padded = (msg + b"\x80"
              + b"\x00" * ((55 - len(msg)) % 64)
              + (8 * len(msg)).to_bytes(8, "big"))
    return [padded[i:i + 64] for i in range(0, len(padded), 64)]
