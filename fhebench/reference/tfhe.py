"""Plain TFHE gate bootstrapping in PyTorch: the benchmark's reference.

Everything a configuration's keys, inputs and gates need, written from the
TFHE equations and independent of the program under test (it imports
nothing of it): secret and evaluation key generation from a seed, lvl0
encryption and decryption, and the lvl0 two-input gate

    pre-add -> mod switch and rotated test vector -> n0-step blind rotation
    -> sample extraction of coefficient 0 -> identity key switch to lvl0.

Torus values are held as int64 tensors in [0, 2^32) and every sum is
reduced mod 2^32, so the results are exact uint32 words. The two products
(the external product of each rotation step and the key switch) run as
float64 matrix products on integers whose every partial sum stays below
2^53, so they are exact on the CPU and on a CUDA device alike
(`exact_product_bits` checks the bound). The tensors may live on any
device; the generator that draws keys and inputs lives on the same one.
"""
from __future__ import annotations

import dataclasses

import torch

MOD = 1 << 32
MASK = MOD - 1

#: gate -> (ca, cb, offset in multiples of mu): out = bootstrap(ca*x + cb*y
#: + offset), the TFHE gate constants (CGGI16, section 3.1 of TFHEpp's
#: gate.hpp convention)
GATE_CONSTANTS = {
    "nand": (-1, -1, 1), "nor": (-1, -1, -1), "xnor": (-2, -2, -2),
    "and": (1, 1, -1), "or": (1, 1, 1), "xor": (2, 2, 2),
    "andny": (-1, 1, -1), "andyn": (1, -1, -1),
    "orny": (-1, 1, 1), "oryn": (1, -1, 1),
}


def plain_gate(name: str, a, b):
    """The gate on cleartext bits (0/1 integer arrays or tensors), as the
    bootstrap reads it: the sign of the phase ca (2a-1) mu + cb (2b-1) mu +
    om mu on the torus, mu being 1/8 of it."""
    ca, cb, om = GATE_CONSTANTS[name]
    v = (ca * (2 * a - 1) + cb * (2 * b - 1) + om) % 8
    return ((v > 0) & (v < 4)) * 1


@dataclasses.dataclass(frozen=True)
class Params:
    """One gate-bootstrapping parameter set, as a configuration file gives
    it: lvl0 LWE (n0, alpha0, mu0), lvl1 TRLWE (N, k, l, Bgbit, alpha1,
    mu1) and the lvl1 -> lvl0 key switch (t, basebit)."""

    n0: int
    alpha0: float
    mu0: int
    N: int
    k: int
    l: int
    Bgbit: int
    alpha1: float
    mu1: int
    t: int
    basebit: int

    @classmethod
    def from_config(cls, cfg: dict) -> "Params":
        a, b, c = cfg["lvl0"], cfg["lvl1"], cfg["keyswitch"]
        if a["k"] != 1:
            raise ValueError("lvl0 is a plain LWE level: k must be 1")
        return cls(n0=a["n"], alpha0=a["alpha"], mu0=a["mu"], N=b["N"],
                   k=b["k"], l=b["l"], Bgbit=b["Bgbit"], alpha1=b["alpha"],
                   mu1=b["mu"], t=c["t"], basebit=c["basebit"])

    @property
    def nbit(self) -> int:
        if self.N & (self.N - 1):
            raise ValueError(f"N = {self.N} is not a power of two")
        return self.N.bit_length() - 1

    @property
    def rows(self) -> int:
        """Gadget rows of a TRGSW: (k+1) l."""
        return (self.k + 1) * self.l


# ---------------------------------------------------------------------------
# Keys and encryption
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SecretKey:
    lvl0: torch.Tensor   # [n0] int64 in {0, 1}
    lvl1: torch.Tensor   # [k, N] int64 in {0, 1}


@dataclasses.dataclass
class EvalKey:
    bk: torch.Tensor     # [n0, (k+1) l, k+1, N]: TRGSW(s0[i]) under s1
    ksk: torch.Tensor    # [k N, t, 2^(basebit-1), n0+1]: TLWE under s0 of
    #                      s1[j] (m+1) 2^(32-(d+1) basebit)


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on `device` for one use of a run's seed (`stream` keeps
    keys, inputs and checks apart). Any whole number is a seed."""
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1_000_003 + stream) % (1 << 63))
    return g


def _uniform32(shape, g: torch.Generator) -> torch.Tensor:
    return torch.randint(0, MOD, shape, generator=g, dtype=torch.int64,
                         device=g.device)


def _gaussian32(shape, alpha: float, g: torch.Generator) -> torch.Tensor:
    """Torus noise of standard deviation alpha, rounded to 2^-32."""
    if alpha == 0.0:
        return torch.zeros(shape, dtype=torch.int64, device=g.device)
    e = torch.randn(shape, generator=g, dtype=torch.float64, device=g.device)
    return torch.round(e * (alpha * MOD)).to(torch.int64) & MASK


def _dot_binary(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """a [..., d] (values < 2^32) times a binary s [d], exact: two float64
    products on 16-bit halves (each partial sum < 2^16 d < 2^53)."""
    sf = s.to(torch.float64)
    lo = ((a & 0xFFFF).to(torch.float64) @ sf).to(torch.int64)
    hi = ((a >> 16).to(torch.float64) @ sf).to(torch.int64)
    return ((hi << 16) + lo) & MASK


def negacyclic_matrix(s: torch.Tensor) -> torch.Tensor:
    """[..., N] -> [..., N, N] with (a @ S) the negacyclic product a * s:
    S[u, v] = s[v - u] for v >= u, -s[N + v - u] for v < u."""
    N = s.shape[-1]
    u = torch.arange(N, device=s.device)[:, None]
    v = torch.arange(N, device=s.device)[None, :]
    ext = torch.cat([-s, s], dim=-1)
    return ext[..., N + v - u]


def keygen(p: Params, seed: int, device) -> SecretKey:
    g = generator(seed, 0, device)
    return SecretKey(torch.randint(0, 2, (p.n0,), generator=g,
                                   device=device, dtype=torch.int64),
                     torch.randint(0, 2, (p.k, p.N), generator=g,
                                   device=device, dtype=torch.int64))


def make_eval_key(p: Params, sk: SecretKey, seed: int) -> EvalKey:
    """The bootstrapping and key-switching keys, drawn in a few batched
    calls on the secret key's device."""
    g = generator(seed, 1, sk.lvl0.device)
    n0, N, k, l = p.n0, p.N, p.k, p.l
    # BK: n0 (k+1) l TRLWE encryptions of zero, plus s0[i] 2^(32-(d+1)Bgbit)
    # on component j, coefficient 0 of row j l + d
    m = n0 * p.rows
    a = _uniform32((m, k, N), g)
    b = _gaussian32((m, N), p.alpha1, g)
    for j in range(k):
        S = negacyclic_matrix(sk.lvl1[j].to(torch.float64))
        lo = ((a[:, j] & 0xFFFF).to(torch.float64) @ S).to(torch.int64)
        hi = ((a[:, j] >> 16).to(torch.float64) @ S).to(torch.int64)
        b = b + (hi << 16) + lo
    bk = torch.cat([a, (b & MASK)[:, None, :]], dim=1).reshape(
        n0, p.rows, k + 1, N)
    h = torch.tensor([1 << (32 - (d + 1) * p.Bgbit) for d in range(l)],
                     dtype=torch.int64, device=g.device)
    for j in range(k + 1):
        rows = slice(j * l, (j + 1) * l)
        bk[:, rows, j, 0] = (bk[:, rows, j, 0]
                             + sk.lvl0[:, None] * h[None, :]) & MASK
    # KSK: every (coefficient j of s1, digit d, value m+1) as one TLWE
    nb = 1 << (p.basebit - 1)
    scale = torch.tensor(
        [[((mm + 1) << (32 - (d + 1) * p.basebit)) % MOD for mm in range(nb)]
         for d in range(p.t)], dtype=torch.int64, device=g.device)
    mus = (sk.lvl1.reshape(-1)[:, None, None] * scale[None]) & MASK
    ksk = encrypt(mus.reshape(-1), sk.lvl0, p.alpha0, g)
    return EvalKey(bk, ksk.reshape(p.k * N, p.t, nb, n0 + 1))


def encrypt(mus: torch.Tensor, key: torch.Tensor, alpha: float,
            g: torch.Generator) -> torch.Tensor:
    """TLWE samples (a, <a, s> + mu + e) of torus messages mus [B]:
    [B, d+1] int64."""
    a = _uniform32((mus.shape[0], key.shape[0]), g)
    b = (_dot_binary(a, key) + mus + _gaussian32(mus.shape, alpha, g)) & MASK
    return torch.cat([a, b[:, None]], dim=1)


def encrypt_bits(p: Params, sk: SecretKey, bits: torch.Tensor,
                 g: torch.Generator) -> torch.Tensor:
    """lvl0 encryptions of bits [B] as +-mu0: [B, n0+1] int64."""
    mus = torch.where(bits.to(g.device) != 0, p.mu0, MOD - p.mu0)
    return encrypt(mus.to(torch.int64), sk.lvl0, p.alpha0, g)


def phase(sk: SecretKey, ct: torch.Tensor) -> torch.Tensor:
    """b - <a, s0> of lvl0 ciphertexts [B, n0+1] (any integer dtype holding
    the uint32 words), as int64 in [-2^31, 2^31)."""
    ct = ct.to(device=sk.lvl0.device, dtype=torch.int64) & MASK
    return _signed((ct[:, -1] - _dot_binary(ct[:, :-1], sk.lvl0)) & MASK)


def decrypt_bits(sk: SecretKey, ct: torch.Tensor) -> torch.Tensor:
    """Bits of lvl0 ciphertexts: 1 where the phase, read as int32, is
    positive."""
    return (phase(sk, ct) > 0).to(torch.int64)


# ---------------------------------------------------------------------------
# The gate
# ---------------------------------------------------------------------------

def exact_product_bits(p: Params) -> float:
    """log2 of the largest partial sum of one rotation step's product in
    float64: digits below Bg/2, key words as signed int32, (k+1) l N terms.
    Below 53 the product is exact."""
    import math
    return (p.Bgbit - 1) + 31 + math.log2(p.rows * p.N)


def _signed(x: torch.Tensor) -> torch.Tensor:
    """[0, 2^32) -> [-2^31, 2^31), the same residue."""
    return torch.where(x >= 1 << 31, x - MOD, x)


def _rotate(acc: torch.Tensor, a: torch.Tensor, nbit: int) -> torch.Tensor:
    """acc [B, c, N] times X^a [B], a in [0, 2N), negacyclically."""
    N = acc.shape[-1]
    i = torch.arange(N, device=acc.device)
    src = acc.gather(2, ((i[None, :] - a[:, None]) % N)[:, None, :]
                     .expand(-1, acc.shape[1], -1))
    neg = (i[None, :] < (a[:, None] & (N - 1))) ^ ((a[:, None] >> nbit) & 1
                                                   ).bool()
    return torch.where(neg[:, None, :], (-src) & MASK, src)


def blind_rotate(p: Params, bk: torch.Tensor, a: torch.Tensor,
                 acc: torch.Tensor) -> torch.Tensor:
    """acc [B, k+1, N] after the n0 CMUX steps of the mask a [B, n0]:
    acc += ExtProd(BK_i, Decomp(acc X^abar_i - acc)), the product as one
    float64 matrix product with BK_i's negacyclic operator."""
    if exact_product_bits(p) >= 53:
        raise ValueError("the float64 product would not be exact at these "
                         "parameters")
    N, nbit, l, kp1 = p.N, p.nbit, p.l, p.k + 1
    B = acc.shape[0]
    roundoffset = 1 << (32 - 2 - nbit)
    off = sum((1 << (p.Bgbit - 1)) << (32 - (d + 1) * p.Bgbit)
              for d in range(l)) + (1 << (32 - l * p.Bgbit - 1))
    shifts = torch.tensor([32 - (d + 1) * p.Bgbit for d in range(l)],
                          device=acc.device)
    half, mask = 1 << (p.Bgbit - 1), (1 << p.Bgbit) - 1
    for i in range(p.n0):
        abar = (((a[:, i] + roundoffset) & MASK) >> (32 - 1 - nbit))
        temp = (_rotate(acc, abar, nbit) - acc + off) & MASK
        dec = ((temp[:, :, None, :] >> shifts[None, None, :, None]) & mask
               ) - half                                  # [B, k+1, l, N]
        T = negacyclic_matrix(_signed(bk[i]).to(torch.float64))
        # T [rows, k+1, N(u), N(v)] -> [rows N(u), (k+1) N(v)]
        T = T.permute(0, 2, 1, 3).reshape(p.rows * N, kp1 * N)
        upd = dec.reshape(B, p.rows * N).to(torch.float64) @ T
        acc = (acc + upd.to(torch.int64).reshape(B, kp1, N)) & MASK
    return acc


def sample_extract(p: Params, acc: torch.Tensor) -> torch.Tensor:
    """The lvl1-domain TLWE [B, k N + 1] of coefficient 0 of acc."""
    a = acc[:, :p.k, :]
    ext = torch.cat([a[:, :, :1], (-a[:, :, 1:].flip(-1)) & MASK], dim=2)
    return torch.cat([ext.reshape(acc.shape[0], p.k * p.N),
                      acc[:, p.k, :1]], dim=1)


def key_switch(p: Params, ksk: torch.Tensor, tlwe1: torch.Tensor,
               block_rows: int = 1024) -> torch.Tensor:
    """Identity key switch of [B, k N + 1] to lvl0 [B, n0+1]: each digit
    v in [-2^(basebit-1), 2^(basebit-1)) of each coefficient subtracts
    ksk[j, d, v-1] (v > 0) or adds ksk[j, d, -v-1] (v < 0); as one float64
    product of signed one-hot rows with the key (< 2^(31 + log2(k N t))
    per sum)."""
    d1, nb = p.k * p.N, 1 << (p.basebit - 1)
    off = (sum((1 << (p.basebit - 1)) << (32 - (d + 1) * p.basebit)
               for d in range(p.t))
           + ((1 << (32 - (1 + p.basebit * p.t)))
              if p.basebit * p.t < 32 else 0)) % MOD
    shifts = torch.tensor([32 - (d + 1) * p.basebit for d in range(p.t)],
                          device=tlwe1.device)
    K = _signed(ksk).to(torch.float64).reshape(d1 * p.t * nb, p.n0 + 1)
    slot = torch.arange(nb, device=tlwe1.device)
    out = []
    for r in range(0, tlwe1.shape[0], block_rows):
        x = tlwe1[r:r + block_rows]
        tmp = (x[:, :d1] + off) & MASK
        v = ((tmp[:, :, None] >> shifts) & ((1 << p.basebit) - 1)) - nb
        # [b, d1, t, nb]: -sign(v) at slot |v| - 1, 0 elsewhere
        coef = torch.where(v.abs()[..., None] - 1 == slot,
                           -v.sign()[..., None], 0)
        res = (coef.reshape(x.shape[0], -1).to(torch.float64) @ K
               ).to(torch.int64)
        res[:, p.n0] += x[:, d1]
        out.append(res & MASK)
    return torch.cat(out)


def gate(p: Params, ek: EvalKey, name: str, x: torch.Tensor,
         y: torch.Tensor) -> torch.Tensor:
    """A bootstrapped two-input gate on lvl0 ciphertexts x, y [B, n0+1]
    (values in [0, 2^32)): [B, n0+1] int64."""
    ca, cb, om = GATE_CONSTANTS[name]
    comb = (ca * x + cb * y) & MASK
    b = (comb[:, p.n0] + om * p.mu0) & MASK
    N, nbit = p.N, p.nbit
    bar = 2 * N - (b >> (32 - 1 - nbit))                # [1, 2N]
    i = torch.arange(N, device=x.device)
    neg = (i[None, :] < (bar[:, None] & (N - 1))) ^ ((bar[:, None] >> nbit)
                                                     & 1).bool()
    acc = torch.zeros((x.shape[0], p.k + 1, N), dtype=torch.int64,
                      device=x.device)
    acc[:, p.k] = torch.where(neg, MOD - p.mu1, p.mu1)
    acc = blind_rotate(p, ek.bk, comb[:, :p.n0], acc)
    return key_switch(p, ek.ksk, sample_extract(p, acc))
