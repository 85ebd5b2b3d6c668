"""Parameter sets for TFHE gate bootstrapping.

A copy of cufhe_tpu/params.py, so that the port never imports the JAX
package: the same frozen dataclasses and the same presets, value for
value (tests/test_torch_golden.py holds them equal).

Shape conventions (all torus values are uint32, i.e. Z_{2^32}):
  TLWE  level-L ciphertext: [k*n + 1]   (a_0..a_{kn-1}, b)
  TRLWE ciphertext:         [k+1, N]    (a polys first, b last)
  TRGSW ciphertext:         [(k+1)*l, k+1, N]
  BootstrappingKey:         [n0, (k+1)*l, k+1, N]
  KeySwitchingKey:          [k1*N, t, 2^(basebit-1), k0*n0 + 1]
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LweParams:
    """TLWE (scalar LWE) parameter set."""

    n: int                 # LWE dimension (per poly; total dim = k*n)
    k: int = 1             # number of mask polynomials / blocks
    alpha: float = 0.0     # stddev of modular-Gaussian noise (fraction of torus)
    mu: int = 1 << 29      # plaintext amplitude (1/8 of the torus)

    @property
    def dim(self) -> int:
        return self.k * self.n


@dataclasses.dataclass(frozen=True)
class TrlweParams:
    """TRLWE/TRGSW parameter set."""

    nbit: int              # log2(N)
    k: int = 1
    l: int = 3             # gadget decomposition length
    Bgbit: int = 6         # gadget base bits (Bg = 2**Bgbit)
    alpha: float = 0.0
    mu: int = 1 << 29

    @property
    def n(self) -> int:
        return 1 << self.nbit

    @property
    def Bg(self) -> int:
        return 1 << self.Bgbit

    @property
    def decomp_offset(self) -> int:
        """Sum of Bg/2 at every gadget digit position."""
        off = 0
        for i in range(1, self.l + 1):
            off += (self.Bg // 2) * (1 << (32 - i * self.Bgbit))
        return off & 0xFFFFFFFF

    @property
    def decomp_roundoffset(self) -> int:
        """Half of the lowest gadget digit: rounds the decomposition."""
        return 1 << (32 - self.l * self.Bgbit - 1)

    def as_lwe(self) -> LweParams:
        """The LWE view of extracted samples (dimension k*N)."""
        return LweParams(n=self.n, k=self.k, alpha=self.alpha, mu=self.mu)


@dataclasses.dataclass(frozen=True)
class KeySwitchParams:
    """Identity key switch from the lvl1 domain to lvl0."""

    t: int = 8             # number of decomposition digits
    basebit: int = 2       # digit width in bits

    @property
    def numbase(self) -> int:
        return 1 << (self.basebit - 1)

    @property
    def decomp_offset(self) -> int:
        off = 0
        for i in range(1, self.t + 1):
            off += ((1 << self.basebit) // 2) * (1 << (32 - i * self.basebit))
        return off & 0xFFFFFFFF

    @property
    def roundoffset(self) -> int:
        if self.basebit * self.t < 32:
            return 1 << (32 - (1 + self.basebit * self.t))
        return 0


@dataclasses.dataclass(frozen=True)
class GateParams:
    """Full gate-bootstrapping parameter bundle: `lvl0` is the small LWE
    level, `lvl1` the TRLWE level, `ks` the lvl1 -> lvl0 key switch."""

    name: str
    lvl0: LweParams
    lvl1: TrlweParams
    ks: KeySwitchParams

    @property
    def n0(self) -> int:
        return self.lvl0.dim

    @property
    def N(self) -> int:
        return self.lvl1.n


# ---------------------------------------------------------------------------
# Presets (the published TFHEpp / TFHE-lib / CONCRETE sets, and tiny
# insecure sets for exact tests; see cufhe_tpu/params.py for their notes).
# ---------------------------------------------------------------------------

#: TFHEpp 128-bit default (cuFHE's default build).
TFHEPP_128 = GateParams(
    name="tfhepp_128bit",
    lvl0=LweParams(n=636, k=1, alpha=0.0000925119974676756, mu=1 << 29),
    lvl1=TrlweParams(nbit=10, k=1, l=3, Bgbit=6,
                     alpha=0.0000000342338787018369, mu=1 << 29),
    ks=KeySwitchParams(t=8, basebit=2),
)

#: The 128-bit set with l=2 / Bg=256: a third less external-product work
#: for a larger correctness-noise budget.
TFHEPP_128_BG8 = GateParams(
    name="tfhepp_128bit_bg8",
    lvl0=LweParams(n=636, k=1, alpha=0.0000925119974676756, mu=1 << 29),
    lvl1=TrlweParams(nbit=10, k=1, l=2, Bgbit=8,
                     alpha=0.0000000342338787018369, mu=1 << 29),
    ks=KeySwitchParams(t=8, basebit=2),
)

#: The original CGGI16 80-bit set.
TFHEPP_80 = GateParams(
    name="tfhepp_80bit",
    lvl0=LweParams(n=500, k=1, alpha=2.44e-5, mu=1 << 29),
    lvl1=TrlweParams(nbit=10, k=1, l=2, Bgbit=10, alpha=3.73e-9, mu=1 << 29),
    ks=KeySwitchParams(t=8, basebit=2),
)

#: CGGI19 128-bit set.
CGGI19 = GateParams(
    name="cggi19",
    lvl0=LweParams(n=630, k=1, alpha=3.0517578125e-05, mu=1 << 29),
    lvl1=TrlweParams(nbit=10, k=1, l=3, Bgbit=7, alpha=2.9802322387695312e-08,
                     mu=1 << 29),
    ks=KeySwitchParams(t=8, basebit=2),
)

#: CONCRETE boolean default (k=2, N=512).
CONCRETE = GateParams(
    name="concrete",
    lvl0=LweParams(n=586, k=1, alpha=9.25119974676756e-05, mu=1 << 29),
    lvl1=TrlweParams(nbit=9, k=2, l=2, Bgbit=8, alpha=2.9802322387695312e-08,
                     mu=1 << 29),
    ks=KeySwitchParams(t=5, basebit=2),
)

#: N=2048-class set for radix-4 (msg_bits=2) encrypted integers.
RADIX4_2048 = GateParams(
    name="radix4_2048",
    lvl0=LweParams(n=1024, k=1, alpha=2.0 ** -17, mu=1 << 29),
    lvl1=TrlweParams(nbit=11, k=1, l=3, Bgbit=9, alpha=2.0 ** -31,
                     mu=1 << 29),
    ks=KeySwitchParams(t=8, basebit=2),
)

#: Tiny insecure parameters for fast exact unit tests (alpha = 0: the whole
#: pipeline is deterministic).
TINY = GateParams(
    name="tiny-insecure-test",
    lvl0=LweParams(n=16, k=1, alpha=0.0, mu=1 << 29),
    lvl1=TrlweParams(nbit=6, k=1, l=2, Bgbit=6, alpha=0.0, mu=1 << 29),
    ks=KeySwitchParams(t=4, basebit=2),
)

#: "Quiet" tiny set for the radix-4 integer layer.
TINY_Q = GateParams(
    name="tiny-quiet-ks-insecure-test",
    lvl0=LweParams(n=16, k=1, alpha=0.0, mu=1 << 29),
    lvl1=TrlweParams(nbit=9, k=1, l=3, Bgbit=8, alpha=0.0, mu=1 << 29),
    ks=KeySwitchParams(t=7, basebit=3),
)

#: Tiny set with N=128.
PALLAS_TINY = GateParams(
    name="pallas-tiny-insecure-test",
    lvl0=LweParams(n=8, k=1, alpha=0.0, mu=1 << 29),
    lvl1=TrlweParams(nbit=7, k=1, l=2, Bgbit=6, alpha=0.0, mu=1 << 29),
    ks=KeySwitchParams(t=4, basebit=2),
)

#: Tiny with k=2 (the CONCRETE-style multi-block path).
TINY_K2 = GateParams(
    name="tiny-k2-insecure-test",
    lvl0=LweParams(n=12, k=1, alpha=0.0, mu=1 << 29),
    lvl1=TrlweParams(nbit=5, k=2, l=2, Bgbit=6, alpha=0.0, mu=1 << 29),
    ks=KeySwitchParams(t=4, basebit=2),
)

#: Tiny k=2 with N=128.
PALLAS_TINY_K2 = GateParams(
    name="pallas-tiny-k2-insecure-test",
    lvl0=LweParams(n=8, k=1, alpha=0.0, mu=1 << 29),
    lvl1=TrlweParams(nbit=7, k=2, l=2, Bgbit=8, alpha=0.0, mu=1 << 29),
    ks=KeySwitchParams(t=4, basebit=2),
)

#: Tiny Bg=1024 set: digits wider than 8 bits (the 80-bit set's gadget).
PALLAS_BG10 = GateParams(
    name="pallas-bg10-insecure-test",
    lvl0=LweParams(n=8, k=1, alpha=0.0, mu=1 << 29),
    lvl1=TrlweParams(nbit=7, k=1, l=2, Bgbit=10, alpha=0.0, mu=1 << 29),
    ks=KeySwitchParams(t=4, basebit=2),
)

#: Tiny N=512 / Bgbit=6 set.
PALLAS_KAR = GateParams(
    name="pallas-kar-insecure-test",
    lvl0=LweParams(n=8, k=1, alpha=0.0, mu=1 << 29),
    lvl1=TrlweParams(nbit=9, k=1, l=2, Bgbit=6, alpha=0.0, mu=1 << 29),
    ks=KeySwitchParams(t=4, basebit=2),
)

#: Tiny N=512 / Bg=1024 set.
PALLAS_BG10_KAR = GateParams(
    name="pallas-bg10-kar-insecure-test",
    lvl0=LweParams(n=8, k=1, alpha=0.0, mu=1 << 29),
    lvl1=TrlweParams(nbit=9, k=1, l=2, Bgbit=10, alpha=0.0, mu=1 << 29),
    ks=KeySwitchParams(t=4, basebit=2),
)

PRESETS = {p.name: p for p in (TFHEPP_128, TFHEPP_128_BG8, TFHEPP_80, CGGI19,
                               CONCRETE, RADIX4_2048, TINY, TINY_Q,
                               PALLAS_TINY, TINY_K2,
                               PALLAS_TINY_K2, PALLAS_BG10, PALLAS_KAR,
                               PALLAS_BG10_KAR)}
DEFAULT = TFHEPP_128
