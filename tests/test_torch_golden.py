"""cufhe_tpu_torch's own client side (golden.py, params.py, rng.py) against
the cufhe_tpu modules it copies: the same presets, the same keys and
ciphertexts from the same seeds, and the same gate outputs, as uint32
equality."""
import dataclasses

import numpy as np
import pytest

from cufhe_tpu import golden as JG
from cufhe_tpu import params as JP
from cufhe_tpu import rng as JR
from cufhe_tpu_torch import golden as G
from cufhe_tpu_torch import params as P
from cufhe_tpu_torch import rng as R

PROPS = {"lvl0": ("dim",), "lvl1": ("n", "Bg", "decomp_offset",
                                    "decomp_roundoffset"),
         "ks": ("numbase", "decomp_offset", "roundoffset")}


@pytest.mark.parametrize("name", sorted(JP.PRESETS))
def test_presets_match(name):
    got, want = P.PRESETS[name], JP.PRESETS[name]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for part, props in PROPS.items():
        for prop in props:
            assert getattr(getattr(got, part), prop) == \
                getattr(getattr(want, part), prop), (part, prop)
    assert (got.n0, got.N) == (want.n0, want.N)


def test_default_and_gate_tables_match():
    assert P.DEFAULT.name == JP.DEFAULT.name
    assert G.GATE_CONSTANTS == JG.GATE_CONSTANTS
    assert set(G.PLAIN_GATES) == set(JG.PLAIN_GATES)
    for name, fn in G.PLAIN_GATES.items():
        n = fn.__code__.co_argcount
        for bits in np.ndindex(*(2,) * n):
            assert fn(*bits) == JG.PLAIN_GATES[name](*bits), (name, bits)


@pytest.mark.parametrize("name", ["tiny-insecure-test",
                                  "tiny-k2-insecure-test", "tfhepp_128bit"])
def test_keys_match_from_the_same_seeds(name):
    params = P.PRESETS[name]
    sk, jsk = G.keygen(params, seed=11), JG.keygen(JP.PRESETS[name], seed=11)
    assert np.array_equal(sk.lvl0, jsk.lvl0)
    assert np.array_equal(sk.lvl1, jsk.lvl1)
    if params.n0 > 100:   # the full-size evaluation key is for the chip
        return
    ek, jek = G.make_eval_key(sk, seed=12), JG.make_eval_key(jsk, seed=12)
    assert ek.bk.dtype == np.uint32 and np.array_equal(ek.bk, jek.bk)
    assert ek.ksk.dtype == np.uint32 and np.array_equal(ek.ksk, jek.ksk)


@pytest.mark.parametrize("name", ["tiny-insecure-test", "tfhepp_128bit"])
def test_encrypt_decrypt_match(name):
    params = P.PRESETS[name]
    sk = G.keygen(params, seed=13)
    bits = np.random.default_rng(14).integers(0, 2, 64)
    cts = G.encrypt_bit_batch(bits, sk, np.random.default_rng(15))
    want = JG.encrypt_bit_batch(bits, JG.keygen(JP.PRESETS[name], seed=13),
                                np.random.default_rng(15))
    assert cts.dtype == np.uint32 and np.array_equal(cts, want)
    assert np.array_equal(G.decrypt_bit_batch(cts, sk), bits)
    assert np.array_equal(JG.decrypt_bit_batch(cts, sk), bits)


@pytest.mark.parametrize("name", ["tiny-insecure-test",
                                  "tiny-k2-insecure-test"])
def test_gate_lvl0_matches(name):
    sk = G.keygen(P.PRESETS[name], seed=16)
    ek = G.make_eval_key(sk, seed=17)
    rng = np.random.default_rng(18)
    bits0, bits1 = [0, 1, 0, 1], [0, 0, 1, 1]
    a = G.encrypt_bit_batch(bits0, sk, rng)
    b = G.encrypt_bit_batch(bits1, sk, rng)
    for gate in G.GATE_CONSTANTS:
        got = np.stack([G.gate_lvl0(gate, x, y, ek) for x, y in zip(a, b)])
        want = np.stack([JG.gate_lvl0(gate, x, y, ek) for x, y in zip(a, b)])
        assert got.dtype == np.uint32 and np.array_equal(got, want), gate
        assert G.decrypt_bit_batch(got, sk).tolist() == \
            [G.PLAIN_GATES[gate](x, y) for x, y in zip(bits0, bits1)]


def test_secure_default_rng():
    assert isinstance(R.resolve_rng(), R.SecureRandom)
    gen = np.random.default_rng(0)
    assert R.resolve_rng(rng=gen) is gen
    assert np.array_equal(R.resolve_rng(seed=5).integers(0, 1 << 32, 8),
                          JR.resolve_rng(seed=5).integers(0, 1 << 32, 8))
    sec = R.SecureRandom()
    x = sec.integers(0, 7, size=4096)
    assert x.min() >= 0 and x.max() < 7 and len(np.unique(x)) == 7
    assert 0.0 <= float(sec.random()) < 1.0
    assert abs(float(np.std(sec.normal(0.0, 1.0, size=4096))) - 1.0) < 0.1
    with pytest.raises(AttributeError, match="client side"):
        sec.permutation(3)
    sk = G.keygen(P.TINY)                 # no seed: drawn from the CSPRNG
    assert set(np.unique(sk.lvl0)) <= {0, 1}
