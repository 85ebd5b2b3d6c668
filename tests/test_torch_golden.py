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


def _oracle_case(mod, case: str, params):
    """Run one of golden's newer oracles on inputs made from fixed seeds
    with `mod`'s own keys; the same call through either module must give
    the same uint32 result."""
    sk = mod.keygen(params, seed=51)
    ek = mod.make_eval_key(sk, seed=52)
    rng = np.random.default_rng(53)
    p = sk.params
    lp = p.lvl1
    mod_ = 1 << 32

    def lvl0(bits):
        return mod.encrypt_bit_batch(bits, sk, rng)

    def lvl1(bits):
        return mod.encrypt_bit_batch(bits, sk, rng, level=1)

    def tv():
        return rng.integers(0, mod_, lp.n, dtype=np.uint64).astype(np.uint32)

    if case == "encrypt_bit_batch_lvl1":
        return lvl1([0, 1, 1, 0])
    if case == "tlwe_encrypt":
        return np.stack([mod.tlwe_encrypt(mu, sk.lvl0, 2.0 ** -15, rng)
                         for mu in (0, 1 << 29, (1 << 32) - 5)])
    if case in ("encrypt_bit", "encrypt_bit_lvl1"):
        level = int(case.endswith("lvl1"))
        return np.stack([mod.encrypt_bit(b, sk, rng, level=level)
                         for b in (0, 1, 1)])
    if case in ("tlwe_phase", "tlwe_decrypt", "decrypt_bit"):
        cts = lvl0([0, 1, 1, 0, 1])
        if case == "tlwe_phase":
            return np.array([mod.tlwe_phase(c, sk.lvl0) for c in cts])
        fn = (mod.decrypt_bit if case == "decrypt_bit"
              else lambda c, _: mod.tlwe_decrypt(c, sk.lvl0))
        out = np.array([fn(c, sk) for c in cts])
        assert out.tolist() == [0, 1, 1, 0, 1]
        return out
    if case == "trlwe_encrypt_zero":
        return mod.trlwe_encrypt_zero(lp, sk.lvl1, rng)
    if case == "trlwe_encrypt_bits":
        return mod.trlwe_encrypt_bits(rng.integers(0, 2, lp.n), lp, sk.lvl1,
                                      rng)
    if case == "trlwe_phase":
        ct = mod.trlwe_encrypt_bits(rng.integers(0, 2, lp.n), lp, sk.lvl1,
                                    rng)
        return mod.trlwe_phase(ct, lp, sk.lvl1)
    if case == "trgsw_encrypt":
        return mod.trgsw_encrypt(1, lp, sk.lvl1, rng)
    if case == "blind_rotate_tv":
        return mod.blind_rotate_tv(lvl0([1])[0], tv(), ek)
    if case == "programmable_bootstrap":
        return mod.programmable_bootstrap(lvl0([0])[0], tv(), ek)
    if case == "mod_switch_round":
        xs = rng.integers(0, mod_, 64, dtype=np.uint64)
        return np.array([mod.mod_switch_round(int(x), lp.nbit, th)
                         for x in xs for th in (0, 1, 2)])
    if case == "blind_rotate_tv_many":
        return mod.blind_rotate_tv_many(lvl0([1])[0], tv(), ek, 1)
    if case == "sample_extract_index":
        tr = rng.integers(0, mod_, (lp.k + 1, lp.n),
                          dtype=np.uint64).astype(np.uint32)
        return np.stack([mod.sample_extract_index(tr, lp, j)
                         for j in (0, 1, 3)])
    if case == "pbs_many":
        return mod.pbs_many(lvl0([1])[0], tv(), 2, ek, theta=1)
    if case == "key_switch_pre":
        a, b = lvl1([1, 0])
        return mod.key_switch(a, ek, pre=(1, -1, (-lp.mu) % mod_, b))
    if case == "gate_lvl1":
        a, b = lvl1([1, 0])
        return mod.gate_lvl1("xor", a, b, ek)
    if case == "not_gate":
        return mod.not_gate(lvl0([1])[0])
    if case == "copy_gate":
        return mod.copy_gate(lvl1([1])[0])
    if case in ("mux_lvl0", "mux_lvl1"):
        enc = lvl0 if case == "mux_lvl0" else lvl1
        c, a, b = enc([1, 0, 1])
        fn = getattr(mod, case)
        return np.stack([fn(c, a, b, ek), fn(c, a, b, ek, negate=True)])
    if case == "cmux":
        tg = mod.trgsw_encrypt(1, lp, sk.lvl1, rng)
        c1 = mod.trlwe_encrypt_zero(lp, sk.lvl1, rng)
        c0 = mod.trlwe_encrypt_zero(lp, sk.lvl1, rng)
        return mod.cmux(tg, c1, c0, lp)
    if case == "refresh":
        return mod.refresh(mod.trlwe_encrypt_zero(lp, sk.lvl1, rng), ek)
    if case == "bootstrap_tlwe2trlwe":
        return mod.bootstrap_tlwe2trlwe(lvl0([1])[0], lp.mu, ek)
    if case == "sei_and_ks":
        return mod.sei_and_ks(mod.trlwe_encrypt_zero(lp, sk.lvl1, rng), ek)
    raise KeyError(case)


ORACLE_CASES = ["encrypt_bit_batch_lvl1", "tlwe_encrypt", "encrypt_bit",
                "encrypt_bit_lvl1", "tlwe_phase", "tlwe_decrypt",
                "decrypt_bit", "trlwe_encrypt_zero",
                "trlwe_encrypt_bits", "trlwe_phase", "trgsw_encrypt",
                "blind_rotate_tv", "programmable_bootstrap",
                "mod_switch_round", "blind_rotate_tv_many",
                "sample_extract_index", "pbs_many", "key_switch_pre",
                "gate_lvl1", "not_gate", "copy_gate", "mux_lvl0", "mux_lvl1",
                "cmux", "refresh", "bootstrap_tlwe2trlwe", "sei_and_ks"]


@pytest.mark.parametrize("case", ORACLE_CASES)
def test_oracles_match(case):
    got = _oracle_case(G, case, P.TINY)
    want = _oracle_case(JG, case, JP.TINY)
    assert got.dtype == want.dtype and np.array_equal(got, want), case


@pytest.mark.parametrize("case", ["gate_lvl1", "mux_lvl1", "pbs_many",
                                  "cmux"])
def test_oracles_match_k2(case):
    got = _oracle_case(G, case, P.TINY_K2)
    want = _oracle_case(JG, case, JP.TINY_K2)
    assert np.array_equal(got, want), case
