"""cufhe_tpu_torch.models.circuits on the CPU against
cufhe_tpu.models.circuits (JAX) at TINY: the same ciphertexts through both
packages, every output compared as uint32, and the decryptions against
plaintext arithmetic."""
import numpy as np
import pytest
import torch

from cufhe_tpu import golden as G
from cufhe_tpu.models import api as JA
from cufhe_tpu.models import circuits as JC
from cufhe_tpu_torch import Context, TrlweCtxt, decrypt_bits, encrypt_bits
from cufhe_tpu_torch.models import circuits as C
from cufhe_tpu_torch.torus import from_u32, to_u32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Intra-op threads off while this module runs: the suite runs several
    worker processes on the same cores, where torch's thread pool spends
    its time waiting for its own threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tiny_key):
    sk, ek = tiny_key
    return sk, ek, Context(ek, device="cpu"), JA.Context(ek)


def _words(sk, values, nbits, seed):
    """Encrypt integers bitwise (LSB first): port Ctxts and the same
    ciphertexts as JAX Ctxts."""
    rng = np.random.default_rng(seed)
    cts = [encrypt_bits((np.asarray(values) >> i) & 1, sk, rng, device="cpu")
           for i in range(nbits)]
    return cts, [JA.Ctxt(to_u32(c.data), 0) for c in cts]


def _same(mine, ref):
    mine = mine if isinstance(mine, (list, tuple)) else [mine]
    ref = ref if isinstance(ref, (list, tuple)) else [ref]
    assert len(mine) == len(ref)
    for m, r in zip(mine, ref):
        assert np.array_equal(to_u32(m.data), np.asarray(r.data))


def _value(sk, word):
    return sum(decrypt_bits(b, sk).astype(np.int64) << i
               for i, b in enumerate(word))


def test_adders_equal_original(setup):
    sk, ek, ctx, jctx = setup
    rng = np.random.default_rng(60)
    a, b = rng.integers(0, 8, 4), rng.integers(0, 8, 4)
    (wa, ja), (wb, jb) = _words(sk, a, 3, 61), _words(sk, b, 3, 62)
    (cin,), (jcin,) = _words(sk, rng.integers(0, 2, 4), 1, 63)
    s, c = C.ripple_carry_add(ctx, wa, wb, cin)
    js, jc = JC.ripple_carry_add(jctx, ja, jb, jcin)
    _same(s + [c], js + [jc])
    assert np.array_equal(_value(sk, s + [c]),
                          a + b + decrypt_bits(cin, sk))
    _same(C.half_adder(ctx, wa[0], wb[0]), JC.half_adder(jctx, ja[0], jb[0]))


def test_equals_and_select_equal_original(setup):
    sk, ek, ctx, jctx = setup
    a = np.array([3, 5, 7, 5])
    b = np.array([3, 4, 7, 1])
    (wa, ja), (wb, jb) = _words(sk, a, 3, 64), _words(sk, b, 3, 65)
    eq = C.equals(ctx, wa, wb)
    _same(eq, JC.equals(jctx, ja, jb))
    assert np.array_equal(decrypt_bits(eq, sk), (a == b).astype(int))
    sel = C.select_word(ctx, eq, wa, wb)
    _same(sel, JC.select_word(jctx, JA.Ctxt(to_u32(eq.data), 0), ja, jb))
    assert np.array_equal(_value(sk, sel), np.where(a == b, a, b))


def test_sub_compare_popcount_equal_original(setup):
    sk, ek, ctx, jctx = setup
    a = np.array([5, 2, 7, 0])
    b = np.array([3, 6, 7, 1])
    (wa, ja), (wb, jb) = _words(sk, a, 3, 66), _words(sk, b, 3, 67)
    d, geq = C.ripple_carry_sub(ctx, wa, wb)
    jd, jgeq = JC.ripple_carry_sub(jctx, ja, jb)
    _same(d + [geq], jd + [jgeq])
    assert np.array_equal(_value(sk, d), (a - b) % 8)
    assert np.array_equal(decrypt_bits(geq, sk), (a >= b).astype(int))
    lt = C.less_than(ctx, wa, wb)
    _same(lt, JC.less_than(jctx, ja, jb))
    assert np.array_equal(decrypt_bits(lt, sk), (a < b).astype(int))
    pc = C.popcount(ctx, wa + wb[:2])
    _same(pc, JC.popcount(jctx, ja + jb[:2]))
    want = sum((v >> i) & 1 for v, n in ((a, 3), (b, 2)) for i in range(n))
    assert np.array_equal(_value(sk, pc), want)


def test_multiply_equals_original(setup):
    sk, ek, ctx, jctx = setup
    a = np.array([3, 2, 1, 0])
    b = np.array([3, 1, 2, 3])
    (wa, ja), (wb, jb) = _words(sk, a, 2, 68), _words(sk, b, 2, 69)
    p = C.multiply(ctx, wa, wb)
    _same(p, JC.multiply(jctx, ja, jb))
    assert np.array_equal(_value(sk, p), a * b)


def _table(sk, rng, d):
    lp = sk.params.lvl1
    words = rng.integers(0, 2, size=(1 << d, lp.n))
    table = np.stack([G.trlwe_encrypt_bits(w, lp, sk.lvl1, rng)
                      for w in words])
    return words, table


def _sels(ctx, jctx, sk, bits, rng):
    lp = sk.params.lvl1
    tgs = [G.trgsw_encrypt(int(b), lp, sk.lvl1, rng) for b in bits]
    return ([ctx.prepare_trgsw(tg) for tg in tgs],
            [jctx.prepare_trgsw(tg) for tg in tgs])


def test_cmux_tree_lookup_equals_original(setup):
    sk, ek, ctx, jctx = setup
    rng = np.random.default_rng(70)
    d = 2
    words, table = _table(sk, rng, d)
    for addr in (1, 2):
        sels, jsels = _sels(ctx, jctx, sk, [(addr >> i) & 1
                                            for i in range(d)], rng)
        got = C.cmux_tree_lookup(ctx, sels, TrlweCtxt(from_u32(table,
                                                               "cpu")))
        want = JC.cmux_tree_lookup(jctx, jsels, JA.TrlweCtxt(table))
        assert np.array_equal(to_u32(got.data), np.asarray(want.data))
        bit0 = ctx.sample_extract_and_keyswitch(got)
        assert decrypt_bits(bit0, sk)[0] == words[addr][0]
    with pytest.raises(ValueError, match="selector"):
        C.cmux_tree_lookup(ctx, sels[:1], TrlweCtxt(from_u32(table, "cpu")))


def test_vertical_packing_read_write_equal_original(setup):
    sk, ek, ctx, jctx = setup
    rng = np.random.default_rng(71)
    lp = sk.params.lvl1
    tree_bits, word_bits = 1, 2
    words, table = _table(sk, rng, tree_bits)
    leaves = TrlweCtxt(from_u32(table, "cpu"))
    for addr in (3, 6):
        sels, jsels = _sels(ctx, jctx, sk, [(addr >> i) & 1 for i in
                                            range(tree_bits + word_bits)],
                            rng)
        bit = C.vertical_packing_lookup(ctx, sels, leaves, word_bits)
        want = JC.vertical_packing_lookup(jctx, jsels, JA.TrlweCtxt(table),
                                          word_bits)
        assert np.array_equal(to_u32(bit.data), np.asarray(want.data))
        assert decrypt_bits(bit, sk)[0] == \
            words[addr >> word_bits][addr & 3]
    with pytest.raises(ValueError, match="word_bits"):
        C.vertical_packing_lookup(ctx, sels, leaves, lp.nbit + 1)
    new_bits = rng.integers(0, 2, lp.n)
    value = G.trlwe_encrypt_bits(new_bits, lp, sk.lvl1, rng)[None]
    sels, jsels = _sels(ctx, jctx, sk, [1], rng)
    got = C.vertical_packing_write(ctx, sels, leaves,
                                   TrlweCtxt(from_u32(value, "cpu")))
    want = JC.vertical_packing_write(jctx, jsels, JA.TrlweCtxt(table),
                                     JA.TrlweCtxt(value))
    assert np.array_equal(to_u32(got.data), np.asarray(want.data))
    for wi, expect in enumerate((words[0], new_bits)):
        phase = G.trlwe_phase(to_u32(got.data)[wi], lp, sk.lvl1)
        assert np.array_equal((phase.astype(np.int64) >> 31) ^ 1, expect)
    with pytest.raises(ValueError, match="selector"):
        C.vertical_packing_write(ctx, sels * 2, leaves,
                                 TrlweCtxt(from_u32(value, "cpu")))
