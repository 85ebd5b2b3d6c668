"""The bootstrapping paths of cufhe_tpu_torch beyond the lvl0 gate, on the
CPU, against their cufhe_tpu (JAX) counterparts and the JAX package's
NumPy golden model, as uint32 equality: lvl1 gates and the one-KSK lvl1 key
switch, mux/nmux, not/copy, gate_rows, gate_chain, CMUX, refresh, the
TLWE -> TRLWE bootstrap, programmable bootstrapping and pbs_many."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cufhe_tpu import golden as G
from cufhe_tpu.models import api as JA
from cufhe_tpu.ops import bootstrap as JB
from cufhe_tpu.ops import keys as JK
from cufhe_tpu.ops import keyswitch as JKS
from cufhe_tpu_torch import Context, Ctxt, TrlweCtxt, decrypt_bits
from cufhe_tpu_torch import encrypt_bits
from cufhe_tpu_torch.models.gates import TWO_INPUT
from cufhe_tpu_torch.ops import bootstrap as TB
from cufhe_tpu_torch.ops import keys as TK
from cufhe_tpu_torch.ops import keyswitch as TKS
from cufhe_tpu_torch.torus import from_u32, i32, to_u32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Intra-op threads off while this module runs: the suite runs several
    worker processes on the same cores, where torch's thread pool spends
    its time waiting for its own threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BITS0 = [0, 1, 0, 1]
BITS1 = [0, 0, 1, 1]
BITSC = [0, 1, 1, 0]
_MOD = 1 << 32


@pytest.fixture(scope="module")
def setup(tiny_key):
    sk, ek = tiny_key
    return sk, ek, Context(ek, device="cpu"), JA.Context(ek)


@pytest.fixture(scope="module")
def jkeys(tiny_key):
    return JK.prepare_keys(tiny_key[1], backends=("conv",))


def _j(ct: Ctxt) -> JA.Ctxt:
    return JA.Ctxt(jnp.asarray(to_u32(ct.data)), ct.level)


def _np(x) -> np.ndarray:
    return np.asarray(x)


def _rows(fn, *cols):
    """golden fn applied row by row to uint32 [B, ...] arrays."""
    return np.stack([fn(*r) for r in zip(*cols)])


def test_encrypt_lvl1_matches_jax(setup):
    sk, ek, ctx, jctx = setup
    ct = encrypt_bits(BITS0, sk, np.random.default_rng(5), level=1,
                      device="cpu")
    want = JA.encrypt_bits(BITS0, sk, np.random.default_rng(5), level=1)
    assert ct.level == 1 and ct.batch == 4
    assert ct.data.shape == (4, sk.params.lvl1.k * sk.params.lvl1.n + 1)
    assert np.array_equal(to_u32(ct.data), _np(want.data))
    assert decrypt_bits(ct, sk).tolist() == BITS0


def test_gate_lvl1_all_ten(setup):
    sk, ek, ctx, jctx = setup
    rng = np.random.default_rng(91)
    a = encrypt_bits(BITS0, sk, rng, level=1, device="cpu")
    b = encrypt_bits(BITS1, sk, rng, level=1, device="cpu")
    for name in TWO_INPUT:
        out = ctx.gate(name, a, b)
        assert out.level == 1
        got = to_u32(out.data)
        assert np.array_equal(got, _np(jctx.gate(name, _j(a), _j(b)).data))
        want = _rows(lambda x, y: G.gate_lvl1(name, x, y, ek),
                     to_u32(a.data), to_u32(b.data))
        assert np.array_equal(got, want), name
        assert decrypt_bits(out, sk).tolist() == \
            [G.PLAIN_GATES[name](x, y) for x, y in zip(BITS0, BITS1)]


@pytest.mark.parametrize("key", ["tiny_key", "tiny_k2_key"])
def test_lvl1_key_switch_with_one_ksk(key, request):
    """key_switch(x, natural KSK) == key_switch(x gathered by sei_perm,
    ksk_tiles), with int and per-row tensor pre-add constants."""
    sk, ek = request.getfixturevalue(key)
    p = sk.params
    d1 = p.lvl1.k * p.lvl1.n
    rng = np.random.default_rng(92)
    x = rng.integers(0, _MOD, (5, d1 + 1), dtype=np.uint64).astype(np.uint32)
    other = rng.integers(0, _MOD, (5, d1 + 1),
                         dtype=np.uint64).astype(np.uint32)
    off = (-p.lvl1.mu) % _MOD
    tkeys = TK.prepare_keys(ek, "cpu")
    perm = TK.sei_perm(p)
    assert np.array_equal(perm[perm], np.arange(d1))        # an involution
    assert np.array_equal(tkeys.sei_perm.numpy(), perm)
    jkeys = JK.prepare_keys(ek, backends=("conv",))
    u = lambda v: jnp.uint32(v % _MOD)                       # noqa: E731
    want = _np(JKS.key_switch(jnp.asarray(x), jkeys.ksk_limbs, p,
                              pre=(u(1), u(-1), u(off), jnp.asarray(other))))
    assert np.array_equal(want, _rows(
        lambda t, o: G.key_switch(t, ek, pre=(1, -1, off, o)), x, other))
    got = TKS.key_switch(from_u32(x), tkeys.ksk_tiles, p,
                         pre=(1, -1, off, from_u32(other)),
                         perm=tkeys.sei_perm)
    assert np.array_equal(to_u32(got), want)
    rows = torch.tensor([[1, -1, i32(off)]] * 5, dtype=torch.int32)
    for ca, cb, of in ((rows[:, 0], rows[:, 1], rows[:, 2]),
                       (rows[:, 0:1], rows[:, 1:2], rows[:, 2:3])):
        got = TKS.key_switch(from_u32(x), tkeys.ksk_tiles, p,
                             pre=(ca, cb, of, from_u32(other)),
                             perm=tkeys.sei_perm)
        assert np.array_equal(to_u32(got), want)
    plain = TKS.key_switch(from_u32(x), tkeys.ksk_tiles, p,
                           perm=tkeys.sei_perm)
    assert np.array_equal(to_u32(plain), _rows(lambda t: G.key_switch(t, ek),
                                               x))


@pytest.mark.parametrize("level", [0, 1])
def test_mux_and_nmux(level, setup):
    sk, ek, ctx, jctx = setup
    rng = np.random.default_rng(93 + level)
    c = encrypt_bits(BITSC, sk, rng, level=level, device="cpu")
    a = encrypt_bits(BITS0, sk, rng, level=level, device="cpu")
    b = encrypt_bits(BITS1, sk, rng, level=level, device="cpu")
    gold = G.mux_lvl0 if level == 0 else G.mux_lvl1
    for negate in (False, True):
        out = ctx.nmux(c, a, b) if negate else ctx.mux(c, a, b)
        got = to_u32(out.data)
        assert np.array_equal(got, _np(jctx.mux(_j(c), _j(a), _j(b),
                                                negate=negate).data))
        want = _rows(lambda x, y, z: gold(x, y, z, ek, negate=negate),
                     to_u32(c.data), to_u32(a.data), to_u32(b.data))
        assert np.array_equal(got, want)
        plain = [y if x else z for x, y, z in zip(BITSC, BITS0, BITS1)]
        assert decrypt_bits(out, sk).tolist() == \
            [1 - v if negate else v for v in plain]


def test_not_and_copy(setup):
    sk, ek, ctx, jctx = setup
    for level in (0, 1):
        a = encrypt_bits(BITS0, sk, np.random.default_rng(95), level=level,
                         device="cpu")
        got = ctx.not_(a)
        assert got.level == level
        assert np.array_equal(to_u32(got.data), _np(jctx.not_(_j(a)).data))
        assert np.array_equal(to_u32(got.data),
                              _rows(G.not_gate, to_u32(a.data)))
        assert decrypt_bits(got, sk).tolist() == [1 - v for v in BITS0]
        assert np.array_equal(to_u32(ctx.copy(a).data), to_u32(a.data))


@pytest.mark.parametrize("level", [0, 1])
def test_gate_rows_matches_jax(level, setup):
    """Ten gates as [10, 3] rows tiled gate-major over a batch of 20."""
    sk, ek, ctx, jctx = setup
    mu = ctx._mu(level)
    names = list(TWO_INPUT)
    rows = TB.encode_gate_consts_rows(names, mu)
    jrows = JB.encode_gate_consts_rows(names, mu)
    assert rows.dtype == torch.int32
    assert np.array_equal(to_u32(rows), jrows)
    rng = np.random.default_rng(96 + level)
    bits0, bits1 = rng.integers(0, 2, 20), rng.integers(0, 2, 20)
    a = encrypt_bits(bits0, sk, rng, level=level, device="cpu")
    b = encrypt_bits(bits1, sk, rng, level=level, device="cpu")
    out = ctx.gate_rows(rows, a, b)
    got = to_u32(out.data)
    assert np.array_equal(got, _np(jctx.gate_rows(jrows, _j(a), _j(b)).data))
    assert np.array_equal(to_u32(ctx.gate_rows(jrows, a, b).data), got)
    gold = G.gate_lvl0 if level == 0 else G.gate_lvl1
    per_row = [names[r // 2] for r in range(20)]
    want = np.stack([gold(nm, x, y, ek) for nm, x, y in
                     zip(per_row, to_u32(a.data), to_u32(b.data))])
    assert np.array_equal(got, want)
    assert decrypt_bits(out, sk).tolist() == \
        [G.PLAIN_GATES[nm](x, y) for nm, x, y in zip(per_row, bits0, bits1)]


def test_gate_chain_matches_jax_and_looped_gates(setup):
    sk, ek, ctx, jctx = setup
    rng = np.random.default_rng(98)
    a = encrypt_bits(rng.integers(0, 2, 8), sk, rng, device="cpu")
    b = encrypt_bits(rng.integers(0, 2, 8), sk, rng, device="cpu")
    mixed = ["nand", "xor", "andyn", "orny"]
    for names in (["nand"] * 3, mixed):
        cur = a
        for nm in names:
            cur = ctx.gate(nm, cur, b)
        if len(set(names)) == 1:
            fused = ctx.gate_chain(names[0], a, b, depth=len(names))
            jfused = jctx.gate_chain(names[0], _j(a), _j(b), len(names))
        else:
            fused = ctx.gate_chain(names, a, b)
            jfused = jctx.gate_chain(names, _j(a), _j(b))
        assert np.array_equal(to_u32(fused.data), to_u32(cur.data))
        assert np.array_equal(to_u32(fused.data), _np(jfused.data))


def test_gate_chain_lvl1_mixed(setup):
    sk, ek, ctx, jctx = setup
    rng = np.random.default_rng(99)
    bits0, bits1 = [0, 1, 1, 0], [1, 1, 0, 0]
    a = encrypt_bits(bits0, sk, rng, level=1, device="cpu")
    b = encrypt_bits(bits1, sk, rng, level=1, device="cpu")
    names = ["xor", "nand"]
    out = ctx.gate_chain(names, a, b)
    gold, want = to_u32(a.data), np.array(bits0)
    for nm in names:
        gold = _rows(lambda x, y: G.gate_lvl1(nm, x, y, ek), gold,
                     to_u32(b.data))
        want = np.array([G.PLAIN_GATES[nm](x, y)
                         for x, y in zip(want, bits1)])
    assert out.level == 1 and np.array_equal(to_u32(out.data), gold)
    assert decrypt_bits(out, sk).tolist() == want.tolist()


def test_cmux_matches_jax(setup):
    sk, ek, ctx, jctx = setup
    p = sk.params
    lp = p.lvl1
    rng = np.random.default_rng(100)
    for sel in (0, 1):
        tg = G.trgsw_encrypt(sel, lp, sk.lvl1, rng)
        c1 = np.stack([G.trlwe_encrypt_zero(lp, sk.lvl1, rng)
                       for _ in range(2)])
        c0 = np.stack([G.trlwe_encrypt_zero(lp, sk.lvl1, rng)
                       for _ in range(2)])
        dev = ctx.prepare_trgsw(tg)
        jdev = JK.prepare_trgsw(tg, p)
        assert np.array_equal(dev.numpy(), _np(jdev["limbs"]))
        got = ctx.cmux(dev, TrlweCtxt(from_u32(c1)), TrlweCtxt(from_u32(c0)))
        want = _np(JB.cmux(jdev, jnp.asarray(c1), jnp.asarray(c0), p))
        assert np.array_equal(to_u32(got.data), want)
        assert np.array_equal(want, _rows(lambda x, y: G.cmux(tg, x, y, lp),
                                          c1, c0))


def test_refresh_bootstrap_and_extract(setup, jkeys):
    sk, ek, ctx, jctx = setup
    p = sk.params
    lp = p.lvl1
    rng = np.random.default_rng(101)
    tr = np.stack([G.trlwe_encrypt_zero(lp, sk.lvl1, rng) for _ in range(2)])
    got = ctx.refresh(TrlweCtxt(from_u32(tr)))
    want = _np(JB.refresh(jnp.asarray(tr), jkeys, p))
    assert np.array_equal(to_u32(got.data), want)
    assert np.array_equal(want, _rows(lambda t: G.refresh(t, ek), tr))
    ext = ctx.sample_extract_and_keyswitch(got)
    assert ext.level == 0
    assert np.array_equal(to_u32(ext.data), _rows(
        lambda t: G.sei_and_ks(t, ek), want))
    ct = encrypt_bits(BITS0, sk, rng, device="cpu")
    for mu in (None, 1 << 28):
        b2t = ctx.bootstrap_tlwe2trlwe(ct, mu)
        m = lp.mu if mu is None else mu
        jb2t = _np(JB.bootstrap_tlwe2trlwe(jnp.asarray(to_u32(ct.data)), m,
                                           jkeys, p))
        assert np.array_equal(to_u32(b2t.data), jb2t)
        assert np.array_equal(jb2t, _rows(
            lambda t: G.bootstrap_tlwe2trlwe(t, m, ek), to_u32(ct.data)))
    # extract + key switch of the bootstrapped TRLWE decrypts to the bits
    assert decrypt_bits(ctx.sample_extract_and_keyswitch(
        ctx.bootstrap_tlwe2trlwe(ct)), sk).tolist() == BITS0


def test_programmable_bootstrap(setup, jkeys):
    sk, ek, ctx, jctx = setup
    p = sk.params
    lp = p.lvl1
    rng = np.random.default_rng(102)
    ct = encrypt_bits([0, 1, 1], sk, rng, device="cpu")
    cts = to_u32(ct.data)
    tv = rng.integers(0, _MOD, lp.n, dtype=np.uint64).astype(np.uint32)
    got = ctx.programmable_bootstrap(ct, tv)
    want = _np(JB.programmable_bootstrap(jnp.asarray(cts), jnp.asarray(tv),
                                         jkeys, p))
    assert got.level == 0 and np.array_equal(to_u32(got.data), want)
    assert np.array_equal(want, _rows(
        lambda t: G.programmable_bootstrap(t, tv, ek), cts))
    # a test vector per row ([B, N]) and a tensor test vector
    tvs = rng.integers(0, _MOD, (3, lp.n), dtype=np.uint64).astype(np.uint32)
    got = ctx.pbs_tlwe2trlwe(ct, from_u32(tvs))
    want = _np(JB.pbs_tlwe2trlwe(jnp.asarray(cts), jnp.asarray(tvs), jkeys,
                                 p))
    assert np.array_equal(to_u32(got.data), want)
    # the constant-mu test vector is the plain bootstrap
    tv_mu = np.full(lp.n, lp.mu, dtype=np.uint32)
    assert np.array_equal(to_u32(ctx.pbs_tlwe2trlwe(ct, tv_mu).data),
                          to_u32(ctx.bootstrap_tlwe2trlwe(ct).data))


def test_mod_switch_round_matches_golden():
    rng = np.random.default_rng(103)
    x = np.concatenate([rng.integers(0, _MOD, 200, dtype=np.uint64),
                        [0, 1, _MOD - 1, 1 << 31, (1 << 31) - 1]]
                       ).astype(np.uint32)
    for nbit in (5, 6, 10):
        for theta in (0, 1, 2, 3):
            got = to_u32(TB._mod_switch_round(from_u32(x), nbit, theta))
            want = [G.mod_switch_round(int(v), nbit, theta) for v in x]
            assert got.tolist() == want
            assert int(got.max()) < 2 << nbit


@pytest.mark.parametrize("theta", [0, 1, 2])
@pytest.mark.parametrize("key", ["tiny_key", "tiny_k2_key"])
def test_pbs_many(theta, key, request):
    sk, ek = request.getfixturevalue(key)
    p = sk.params
    J = 1 << theta
    rng = np.random.default_rng(104 + theta)
    cts = G.encrypt_bit_batch([0, 1, 1, 0], sk, rng)
    tv = rng.integers(0, _MOD, p.lvl1.n, dtype=np.uint64).astype(np.uint32)
    tkeys = TK.prepare_keys(ek, "cpu")
    got = TB.pbs_many(from_u32(cts), from_u32(tv), J, tkeys, p, theta=theta)
    assert tuple(got.shape) == (J, 4, p.lvl0.dim + 1)
    want = np.stack([G.pbs_many(c, tv, J, ek, theta=theta) for c in cts],
                    axis=1)
    assert np.array_equal(to_u32(got), want)
    if key == "tiny_key":
        jkeys = JK.prepare_keys(ek, backends=("conv",))
        jgot = _np(JB.pbs_many(jnp.asarray(cts), jnp.asarray(tv), J, jkeys,
                               p, "conv", theta=theta))
        assert np.array_equal(to_u32(got), jgot)
    acc = TB.blind_rotate_tv(from_u32(cts[:, :-1]), from_u32(cts[:, -1]),
                             from_u32(tv), tkeys, p, theta=theta)
    assert np.array_equal(to_u32(acc), np.stack(
        [G.blind_rotate_tv_many(c, tv, ek, theta) for c in cts]))


def test_context_checks(setup):
    sk, ek, ctx, jctx = setup
    rng = np.random.default_rng(105)
    a = encrypt_bits(BITS0, sk, rng, device="cpu")
    b1 = encrypt_bits(BITS1, sk, rng, level=1, device="cpu")
    with pytest.raises(ValueError, match="share a level"):
        ctx.gate("nand", a, b1)
    with pytest.raises(ValueError, match="share a level"):
        ctx.mux(a, a, b1)
    with pytest.raises(ValueError, match="dividing the batch"):
        ctx.gate_rows(TB.encode_gate_consts_rows(["nand"] * 3, 1), a, a)
    with pytest.raises(ValueError, match="depth is required"):
        ctx.gate_chain("nand", a, a)
    with pytest.raises(ValueError, match="unknown gate"):
        ctx.gate_chain(["nand", "nope"], a, a)
    with pytest.raises(ValueError, match="TRGSW must be"):
        ctx.prepare_trgsw(np.zeros((2, 2, sk.params.lvl1.n), np.uint32))
    with pytest.raises(ValueError, match="theta"):
        TB.pbs_many(a.data, torch.zeros(sk.params.lvl1.n, dtype=torch.int32),
                    3, ctx.keys, sk.params, theta=1)
