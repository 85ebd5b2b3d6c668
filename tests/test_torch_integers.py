"""cufhe_tpu_torch.models.integers on the CPU against
cufhe_tpu.models.integers (JAX, backend="conv"): the LUT polynomials,
encryption, and every arithmetic path at msg_bits 1 (TINY) and 2
(TINY_Q) on the same ciphertexts, as uint32 equality; the rest decrypted
against plain integers. Blind rotations are counted (one per pbs_many
call) against the counts the GPU smoke test asserts."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cufhe_tpu import golden as JG
from cufhe_tpu import params as JP
from cufhe_tpu.models import api as JA
from cufhe_tpu.models import integers as JI
from cufhe_tpu_torch import Context, Ctxt, decrypt_bits, encrypt_bits
from cufhe_tpu_torch import golden as G
from cufhe_tpu_torch.models import integers as TI
from cufhe_tpu_torch.ops import blind_rotate as BR
from cufhe_tpu_torch.torus import to_u32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Intra-op threads off while this module runs: the suite runs several
    worker processes on the same cores, where torch's thread pool spends
    its time waiting for its own threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keys(params, seed):
    sk = JG.keygen(params, seed=seed)
    return sk, JG.make_eval_key(sk, seed=seed + 1)


@pytest.fixture(scope="module")
def m1():
    """TINY keys and the port's msg_bits-1 IntContext on the CPU."""
    sk, ek = _keys(JP.TINY, 21)
    return sk, ek, TI.IntContext(Context(ek, device="cpu"))


@pytest.fixture(scope="module")
def m2():
    """TINY_Q keys (radix-4's margin needs its quieter key switch)."""
    return _keys(JP.TINY_Q, 25)


@pytest.fixture
def rotations(monkeypatch):
    """Counts blind rotations (one per pbs_many / bootstrap call)."""
    count = [0]
    orig = BR.blind_rotate

    def counting(*args, **kwargs):
        count[0] += 1
        return orig(*args, **kwargs)
    monkeypatch.setattr(BR, "blind_rotate", counting)
    return count


def _enc(values, bits, sk, codec=TI.IntCodec(), seed=0, signed=False):
    fn = TI.encrypt_int if signed else TI.encrypt_uint
    return fn(values, bits, sk, codec, rng=np.random.default_rng(seed),
              device="cpu")


def _jax(x: TI.IntCtxt) -> JI.IntCtxt:
    c = x.codec
    return JI.IntCtxt(jnp.asarray(to_u32(x.digits)),
                      JI.IntCodec(c.msg_bits, c.buf_bits))


def _same(got: torch.Tensor, want) -> None:
    assert got.dtype == torch.int32
    assert np.array_equal(to_u32(got), np.asarray(want))


def _digits(v):
    return getattr(v, "digits", getattr(v, "data", v))


@pytest.mark.parametrize("J,buf_bits,N", [(1, 2, 64), (2, 2, 64),
                                          (3, 4, 512)])
def test_build_tv_equals_original(J, buf_bits, N):
    rng = np.random.default_rng(J)
    outs = [rng.integers(0, 1 << 32, 1 << buf_bits,
                         dtype=np.uint64).astype(np.uint32)
            for _ in range(J)]
    got = TI.build_tv(outs, buf_bits, N)
    assert got.dtype == np.uint32
    assert np.array_equal(got, JI.build_tv(outs, buf_bits, N))


@pytest.mark.parametrize("preset,msg_bits,buf_bits",
                         [("tiny-insecure-test", 1, None),
                          ("tiny-quiet-ks-insecure-test", 2, None),
                          ("tiny-quiet-ks-insecure-test", 2, 4)])
def test_lut_polynomials_equal_original(preset, msg_bits, buf_bits):
    """Every _tv_* polynomial of the port's IntContext, as uint32, equals
    the JAX IntContext's (and _tv_mul is absent in both without carry
    space)."""
    _, ek = _keys(JP.PRESETS[preset], 30)
    ours = TI.IntContext(Context(ek, device="cpu"),
                         TI.IntCodec(msg_bits, buf_bits))
    theirs = JI.IntContext(JA.Context(ek, backend="conv"),
                           JI.IntCodec(msg_bits, buf_bits))
    names = [n for n in vars(theirs) if n.startswith("_tv_")]
    assert names == [n for n in vars(ours) if n.startswith("_tv_")]
    assert len(names) == (10 if msg_bits == 1 else 11)
    for name in names:
        want = getattr(theirs, name)
        if want is None:
            assert getattr(ours, name) is None, name
        else:
            _same(getattr(ours, name), want)


def test_encrypt_and_decrypt_equal_original(m1):
    sk, _, _ = m1
    for codec, bits, vals in ((TI.IntCodec(), 8, [3, 200, 255, 0]),
                              (TI.IntCodec(2), 8, [123, 250, 7, 64])):
        x = _enc(vals, bits, sk, codec, seed=5)
        jx = JI.encrypt_uint(vals, bits, sk,
                             JI.IntCodec(codec.msg_bits, codec.buf_bits),
                             rng=np.random.default_rng(5))
        _same(x.digits, jx.digits)
        assert x.digits.shape == (4, codec.digits_for(bits), 17)
        assert TI.decrypt_uint(x, sk) == JI.decrypt_uint(jx, sk) == vals
        phases = TI.digit_phases(x, sk)
        for row, prow in zip(to_u32(x.digits), phases):
            for ct, ph in zip(row, prow):
                assert ph == G.tlwe_phase(ct, sk.lvl0) == \
                    JG.tlwe_phase(ct, sk.lvl0)
    signed = [-3, 7, -8, 5]
    x = _enc(signed, 4, sk, seed=6, signed=True)
    jx = JI.encrypt_int(signed, 4, sk, rng=np.random.default_rng(6))
    _same(x.digits, jx.digits)
    assert TI.decrypt_int(x, sk) == JI.decrypt_int(jx, sk) == signed
    with pytest.raises(ValueError, match="out of range"):
        TI.encrypt_int([8], 4, sk, device="cpu")


#: 4-bit operands at msg_bits 1: equal words, a carry out, a zero divisor
XS, YS = [13, 7, 9, 15], [3, 7, 0, 1]
#: rotations of each op at D = 4 digits (int_launches in chip_smoke.py)
M1_ROTATIONS = {"add_full": 4, "sub_full": 4, "eq": 3, "select": 2,
                "mul": 36, "divmod_": 24}


@pytest.mark.parametrize("op", sorted(M1_ROTATIONS))
def test_m1_equals_original(op, m1, rotations):
    """One op on the same ciphertexts through the port and the JAX
    package: equal as uint32, decrypted against plain integers, with the
    port's rotation count."""
    sk, ek, ictx = m1
    x, y = _enc(XS, 4, sk, seed=7), _enc(YS, 4, sk, seed=8)
    jctx = JI.IntContext(JA.Context(ek, backend="conv"))
    if op == "select":
        cond = encrypt_bits([1, 0, 0, 1], sk, np.random.default_rng(9),
                            device="cpu")
        got = ictx.select(cond, x, y)
        want = jctx.select(JA.Ctxt(jnp.asarray(to_u32(cond.data)), 0),
                           _jax(x), _jax(y))
    else:
        got = getattr(ictx, op)(x, y)
        want = getattr(jctx, op)(_jax(x), _jax(y))
    assert rotations[0] == M1_ROTATIONS[op]
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        _same(_digits(g), _digits(w))
    plain = {"add_full": [(a + b) % 16 for a, b in zip(XS, YS)],
             "sub_full": [(a - b) % 16 for a, b in zip(XS, YS)],
             "select": [XS[0], YS[1], YS[2], XS[3]],
             "mul": [a * b for a, b in zip(XS, YS)],
             "divmod_": [a // b if b else 15 for a, b in zip(XS, YS)]}
    if op == "eq":
        assert decrypt_bits(got[0], sk).tolist() == \
            [int(a == b) for a, b in zip(XS, YS)]
        return
    assert TI.decrypt_uint(got[0], sk) == plain[op]
    if op in ("add_full", "sub_full"):
        flag = decrypt_bits(ictx.digit_to_bool(got[1]), sk).tolist()
        assert flag == ([int(a + b > 15) for a, b in zip(XS, YS)]
                        if op == "add_full"
                        else [int(a >= b) for a, b in zip(XS, YS)])
    if op == "divmod_":
        assert TI.decrypt_uint(got[1], sk) == \
            [a % b if b else a for a, b in zip(XS, YS)]
    if op == "mul":
        assert got[0].bits == 8


@pytest.mark.parametrize("op", ["add", "mul", "divmod_"])
def test_m2_equals_original(op, m2):
    """Radix-4 digits at TINY_Q, 4-bit words: add, the bivariate-LUT
    multiplier (IntCodec(2, 4)), and the radix-4 divide, whose quotient
    digit and next remainder are int32 sums that must wrap mod 2^32."""
    sk, ek = m2
    codec = TI.IntCodec(2, 4) if op == "mul" else TI.IntCodec(2)
    xs, ys = [13, 9], [11, 2]
    x, y = _enc(xs, 4, sk, codec, 10), _enc(ys, 4, sk, codec, 11)
    ictx = TI.IntContext(Context(ek, device="cpu"), codec)
    jctx = JI.IntContext(JA.Context(ek, backend="conv"),
                         JI.IntCodec(codec.msg_bits, codec.buf_bits))
    got = getattr(ictx, op)(x, y)
    want = getattr(jctx, op)(_jax(x), _jax(y))
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        _same(g.digits, w.digits)
    plain = {"add": ([(a + b) % 16 for a, b in zip(xs, ys)],),
             "mul": ([a * b for a, b in zip(xs, ys)],),
             "divmod_": ([a // b for a, b in zip(xs, ys)],
                         [a % b for a, b in zip(xs, ys)])}[op]
    assert [TI.decrypt_uint(g, sk) for g in got] == list(plain)


def test_m2_mul_needs_carry_space(m2):
    sk, ek = m2
    ictx = TI.IntContext(Context(ek, device="cpu"), TI.IntCodec(2))
    x = _enc([3, 2], 4, sk, ictx.codec, 12)
    with pytest.raises(ValueError, match="buf_bits"):
        ictx.mul(x, x)


def test_scalars_neg_and_comparisons(m1):
    sk, _, ictx = m1
    x = _enc([100, 5, 7, 0], 8, sk, seed=13)
    y = _enc([5, 100, 7, 255], 8, sk, seed=14)
    assert TI.decrypt_uint(ictx.add_scalar(x, 200), sk) == [44, 205, 207, 200]
    assert TI.decrypt_uint(ictx.sub_scalar(x, 7), sk) == [93, 254, 0, 249]
    assert TI.decrypt_uint(ictx.neg(x), sk) == [156, 251, 249, 0]
    assert decrypt_bits(ictx.ge(x, y), sk).tolist() == [1, 0, 1, 0]
    assert decrypt_bits(ictx.lt(x, y), sk).tolist() == [0, 1, 0, 1]
    assert decrypt_bits(ictx.eq_scalar(x, 7), sk).tolist() == [0, 0, 1, 0]
    assert TI.decrypt_uint(ictx.min_(x, y), sk) == [5, 5, 7, 0]
    assert TI.decrypt_uint(ictx.max_(x, y), sk) == [100, 100, 7, 255]


def test_signed_compare_min_max_abs(m1):
    sk, _, ictx = m1
    xs, ys = [-3, 7, -8, 5], [2, -7, -8, 6]
    x = _enc(xs, 4, sk, seed=15, signed=True)
    y = _enc(ys, 4, sk, seed=16, signed=True)
    assert decrypt_bits(ictx.ge_signed(x, y), sk).tolist() == \
        [int(a >= b) for a, b in zip(xs, ys)]
    assert decrypt_bits(ictx.lt_signed(x, y), sk).tolist() == \
        [int(a < b) for a, b in zip(xs, ys)]
    assert TI.decrypt_int(ictx.min_signed(x, y), sk) == \
        [min(a, b) for a, b in zip(xs, ys)]
    assert TI.decrypt_int(ictx.max_signed(x, y), sk) == \
        [max(a, b) for a, b in zip(xs, ys)]
    assert TI.decrypt_int(ictx.abs_(x), sk) == [3, 7, -8, 5]   # -8 wraps
    assert TI.decrypt_int(ictx.add(x, y), sk) == \
        [(a + b + 8) % 16 - 8 for a, b in zip(xs, ys)]


def test_m2_signed_compare(m2):
    """msg_bits 2 flips the top bit of the top digit with a rotation."""
    sk, ek = m2
    codec = TI.IntCodec(2)
    ictx = TI.IntContext(Context(ek, device="cpu"), codec)
    xs, ys = [-3, 7], [2, -7]
    x = _enc(xs, 4, sk, codec, 17, signed=True)
    y = _enc(ys, 4, sk, codec, 18, signed=True)
    assert decrypt_bits(ictx.ge_signed(x, y), sk).tolist() == [0, 1]


def test_lut_bool_bridge_and_digit_shift(m1):
    sk, _, ictx = m1
    x = _enc([0b1011, 0b0110], 4, sk, seed=19)
    assert TI.decrypt_uint(ictx.apply_lut(x, [1, 0]), sk) == [0b0100,
                                                              0b1001]
    b = ictx.digit_to_bool(x.digits[:, 0])
    assert b.level == 0 and decrypt_bits(b, sk).tolist() == [1, 0]
    back = ictx.bool_to_digit(b)
    assert back.shape == (2, 17)
    assert decrypt_bits(ictx.digit_to_bool(back), sk).tolist() == [1, 0]
    x = _enc([0b0110, 0b1001], 4, sk, seed=20)
    assert TI.decrypt_uint(ictx.shift_digits(x, 1), sk) == [0b1100, 0b0010]
    assert TI.decrypt_uint(ictx.shift_digits(x, -2), sk) == [0b0001,
                                                             0b0010]
    assert TI.decrypt_uint(ictx.shift_digits(x, 5), sk) == [0, 0]
    with pytest.raises(ValueError, match="entries"):
        ictx.apply_lut(x, [1, 0, 1])


@pytest.mark.parametrize("msg_bits", [1, 2])
def test_encrypted_shifts_with_saturating_tail(msg_bits, m1, m2):
    """Barrel shifts by encrypted amounts; amount bits past the word width
    collapse into the OR-tree saturation (35 and 16 set only high bits at
    m=1; 6 and 9 at m=2)."""
    if msg_bits == 1:
        sk, _, ictx = m1
        xs, amts, abits = [0b0110, 0b1001, 0b1111, 0b0001], [1, 35, 16, 3], 6
    else:
        sk, ek = m2
        ictx = TI.IntContext(Context(ek, device="cpu"), TI.IntCodec(2))
        xs, amts, abits = [0b0110, 0b1001, 0b1011], [1, 6, 3], 4
    x = _enc(xs, 4, sk, ictx.codec, 21)
    a = _enc(amts, abits, sk, ictx.codec, 22)
    left = ictx.shift_left(x, a)
    assert TI.decrypt_uint(left, sk) == [(v << s) & 0xF if s < 4 else 0
                                         for v, s in zip(xs, amts)]
    right = ictx.shift_right(x, a)
    assert TI.decrypt_uint(right, sk) == [v >> s if s < 4 else 0
                                          for v, s in zip(xs, amts)]


def test_divmod_segmented_bitexact(m1, monkeypatch):
    """The divide cut into calls of 3 + 1 quotient digits (segment=, or
    CUFHE_DIV_SEG) is bit-identical to the whole divide."""
    sk, _, ictx = m1
    xs, ys = [13, 7, 9, 15, 11, 0], [3, 2, 4, 1, 12, 5]
    x, y = _enc(xs, 4, sk, seed=23), _enc(ys, 4, sk, seed=24)
    q1, r1 = ictx.divmod_(x, y)
    q3, r3 = ictx.divmod_(x, y, segment=3)
    monkeypatch.setenv("CUFHE_DIV_SEG", "3")
    qe, re_ = ictx.divmod_(x, y)
    for a, b, c in ((q1, q3, qe), (r1, r3, re_)):
        assert torch.equal(a.digits, b.digits)
        assert torch.equal(a.digits, c.digits)
    assert TI.decrypt_uint(q3, sk) == [a // b for a, b in zip(xs, ys)]
    assert TI.decrypt_uint(r3, sk) == [a % b for a, b in zip(xs, ys)]
    assert ictx.div(x, y).digits.shape == ictx.mod(x, y).digits.shape


def test_operand_checks_and_released_keys(m1):
    sk, ek, _ = m1
    ictx = TI.IntContext(Context(ek, device="cpu"))
    x = _enc([1, 2], 4, sk, seed=25)
    with pytest.raises(ValueError, match="mismatch"):
        ictx.add(x, _enc([1, 2], 8, sk, seed=26))
    with pytest.raises(ValueError, match="codec"):
        ictx.add(_enc([1, 2], 4, sk, TI.IntCodec(2), 27),
                 _enc([1, 2], 4, sk, TI.IntCodec(2), 28))
    with pytest.raises(ValueError, match="batch"):
        ictx.shift_left(x, _enc([1], 2, sk, seed=29))
    with pytest.raises(ValueError, match="buf_bits"):
        TI.IntCodec(2, 2)
    ictx.ctx.release_keys()
    with pytest.raises(ValueError, match="release_keys"):
        ictx.add(x, x)
    with pytest.raises(ValueError, match="release_keys"):
        ictx.bool_to_digit(Ctxt(x.digits[:, 0], 0))
