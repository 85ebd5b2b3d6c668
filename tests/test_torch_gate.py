"""cufhe_tpu_torch Context gates on the CPU against cufhe_tpu.models.api
(JAX) and golden.gate_lvl0, as uint32 equality."""
import numpy as np
import pytest
import torch

from cufhe_tpu import golden as G
from cufhe_tpu.models import api as JA
from cufhe_tpu_torch import Context, Ctxt, decrypt_bits, encrypt_bits
from cufhe_tpu_torch.models.gates import TWO_INPUT
from cufhe_tpu_torch.torus import to_u32

BITS0 = [0, 1, 0, 1]
BITS1 = [0, 0, 1, 1]


@pytest.fixture(scope="module")
def setup(tiny_key):
    sk, ek = tiny_key
    rng = np.random.default_rng(90)
    a = encrypt_bits(BITS0, sk, rng)
    b = encrypt_bits(BITS1, sk, rng)
    return sk, ek, Context(ek, device="cpu"), JA.Context(ek), a, b


def test_all_ten_gates(setup):
    sk, ek, ctx, jctx, a, b = setup
    ja = JA.Ctxt(to_u32(a.data), 0)
    jb = JA.Ctxt(to_u32(b.data), 0)
    methods = {"nand": ctx.nand, "nor": ctx.nor, "xnor": ctx.xnor,
               "and": ctx.and_, "or": ctx.or_, "xor": ctx.xor,
               "andny": ctx.and_ny, "andyn": ctx.and_yn,
               "orny": ctx.or_ny, "oryn": ctx.or_yn}
    assert sorted(methods) == sorted(TWO_INPUT)
    for name in TWO_INPUT:
        out = methods[name](a, b)
        assert out.level == 0 and out.data.dtype == torch.int32
        got = to_u32(out.data)
        assert np.array_equal(got, np.asarray(jctx.gate(name, ja, jb).data))
        want = np.stack([G.gate_lvl0(name, x, y, ek) for x, y in
                         zip(to_u32(a.data), to_u32(b.data))])
        assert np.array_equal(got, want), name
        plain = G.PLAIN_GATES[name]
        assert decrypt_bits(out, sk).tolist() == \
            [plain(x, y) for x, y in zip(BITS0, BITS1)]


def test_nand_chain_five_deep(setup):
    sk, ek, ctx, jctx, a, b = setup
    out, jout = a, JA.Ctxt(to_u32(a.data), 0)
    jb = JA.Ctxt(to_u32(b.data), 0)
    gold = to_u32(a.data)
    want = np.array(BITS0)
    for _ in range(5):
        out = ctx.nand(out, b)
        jout = jctx.nand(jout, jb)
        gold = np.stack([G.gate_lvl0("nand", x, y, ek)
                         for x, y in zip(gold, to_u32(b.data))])
        want = 1 - (want & np.array(BITS1))
        assert np.array_equal(to_u32(out.data), np.asarray(jout.data))
        assert np.array_equal(to_u32(out.data), gold)
    assert decrypt_bits(out, sk).tolist() == want.tolist()


def test_unported_paths_raise(setup):
    sk, ek, ctx, jctx, a, b = setup
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ctx.mux(a, b, a)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ctx.gate_chain("nand", a, b, depth=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ctx.gate_rows(None, a, b)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ctx.nand(a, b, stream=object())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ctx.gate("nand", Ctxt(a.data, 1), Ctxt(b.data, 1))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Context(ek, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="unknown gate"):
        ctx.gate("nope", a, b)
    with pytest.raises(ValueError, match="batches differ"):
        ctx.nand(a, Ctxt(b.data[:2], 0))
