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
    a = encrypt_bits(BITS0, sk, rng, device="cpu")
    b = encrypt_bits(BITS1, sk, rng, device="cpu")
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
    """A CPU mesh context evaluates the gate, equal to the unsharded one,
    and refuses a batch that does not divide; unknown gates, ragged
    batches and mixed levels are refused."""
    from cufhe_tpu_torch.parallel import data_mesh
    sk, ek, ctx, jctx, a, b = setup
    mesh_ctx = Context(ek, mesh=data_mesh(["cpu"] * 2))
    assert mesh_ctx.device.type == "cpu" and mesh_ctx.mesh.size == 2
    assert torch.equal(mesh_ctx.nand(a, b).data, ctx.nand(a, b).data)
    with pytest.raises(ValueError, match="divisible"):
        mesh_ctx.nand(Ctxt(a.data[:3], 0), Ctxt(b.data[:3], 0))
    with pytest.raises(ValueError, match="unknown gate"):
        ctx.gate("nope", a, b)
    with pytest.raises(ValueError, match="batches differ"):
        ctx.nand(a, Ctxt(b.data[:2], 0))
    with pytest.raises(ValueError, match="share a level"):
        ctx.gate("nand", Ctxt(a.data, 1), b)


@pytest.mark.parametrize("fn", ["Context", "encrypt_bits", "prepare_keys",
                                "prepare_trgsw", "make_operands"])
def test_public_entry_points_default_to_the_card(fn):
    """Keys, ciphertexts and the probe's operands land on the card unless
    the caller asks for the CPU, so Context(ek).nand(encrypt_bits(x, sk),
    ...) needs no device argument (the GPU tests run it)."""
    import inspect

    import cufhe_tpu_torch as T
    from cufhe_tpu_torch.benchmarks import mxu_peak as TM
    from cufhe_tpu_torch.ops import keys as TK
    obj = getattr(T, fn, None) or getattr(TK, fn, None) or getattr(TM, fn)
    assert inspect.signature(obj).parameters["device"].default == "cuda"


@pytest.mark.parametrize("backend", ["auto", "pallas", "conv", "toeplitz"])
def test_context_takes_the_reference_backend_names(backend, setup):
    """Context(ek, backend, mesh, *, device) in the JAX package's order:
    every exact backend name runs the one exact path, kept as given."""
    sk, ek, ctx, jctx, a, b = setup
    named = Context(ek, backend, device="cpu")
    assert named.backend == backend and named.device.type == "cpu"
    assert torch.equal(named.nand(a, b).data, ctx.nand(a, b).data)
    assert Context(ek, backend=backend, device="cpu").backend == backend
    assert ctx.backend == "auto"


def test_context_refuses_unported_and_unknown_backends(tiny_key):
    """"ntt" builds a context holding only the ntt key form; the
    reduced-precision pallas3 and unknown names are refused."""
    _, ek = tiny_key
    ntt = Context(ek, "ntt", device="cpu")
    assert ntt.backend == "ntt" and ntt.keys.bk_ntt.numel() > 0
    assert ntt.keys.bk_ext.numel() == 0
    with pytest.raises(NotImplementedError, match="reduced precision"):
        Context(ek, backend="pallas3", device="cpu")
    for name in ("cuda", "cpu", "definitely-not-a-backend"):
        with pytest.raises(ValueError, match="unknown backend"):
            Context(ek, name, device="cpu")


def test_encrypt_bits_level_is_the_fourth_argument(tiny_key):
    """encrypt_bits(bits, sk, rng, level) as in the JAX package: a fourth
    positional 1 is the level, and device is keyword-only."""
    sk, _ = tiny_key
    ct = encrypt_bits(BITS0, sk, np.random.default_rng(91), 1,
                      device="cpu")
    want = JA.encrypt_bits(BITS0, sk, np.random.default_rng(91), 1)
    assert ct.level == want.level == 1 and ct.data.device.type == "cpu"
    assert np.array_equal(to_u32(ct.data), np.asarray(want.data))
    assert ct.data.shape == (4, sk.params.lvl1.k * sk.params.lvl1.n + 1)
    assert decrypt_bits(ct, sk).tolist() == BITS0
    with pytest.raises(TypeError):
        encrypt_bits(BITS0, sk, None, 0, "cpu")
