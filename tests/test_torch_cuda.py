"""cufhe_tpu_torch on a CUDA device: the blind-rotation kernel (at the tiny
presets and at every full preset) and both tensor-core probe kernels (wgmma
and mma.sync) against their plain PyTorch versions; the gates and mux at
both levels against the port's golden model; the executor against its CPU
run; gates chained across CUDA streams against the default stream; and the
key lifecycle's device memory. Results compare as uint32. Every test skips
without a CUDA device.

This file imports neither JAX nor the JAX package (the oracle is the
port's own golden.py and params.py), so it runs where only the port's
files are installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""
import functools

import numpy as np
import pytest
import torch

from cufhe_tpu_torch import Context, Ctxt, decrypt_bits, encrypt_bits
from cufhe_tpu_torch import golden as G
from cufhe_tpu_torch import params as P
from cufhe_tpu_torch.benchmarks import mxu_peak as MP
from cufhe_tpu_torch.models.gates import TWO_INPUT
from cufhe_tpu_torch.ops import blind_rotate as BR
from cufhe_tpu_torch.ops import keys as TK
from cufhe_tpu_torch.runtime import (Stream, build_ripple_adder,
                                     run_schedule, synchronize)
from cufhe_tpu_torch.runtime import executor as EX
from cufhe_tpu_torch.torus import from_u32, int_mm, to_u32

#: the published parameter sets, at full size
FULL_PRESETS = [P.TFHEPP_128, P.TFHEPP_128_BG8, P.TFHEPP_80, P.CGGI19,
                P.CONCRETE, P.RADIX4_2048]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _keys(params, seed):
    sk = G.keygen(params, seed=seed)
    return sk, G.make_eval_key(sk, seed=seed + 1)


def _random_inputs(params, rows, seed, device):
    rng = np.random.default_rng(seed)
    lp = params.lvl1
    acc = rng.integers(0, 1 << 32, (rows, lp.k + 1, lp.n), dtype=np.uint64)
    abar = rng.integers(0, 2 * lp.n, (params.n0, rows))
    return (from_u32(acc.astype(np.uint32), device),
            from_u32(abar.astype(np.uint32), device))


@functools.lru_cache(maxsize=None)
def _device_keys(params, seed):
    """Eval key prepared on the card, once per preset (tfhepp_128bit's
    key generation takes seconds)."""
    return TK.prepare_keys(_keys(params, seed)[1], torch.device("cuda"))


@pytest.mark.parametrize("rows", [1, 8, 129])            # ragged row tiles
@pytest.mark.parametrize("params", [P.PALLAS_TINY, P.PALLAS_TINY_K2,
                                    P.PALLAS_BG10, P.TINY, P.TINY_K2,
                                    P.TFHEPP_128],
                         ids=lambda p: p.name)
def test_cuda_kernel_matches_ref(params, rows, cuda):
    keys = _device_keys(params, 80)
    acc, abar = _random_inputs(params, rows, 81, cuda)
    before = BR.blind_rotate_cuda.launches
    got = BR.blind_rotate(acc, abar, keys.bk_ext, params)
    want = BR.blind_rotate_ref(acc, abar, keys.bk_ext, params)
    torch.cuda.synchronize()
    assert BR.blind_rotate_cuda.launches == before + 1
    assert torch.equal(got, want)
    if params.lvl1.n <= 128:          # the CPU's plain version too
        assert torch.equal(got.cpu(), BR.blind_rotate_ref(
            acc.cpu(), abar.cpu(), keys.bk_ext.cpu(), params))


def test_cuda_kernel_rejects_bad_inputs(cuda):
    params = P.TINY
    keys = _device_keys(params, 82)
    acc, abar = _random_inputs(params, 4, 83, cuda)
    with pytest.raises(ValueError, match="want"):
        BR.blind_rotate_cuda(acc.to(torch.int64), abar, keys.bk_ext, params)
    with pytest.raises(ValueError, match="contiguous"):
        BR.blind_rotate_cuda(acc.transpose(0, 1).contiguous().transpose(0, 1),
                             abar, keys.bk_ext, params)
    with pytest.raises(ValueError, match="CUDA device"):
        BR.blind_rotate_cuda(acc, abar.cpu(), keys.bk_ext, params)
    # limb sums up to I*N*2^(dbits-1)*128 = 6 * 2^15 * 2^14 >= 2^31 could
    # leave the tensor cores' int32 accumulators: the kernel refuses the set
    wide = P.GateParams(
        name="int32-bound", lvl0=P.LweParams(n=1),
        lvl1=P.TrlweParams(nbit=15, k=1, l=3, Bgbit=8), ks=P.KeySwitchParams())
    N = wide.lvl1.n
    before = BR.blind_rotate_cuda.launches
    with pytest.raises(RuntimeError, match="invalid argument"):
        BR.blind_rotate_cuda(
            torch.zeros((1, 2, N), dtype=torch.int32, device=cuda),
            torch.zeros((1, 1), dtype=torch.int32, device=cuda),
            torch.zeros((1, 6, 2, 4, 2 * N), dtype=torch.int8, device=cuda),
            wide)
    assert BR.blind_rotate_cuda.launches == before


def test_int_mm_cuda_shape_limits(cuda):
    """CUDA's torch._int_mm takes only M > 16 and K, N multiples of 8;
    torus.int_mm pads around that and stays exact at any shape."""
    def mm(M, K, N):
        return torch._int_mm(torch.ones((M, K), dtype=torch.int8, device=cuda),
                             torch.ones((K, N), dtype=torch.int8, device=cuda))
    assert int(mm(17, 8, 8)[0, 0]) == 8
    for M, K, N in [(16, 8, 8), (17, 12, 8), (17, 8, 12)]:
        with pytest.raises(RuntimeError):
            mm(M, K, N)
    rng = np.random.default_rng(86)
    for M, K, N in [(4, 637, 17), (1, 5, 7), (40, 64, 24)]:
        a = rng.integers(-128, 128, (M, K)).astype(np.int8)
        b = rng.integers(-128, 128, (K, N)).astype(np.int8)
        got = int_mm(torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda))
        assert np.array_equal(got.cpu().numpy(),
                              a.astype(np.int64) @ b.astype(np.int64))


@pytest.mark.parametrize("params", [P.TINY, P.PALLAS_BG10, P.TINY_K2],
                         ids=lambda p: p.name)
def test_cuda_gates_match_golden(params, cuda):
    sk, ek = _keys(params, 84)
    rng = np.random.default_rng(85)
    bits0, bits1 = [0, 1, 0, 1], [0, 0, 1, 1]
    a = encrypt_bits(bits0, sk, rng, device=cuda)
    b = encrypt_bits(bits1, sk, rng, device=cuda)
    ctx = Context(ek, device=cuda)
    for name in TWO_INPUT:
        out = ctx.gate(name, a, b)
        assert out.data.is_cuda
        want = np.stack([G.gate_lvl0(name, x, y, ek) for x, y in
                         zip(to_u32(a.data), to_u32(b.data))])
        assert np.array_equal(to_u32(out.data), want), name
        assert decrypt_bits(out, sk).tolist() == \
            [G.PLAIN_GATES[name](x, y) for x, y in zip(bits0, bits1)]


def _probe_matches_ref(variant, shape, instruction, device, seed=87):
    M, K, W, S, steps = shape
    A, X = MP.make_operands(np.random.default_rng(seed), variant, M, K, W,
                            S, device)
    before = dict(MP.mxu_peak_cuda.by_instruction)
    total = MP.mxu_peak_cuda.launches
    got = MP.mxu_peak_cuda(A, MP.prepare_x(X), variant, steps, instruction)
    want = MP.mxu_peak_ref(A, X, variant, steps)
    torch.cuda.synchronize()
    assert MP.mxu_peak_cuda.launches == total + 1
    for instr, n in MP.mxu_peak_cuda.by_instruction.items():
        assert n == before[instr] + (instr == instruction)
    assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.parametrize("variant", MP.VARIANTS)
@pytest.mark.parametrize("shape", [MP.SMALL, (2048, 1536, 512, 18, 1)],
                         ids=["small", "full-1step"])
def test_mxu_peak_kernel_matches_ref(variant, shape, cuda):
    """The mma.sync kernel (csrc/mxu_peak.cu)."""
    _probe_matches_ref(variant, shape, "mma_sync", cuda)


@pytest.mark.parametrize("variant", MP.VARIANTS)
@pytest.mark.parametrize("shape", [MP.SMALL, (2048, 1536, 512, 18, 1)],
                         ids=["small", "full-1step"])
def test_mxu_peak_wgmma_matches_ref(variant, shape, cuda):
    """The wgmma kernel (csrc/mxu_peak_wgmma.cu), the wrapper's default."""
    _probe_matches_ref(variant, shape, "wgmma", cuda)


@pytest.mark.parametrize("shape", [(2048, 1536, 1024, 9, 1),
                                   MP.K1_STEP[:4] + (1,)],
                         ids=["w1024", "k1step"])
def test_mxu_peak_wgmma_pure_at_probe_shapes(shape, cuda):
    _probe_matches_ref("pure", shape, "wgmma", cuda, seed=92)


def test_mxu_peak_wgmma_is_the_default(cuda):
    A, X = MP.make_operands(np.random.default_rng(93), "pure", *MP.SMALL[:4],
                            cuda)
    before = MP.mxu_peak_cuda.by_instruction["wgmma"]
    MP.mxu_peak_cuda(A, MP.prepare_x(X), "pure", 1)
    assert MP.mxu_peak_cuda.by_instruction["wgmma"] == before + 1


def test_mxu_peak_kernel_rejects_bad_inputs(cuda):
    A, X = MP.make_operands(np.random.default_rng(88), "pure", 128, 128, 64,
                            2, cuda)
    Xt = MP.prepare_x(X)
    with pytest.raises(ValueError, match="multiples"):
        MP.mxu_peak_cuda(A[:, :100].contiguous(), Xt, "pure", 1, "mma_sync")
    with pytest.raises(ValueError, match="want"):
        MP.mxu_peak_cuda(A, Xt, "bf16", 1, "mma_sync")
    with pytest.raises(ValueError, match="write needs"):
        A3, X3 = MP.make_operands(np.random.default_rng(89), "write", 128,
                                  128, 64, 4, cuda)
        MP.mxu_peak_cuda(A3, MP.prepare_x(X3), "write", 1, "mma_sync")


def test_mxu_peak_wgmma_rejects_bad_inputs(cuda):
    A, X = MP.make_operands(np.random.default_rng(94), "pure", 128, 128, 128,
                            2, cuda)
    Xt = MP.prepare_x(X)
    before = MP.mxu_peak_cuda.launches
    with pytest.raises(ValueError, match="CUDA device"):
        MP.mxu_peak_cuda(A.cpu(), Xt, "pure", 1)
    with pytest.raises(ValueError, match="want"):
        MP.mxu_peak_cuda(A, Xt, "bf16", 1)
    with pytest.raises(ValueError, match="want"):
        MP.mxu_peak_cuda(A.to(torch.int32), Xt, "pure", 1)
    with pytest.raises(ValueError, match="contiguous"):
        MP.mxu_peak_cuda(A.transpose(1, 2).contiguous().transpose(1, 2), Xt,
                         "pure", 1)
    # W = 64 is a multiple of the mma.sync tile, not of the wgmma one
    with pytest.raises(ValueError, match="wgmma: M, W, K bytes must be "
                                         "multiples"):
        MP.mxu_peak_cuda(A, Xt[:, :64].contiguous(), "pure", 1)
    with pytest.raises(ValueError, match="multiples"):
        MP.mxu_peak_cuda(A[:, :100].contiguous(), Xt, "pure", 1)
    with pytest.raises(ValueError, match="write needs"):
        A4, X4 = MP.make_operands(np.random.default_rng(95), "write", 128,
                                  128, 128, 4, cuda)
        MP.mxu_peak_cuda(A4, MP.prepare_x(X4), "write", 1)
    with pytest.raises(ValueError, match="instruction"):
        MP.mxu_peak_cuda(A, Xt, "pure", 1, "mma")
    assert MP.mxu_peak_cuda.launches == before


def test_default_devices_run_a_nand_on_the_card(cuda):
    """Context, encrypt_bits and prepare_keys default to the card: the
    plain use, with no device given anywhere, runs and decrypts right."""
    sk, ek = _keys(P.TINY, 96)
    rng = np.random.default_rng(97)
    ctx = Context(ek)
    a = encrypt_bits([0, 1, 0, 1], sk, rng)
    b = encrypt_bits([0, 0, 1, 1], sk, rng)
    assert a.data.is_cuda and ctx.keys.device.type == "cuda"
    assert TK.prepare_keys(ek).device.type == "cuda"
    out = ctx.nand(a, b)
    assert out.data.is_cuda
    assert decrypt_bits(out, sk).tolist() == [1, 1, 1, 0]


@pytest.mark.parametrize("params", [P.TINY, P.PALLAS_BG10, P.TINY_K2],
                         ids=lambda p: p.name)
def test_cuda_lvl1_gates_and_mux_match_golden(params, cuda):
    sk, ek = _keys(params, 90)
    rng = np.random.default_rng(91)
    bits0, bits1, bitsc = [0, 1, 0, 1], [0, 0, 1, 1], [0, 1, 1, 0]
    ctx = Context(ek, device=cuda)
    for level in (0, 1):
        a = encrypt_bits(bits0, sk, rng, device=cuda, level=level)
        b = encrypt_bits(bits1, sk, rng, device=cuda, level=level)
        c = encrypt_bits(bitsc, sk, rng, device=cuda, level=level)
        if level == 1:
            for name in TWO_INPUT:
                before = BR.blind_rotate_cuda.launches
                out = ctx.gate(name, a, b)
                assert BR.blind_rotate_cuda.launches == before + 1
                want = np.stack([G.gate_lvl1(name, x, y, ek) for x, y in
                                 zip(to_u32(a.data), to_u32(b.data))])
                assert np.array_equal(to_u32(out.data), want), name
        gold = G.mux_lvl0 if level == 0 else G.mux_lvl1
        for negate in (False, True):
            before = BR.blind_rotate_cuda.launches
            out = ctx.mux(c, a, b, negate=negate)
            assert BR.blind_rotate_cuda.launches == before + 2
            want = np.stack([gold(x, y, z, ek, negate=negate) for x, y, z in
                             zip(to_u32(c.data), to_u32(a.data),
                                 to_u32(b.data))])
            assert np.array_equal(to_u32(out.data), want)
            plain = [y if x else z for x, y, z in zip(bitsc, bits0, bits1)]
            assert decrypt_bits(out, sk).tolist() == \
                [1 - v if negate else v for v in plain]


def _random_bk_ext(params, seed, device):
    """The kernel's key layout of a random BK [n0, (k+1)l, k+1, N] (no key
    generation: parity needs only the layout)."""
    lp = params.lvl1
    bk = np.random.default_rng(seed).integers(
        0, 1 << 32, (params.n0, (lp.k + 1) * lp.l, lp.k + 1, lp.n),
        dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(BR.prepare_bk_ext(bk, params)).to(device)


@pytest.mark.parametrize("params", FULL_PRESETS, ids=lambda p: p.name)
def test_cuda_kernel_matches_ref_full_presets(params, cuda):
    """Every published preset through the kernel at 8 rows, k = 2 and
    N = 512 (concrete), nd = 2 digit limbs (tfhepp_80bit, radix4_2048) and
    N = 2048 (radix4_2048) included."""
    bk_ext = _random_bk_ext(params, 98, cuda)
    acc, abar = _random_inputs(params, 8, 99, cuda)
    before = BR.blind_rotate_cuda.launches
    got = BR.blind_rotate_cuda(acc, abar, bk_ext, params)
    want = BR.blind_rotate_ref(acc, abar, bk_ext, params)
    torch.cuda.synchronize()
    assert BR.blind_rotate_cuda.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("chunk", ["", "2"], ids=["one-step", "chunked"])
def test_run_schedule_on_the_card_equals_the_cpu(chunk, cuda, monkeypatch):
    """The executor on the card: a 4-bit ripple adder equal as uint32 to
    its run on the CPU's plain path, one kernel launch per planned
    rotation."""
    monkeypatch.setenv("CUFHE_EXEC_CHUNK", chunk)
    sk, ek = _keys(P.TINY, 100)
    s = build_ripple_adder(4)[0].compile()
    rng = np.random.default_rng(101)
    bits = rng.integers(0, 2, (9, 5))
    ctx, cpu = Context(ek), Context(ek, device="cpu")
    enc = [encrypt_bits(b, sk, rng) for b in bits]
    before = BR.blind_rotate_cuda.launches
    outs = run_schedule(ctx, s, enc)
    assert BR.blind_rotate_cuda.launches - before == \
        EX.plan_rotations(EX.schedule_steps(ctx, s, 5))
    want = run_schedule(cpu, s, [Ctxt(c.data.cpu(), 0) for c in enc])
    for o, w in zip(outs, want):
        assert o.data.is_cuda
        assert np.array_equal(to_u32(o.data), to_u32(w.data))
    for o, b in zip(outs, EX.simulate_schedule(s, list(bits))):
        assert np.array_equal(decrypt_bits(o, sk), b)


def test_gates_chain_across_streams_without_synchronise(cuda):
    """A chain hopping between two Streams and the default stream, with no
    explicit synchronise, equals the same chain on the default stream; the
    streams' keys are the context's own set."""
    sk, ek = _keys(P.TINY_K2, 102)
    rng = np.random.default_rng(103)
    ctx = Context(ek)
    a = encrypt_bits(rng.integers(0, 2, 2048), sk, rng)
    b = encrypt_bits(rng.integers(0, 2, 2048), sk, rng)
    s1, s2 = Stream(), Stream()
    assert s1.device == ctx.device and s1.cuda_stream is not None
    x = ctx.nand(a, b, stream=s1)
    y = ctx.xor(x, b, stream=s2)
    z = ctx.nand(y, a)
    w = ctx.mux(z, x, y, stream=s1)
    v = ctx.gate_chain(["and", "or"], w, z, stream=s2)
    assert ctx._keys_on(s1.device) is ctx.keys and not ctx._dev_keys
    rx = ctx.nand(a, b)
    ry = ctx.xor(rx, b)
    rz = ctx.nand(ry, a)
    rw = ctx.mux(rz, rx, ry)
    rv = ctx.gate_chain(["and", "or"], rw, rz)
    for got, want in ((x, rx), (y, ry), (z, rz), (w, rw), (v, rv)):
        assert np.array_equal(decrypt_bits(got, sk), decrypt_bits(want, sk))
        assert torch.equal(got.data, want.data)
    synchronize()
    assert s1.query() and s2.query()


def test_release_keys_frees_the_key_memory(cuda):
    sk, ek = _keys(P.TINY, 104)
    rng = np.random.default_rng(105)
    ctx = Context(ek)
    a = encrypt_bits([0, 1, 0, 1], sk, rng)
    b = encrypt_bits([0, 0, 1, 1], sk, rng)
    before = ctx.nand(a, b)
    key_bytes = sum(t.numel() * t.element_size() for t in
                    (ctx.keys.bk_ext, ctx.keys.ksk_limbs_sei,
                     ctx.keys.sei_perm))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    ctx.release_keys()
    assert held - torch.cuda.memory_allocated() >= key_bytes
    with pytest.raises(ValueError, match="release_keys"):
        ctx.nand(a, b)
    ctx.prepare_backend(ek)
    assert torch.equal(ctx.nand(a, b).data, before.data)


def _int_pair(device):
    """The same operands on `device`: 8-bit words and 4-bit divisors at
    PALLAS_TINY."""
    from cufhe_tpu_torch.models.integers import encrypt_uint
    sk, _ = _keys(P.PALLAS_TINY, 106)
    rng = np.random.default_rng(107)
    return [encrypt_uint(v, bits, sk, rng=rng, device=device)
            for v, bits in (([200, 17, 255, 3], 8), ([100, 239, 1, 0], 8),
                            ([13, 7, 9, 15], 4), ([3, 2, 0, 1], 4))]


@pytest.mark.parametrize("op", ["add_full", "divmod_"])
def test_integers_on_the_card_equal_the_cpu(op, cuda):
    """An 8-bit add_full and a 4-bit divmod_ (msg_bits 1) on the card,
    equal as uint32 to the CPU's plain path; one launch per pbs_many."""
    from cufhe_tpu_torch.models.integers import IntContext, decrypt_uint
    sk, ek = _keys(P.PALLAS_TINY, 106)
    outs = {}
    for dev in ("cuda", "cpu"):
        ictx = IntContext(Context(ek, device=dev))
        x, y, n, d = _int_pair(dev)
        before = BR.blind_rotate_cuda.launches
        outs[dev] = (ictx.add_full(x, y) if op == "add_full"
                     else ictx.divmod_(n, d))
        if dev == "cuda":
            assert BR.blind_rotate_cuda.launches - before == \
                (8 if op == "add_full" else 4 * 6)
    (a, b), (c, e) = outs["cuda"], outs["cpu"]
    for got, want in ((a, c), (b, e)):
        got = getattr(got, "digits", got)
        want = getattr(want, "digits", want)
        assert got.is_cuda and np.array_equal(to_u32(got), to_u32(want))
    if op == "add_full":
        assert decrypt_uint(a, sk) == [44, 0, 0, 3]
    else:
        assert decrypt_uint(a, sk) == [4, 3, 15, 15]
        assert decrypt_uint(b, sk) == [1, 1, 9, 0]


def test_toy8_cycle_on_the_card_equals_the_cpu(cuda):
    from cufhe_tpu_torch.models import processor as TOY
    sk, ek = _keys(P.TINY, 108)
    sched = TOY.build_cycle()[0].compile()
    progs = [[("ldi", 0x5A), ("add", 0x33)], [("ldi", 0), ("jz", 5)],
             [("xor", 0xFF)]]
    outs = {}
    for dev in ("cuda", "cpu"):
        ins = TOY.encrypt_state(progs, sk, np.random.default_rng(109),
                                device=dev)
        outs[dev] = TOY.run_cycles(Context(ek, device=dev), sched, ins, 1)
    for got, want in zip(outs["cuda"], outs["cpu"]):
        assert got.data.is_cuda
        assert np.array_equal(to_u32(got.data), to_u32(want.data))
    acc, pc = TOY.decrypt_state(outs["cuda"], sk)
    for lane, prog in enumerate(progs):
        assert (acc[lane], pc[lane]) == TOY.interpret(prog, 1)


def test_compat_gates_on_the_card(cuda):
    """The v1 surface with its defaults: keys and ciphertexts on the
    card, gates on a Stream."""
    import cufhe_tpu_torch.compat as cf
    cf.SetSeed(110)
    pri, pub = cf.PriKey(P.TINY), cf.PubKey(P.TINY)
    cf.KeyGen(pub, pri)
    cf.Initialize(pub)
    try:
        st = cf.Stream()
        for a in (0, 1):
            for b in (0, 1):
                c0, c1, out, neg = cf.Ctxt(), cf.Ctxt(), cf.Ctxt(), cf.Ctxt()
                cf.Encrypt(c0, cf.Ptxt(a), pri)
                cf.Encrypt(c1, cf.Ptxt(b), pri)
                assert c0._c.data.is_cuda
                cf.Nand(out, c0, c1, st)
                cf.Not(neg, out, st)
                cf.Synchronize()
                for ct, want in ((out, 1 - (a & b)), (neg, a & b)):
                    pt = cf.Ptxt()
                    cf.Decrypt(pt, ct, pri)
                    assert pt.message_ == want
    finally:
        cf.CleanUp()
        cf.SetSeed()


@pytest.mark.parametrize("params", [P.TINY, P.TINY_K2], ids=lambda p: p.name)
def test_ntt_on_the_card_equals_the_cpu(params, cuda):
    """backend="ntt" on the card: the same torch ops as on the CPU, equal as
    uint32, and no launch of the exact kernel."""
    sk, ek = _keys(params, 111)
    rng = np.random.default_rng(112)
    bits0, bits1 = [0, 1, 0, 1, 1, 0, 1, 1], [0, 0, 1, 1, 1, 1, 0, 1]
    outs = {}
    for dev in ("cuda", "cpu"):
        ctx = Context(ek, "ntt", device=dev)
        assert ctx.keys.bk_ext.numel() == 0
        a, b = (encrypt_bits(x, sk, np.random.default_rng(113 + i),
                             device=dev) for i, x in enumerate((bits0,
                                                                bits1)))
        before = BR.blind_rotate_cuda.launches
        outs[dev] = ctx.nand(a, b)
        assert BR.blind_rotate_cuda.launches == before
    assert outs["cuda"].data.is_cuda
    assert np.array_equal(to_u32(outs["cuda"].data), to_u32(outs["cpu"].data))
    assert decrypt_bits(outs["cuda"], sk).tolist() == \
        [1 - (x & y) for x, y in zip(bits0, bits1)]


def test_two_shard_mesh_on_one_card_equals_plain(cuda):
    """data_mesh() covers every card; a mesh of two shards on cuda:0 holds
    the context's one key set, launches the kernel once per shard, and
    equals the unsharded NAND as uint32."""
    from cufhe_tpu_torch.parallel import data_mesh
    assert data_mesh().size == torch.cuda.device_count()
    sk, ek = _keys(P.TINY, 114)
    rng = np.random.default_rng(115)
    a, b = (encrypt_bits(rng.integers(0, 2, 64), sk, rng) for _ in range(2))
    mesh_ctx = Context(ek, mesh=data_mesh(["cuda:0", "cuda:0"]))
    assert mesh_ctx.device == torch.device("cuda", 0)
    assert not mesh_ctx._dev_keys
    before = BR.blind_rotate_cuda.launches
    out = mesh_ctx.nand(a, b)
    assert BR.blind_rotate_cuda.launches == before + 2
    assert torch.equal(out.data, Context(ek).nand(a, b).data)
