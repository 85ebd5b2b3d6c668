"""cufhe_tpu_torch on a CUDA device: the blind-rotation kernel and both
tensor-core probe kernels (wgmma and mma.sync) against their plain PyTorch
versions, and the gates and mux at both levels against the port's golden
model, as uint32 equality. Every test skips without a CUDA device.

This file imports neither JAX nor the JAX package (the oracle is the
port's own golden.py and params.py), so it runs where only the port's
files are installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""
import functools

import numpy as np
import pytest
import torch

from cufhe_tpu_torch import Context, decrypt_bits, encrypt_bits
from cufhe_tpu_torch import golden as G
from cufhe_tpu_torch import params as P
from cufhe_tpu_torch.benchmarks import mxu_peak as MP
from cufhe_tpu_torch.models.gates import TWO_INPUT
from cufhe_tpu_torch.ops import blind_rotate as BR
from cufhe_tpu_torch.ops import keys as TK
from cufhe_tpu_torch.torus import from_u32, int_mm, to_u32


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
