"""cufhe_tpu_torch on a CUDA device: the blind-rotation kernels (at the tiny
presets and at every full preset; the rotate-and-decompose kernel also
alone, and its refusal of rows wider than shared memory holds; the
persistent rotation against the loop and the plain version), the key
switch kernel at every preset, and both tensor-core probe kernels (wgmma and mma.sync) against their plain
PyTorch versions; the gates and mux at both levels against the port's
golden model; the executor against its CPU run; gates chained across CUDA
streams against the default stream; and the key lifecycle's device
memory. Results compare as uint32. Every test skips without a CUDA device.

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
from cufhe_tpu_torch import _build
from cufhe_tpu_torch import golden as G
from cufhe_tpu_torch import params as P
from cufhe_tpu_torch.benchmarks import mxu_peak as MP
from cufhe_tpu_torch.benchmarks import rotdec as RD
from cufhe_tpu_torch.models.gates import TWO_INPUT
from cufhe_tpu_torch.ops import blind_rotate as BR
from cufhe_tpu_torch.ops import keys as TK
from cufhe_tpu_torch.ops import keyswitch as KS
from cufhe_tpu_torch.ops.limbs import decomp_digit_limb_plan
from cufhe_tpu_torch.runtime import (Stream, build_ripple_adder,
                                     run_schedule, synchronize)
from cufhe_tpu_torch.runtime import executor as EX
from cufhe_tpu_torch.torus import from_u32, int_mm, to_u32
from cufhe_tpu_torch.utils.spans import counts

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


def _decomp_args(params):
    """(N, nbit, k, l, Bgbit, nd, dbits, offset) as the rotation's C entries
    take them."""
    lp = params.lvl1
    nd, dbits = decomp_digit_limb_plan(lp.Bgbit)
    off = (lp.decomp_offset + lp.decomp_roundoffset) % (1 << 32)
    return lp.n, lp.nbit, lp.k, lp.l, lp.Bgbit, nd, dbits, off


@functools.lru_cache(maxsize=None)
def _device_keys(params, seed):
    """Eval key prepared on the card, once per preset (tfhepp_128bit's
    key generation takes seconds)."""
    return TK.prepare_keys(_keys(params, seed)[1], torch.device("cuda"))


@pytest.mark.parametrize("rows", [1, 8, 63, 65, 129])    # ragged row tiles
@pytest.mark.parametrize("params", [P.PALLAS_TINY, P.PALLAS_TINY_K2,
                                    P.PALLAS_BG10, P.TINY, P.TINY_K2,
                                    P.TFHEPP_128],
                         ids=lambda p: p.name)
def test_cuda_kernel_matches_ref(params, rows, cuda):
    keys = _device_keys(params, 80)
    acc, abar = _random_inputs(params, rows, 81, cuda)
    before = counts()["blind_rotate"]
    got = BR.blind_rotate(acc, abar, keys.bk_ext, params)
    want = BR.blind_rotate_ref(acc, abar, keys.bk_ext, params)
    torch.cuda.synchronize()
    assert counts()["blind_rotate"] == before + 1
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
    before = counts()["blind_rotate"]
    with pytest.raises(RuntimeError, match="invalid argument"):
        BR.blind_rotate_cuda(
            torch.zeros((1, 2, N), dtype=torch.int32, device=cuda),
            torch.zeros((1, 1), dtype=torch.int32, device=cuda),
            torch.zeros((1, 6, 2, 4, 2 * N), dtype=torch.int8, device=cuda),
            wide)
    assert counts()["blind_rotate"] == before


@pytest.mark.parametrize("rows", [1, 8, 129])
@pytest.mark.parametrize("params", [P.PALLAS_TINY, P.PALLAS_TINY_K2,
                                    P.PALLAS_BG10, P.TINY, P.TINY_K2,
                                    P.TFHEPP_128],
                         ids=lambda p: p.name)
def test_cuda_rotdec_matches_ref(params, rows, cuda):
    acc, abar = RD.random_inputs(params, rows, 90, cuda)
    before = counts()["rotdec"]
    got = BR.rotdec(acc, abar, params)
    want = BR.leaf_operands(BR.rotdec_ref(acc, abar, params),
                            BR.kar_depth(params))
    torch.cuda.synchronize()
    assert counts()["rotdec"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("params", FULL_PRESETS, ids=lambda p: p.name)
def test_cuda_rotdec_matches_ref_full_presets(params, cuda):
    acc, abar = RD.random_inputs(params, 257, 91, cuda)
    assert torch.equal(BR.rotdec_cuda(acc, abar, params),
                       BR.leaf_operands(BR.rotdec_ref(acc, abar, params),
                                        BR.kar_depth(params)))


def test_cuda_blind_rotate_counts_rotdec_launches(cuda):
    """On the loop (a batch that fills the card: 64 rows an SM at TINY's
    one output tile) cufhe_blind_rotate launches the rotate-and-decompose
    kernel once per step: n0 on rotdec_cuda's count per rotation, 0 on
    blind_rotate.persistent and its groups. At 3 rows the one persistent
    launch does the same steps: 1 on blind_rotate.persistent and on
    blind_rotate.persistent_groups (one 64-row tile), 0 on rotdec."""
    params = P.TINY
    keys = _device_keys(params, 92)
    rows = BR.EXTPROD_ROW_TILE * _build.sms(cuda)
    for B, rotdec, persistent in ((rows, params.n0, 0), (3, 0, 1)):
        acc, abar = _random_inputs(params, B, 93, cuda)
        before = counts()
        BR.blind_rotate_cuda(acc, abar, keys.bk_ext, params)
        after = counts()
        assert after["rotdec"] - before["rotdec"] == rotdec
        assert after["blind_rotate.persistent"] - \
            before["blind_rotate.persistent"] == persistent
        assert after["blind_rotate.persistent_groups"] - \
            before["blind_rotate.persistent_groups"] == persistent


def _wide(nbit, l=1, Bgbit=2):
    return P.GateParams(name=f"wide-{nbit}", lvl0=P.LweParams(n=1),
                        lvl1=P.TrlweParams(nbit=nbit, k=1, l=l, Bgbit=Bgbit),
                        ks=P.KeySwitchParams())


def test_cuda_rotdec_holds_rows_to_32768_and_refuses_wider(cuda):
    """A row lives in shared memory: N = 2^15 (128 KB) runs, N = 2^16 is
    refused with cudaErrorInvalidValue by both entries, though its limb
    sums would fit the product's int32 bound."""
    held = _wide(15)
    acc, abar = RD.random_inputs(held, 3, 94, cuda)
    assert torch.equal(BR.rotdec_cuda(acc, abar, held),
                       BR.leaf_operands(BR.rotdec_ref(acc, abar, held),
                                        BR.kar_depth(held)))
    wide = _wide(16)
    N = wide.lvl1.n
    acc = torch.zeros((1, 2, N), dtype=torch.int32, device=cuda)
    abar = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
    before = (counts()["rotdec"], counts()["blind_rotate"])
    with pytest.raises(RuntimeError, match="invalid argument"):
        BR.rotdec_cuda(acc, abar[0], wide)
    with pytest.raises(RuntimeError, match="invalid argument"):
        BR.blind_rotate_cuda(
            acc, abar, torch.zeros((1, 2, 2, 4, BR.leaf_width(
                N, BR.kar_depth(wide))), dtype=torch.int8, device=cuda), wide)
    assert (counts()["rotdec"], counts()["blind_rotate"]) == before


def test_cuda_rotdec_rejects_bad_inputs(cuda):
    params = P.TINY
    acc, abar = RD.random_inputs(params, 4, 95, cuda)
    with pytest.raises(ValueError, match="want"):
        BR.rotdec_cuda(acc.to(torch.int64), abar, params)
    with pytest.raises(ValueError, match="contiguous"):
        BR.rotdec_cuda(acc.transpose(0, 1).contiguous().transpose(0, 1),
                       abar, params)
    with pytest.raises(ValueError, match="CUDA device"):
        BR.rotdec_cuda(acc, abar.cpu(), params)
    # cp.async reads acc in 16-byte pieces: a view 4 bytes off is refused
    flat = torch.zeros(acc.numel() + 1, dtype=torch.int32, device=cuda)
    before = counts()["rotdec"]
    with pytest.raises(RuntimeError, match="invalid argument"):
        BR.rotdec_cuda(flat[1:].view(acc.shape), abar, params)
    assert counts()["rotdec"] == before


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
                before = counts()["blind_rotate"]
                out = ctx.gate(name, a, b)
                assert counts()["blind_rotate"] == before + 1
                want = np.stack([G.gate_lvl1(name, x, y, ek) for x, y in
                                 zip(to_u32(a.data), to_u32(b.data))])
                assert np.array_equal(to_u32(out.data), want), name
        gold = G.mux_lvl0 if level == 0 else G.mux_lvl1
        for negate in (False, True):
            before = counts()["blind_rotate"]
            out = ctx.mux(c, a, b, negate=negate)
            assert counts()["blind_rotate"] == before + 2
            want = np.stack([gold(x, y, z, ek, negate=negate) for x, y, z in
                             zip(to_u32(c.data), to_u32(a.data),
                                 to_u32(b.data))])
            assert np.array_equal(to_u32(out.data), want)
            plain = [y if x else z for x, y, z in zip(bitsc, bits0, bits1)]
            assert decrypt_bits(out, sk).tolist() == \
                [1 - v if negate else v for v in plain]


def _random_bk_ext(params, seed, device, nlimbs=4, depth=None):
    """The kernel's key layout of a random BK [n0, (k+1)l, k+1, N] (no key
    generation: parity needs only the layout), at `nlimbs` limbs and the
    set's Karatsuba depth (or `depth`)."""
    lp = params.lvl1
    bk = from_u32(np.random.default_rng(seed).integers(
        0, 1 << 32, (params.n0, (lp.k + 1) * lp.l, lp.k + 1, lp.n),
        dtype=np.uint64).astype(np.uint32), device)
    return BR.prepare_bk_ext(bk, params, nlimbs, depth)


@pytest.mark.parametrize("rows", [1, 8, 63, 65, 129])
@pytest.mark.parametrize("params", FULL_PRESETS, ids=lambda p: p.name)
def test_cuda_kernel_matches_ref_full_presets(params, rows, cuda):
    """Every published preset through the kernel, k = 2 and N = 512
    (concrete), nd = 2 digit limbs (tfhepp_80bit, radix4_2048) and N = 2048
    (radix4_2048) included; 1, 63 and 65 rows split the contraction."""
    bk_ext = _random_bk_ext(params, 98, cuda)
    acc, abar = _random_inputs(params, rows, 99, cuda)
    before = counts()["blind_rotate"]
    got = BR.blind_rotate_cuda(acc, abar, bk_ext, params)
    want = BR.blind_rotate_ref(acc, abar, bk_ext, params)
    torch.cuda.synchronize()
    assert counts()["blind_rotate"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("nlimbs", [4, 3])
def test_cuda_kernel_matches_ref_main_shape(nlimbs, cuda):
    """tfhepp_128bit at the main path's 4096 rows (one contraction
    range), both key precisions: the rotation of a 4096-row NAND call, on
    the loop, with no persistent launch and no row-tile group."""
    params = P.TFHEPP_128
    bk_ext = _random_bk_ext(params, 140, cuda, nlimbs)
    acc, abar = _random_inputs(params, 4096, 141, cuda)
    lp = params.lvl1
    assert BR.extprod_plan(4096, lp.n, lp.k + 1, bk_ext.shape[1],
                           depth=BR.kar_depth(params, nlimbs)) == 1
    before = counts()
    got = BR.blind_rotate_cuda(acc, abar, bk_ext, params)
    ran = counts() - before
    assert ran["blind_rotate.persistent"] == 0
    assert ran["blind_rotate.persistent_groups"] == 0
    assert torch.equal(got, BR.blind_rotate_ref(acc, abar, bk_ext, params))


@pytest.mark.parametrize("params", [P.PALLAS_TINY, P.TFHEPP_128],
                         ids=lambda p: p.name)
def test_cuda_kernel_splits_the_contraction_at_one_row(params, cuda):
    """At B = 1 the plan cuts the contraction into ranges, and the sum of
    the blocks' partials equals the plain product, on the loop (grid 0)
    and on the persistent kernel the rotation takes there; a split of one
    range on the same input agrees too."""
    lp = params.lvl1
    bk_ext = _random_bk_ext(params, 142, cuda)
    I = bk_ext.shape[1]
    depth = BR.kar_depth(params)
    acc, abar = _random_inputs(params, 1, 143, cuda)
    assert BR.extprod_plan(1, lp.n, lp.k + 1, I, _build.sms(acc.device),
                           depth) > 1
    want = BR.blind_rotate_ref(acc, abar, bk_ext, params)
    assert torch.equal(BR.blind_rotate_cuda(acc, abar, bk_ext, params), want)
    assert torch.equal(BR._blind_rotate_cuda(acc, abar, bk_ext, params, depth,
                                             grid=0), want)
    N, nbit, k, l, Bgbit, nd, dbits, off = _decomp_args(params)
    out = acc.clone()
    dec = torch.empty((1, 3 ** depth * I * (N >> depth)), dtype=torch.int8,
                      device=cuda)
    _build.call("cufhe_blind_rotate", cuda, out.data_ptr(), abar.data_ptr(),
                bk_ext.data_ptr(), dec.data_ptr(), 1, params.n0, N, nbit, k,
                l, Bgbit, nd, dbits, 4, depth, off, 1, 0, None)
    torch.cuda.synchronize()
    assert torch.equal(out, want)

#: every set the port runs, tiny and published, for the persistent kernel
PERSISTENT_SETS = [P.PALLAS_TINY, P.PALLAS_TINY_K2, P.PALLAS_BG10, P.TINY,
                   P.TINY_K2, P.PALLAS_KAR, P.PALLAS_BG10_KAR, *FULL_PRESETS]
#: the rows of each case: AES's narrow levels and the batch tiles' edges
#: (each side of 64, 128 and 192), row-tile groups of uneven sizes (5, 7
#: and 8 tiles on 132 blocks: 300, 420 and 480 rows), then the last row
#: count that takes the persistent kernel on this card ("edge") and the
#: first that takes the loop ("edge+1")
PERSISTENT_ROWS = [1, 48, 63, 64, 65, 128, 129, 160, 192, 193, 300, 420,
                   480, "edge", "edge+1"]
#: fresh inputs a case: a barrier or proxy-fence race shows on some
PERSISTENT_REPS = 20


@functools.lru_cache(maxsize=None)
def _persistent_edge(params, nlimbs, depth, sms):
    """The most rows rotation_plan gives the persistent kernel at this set,
    limb count and depth on a card of `sms` SMs (every row count from 1 to
    it does)."""
    lp = params.lvl1
    I = (lp.k + 1) * lp.l * decomp_digit_limb_plan(lp.Bgbit)[0]
    B = 1
    while BR.rotation_plan(B + 1, lp.n, lp.k + 1, I, sms, depth)[1]:
        B += 1
    return B


@pytest.mark.parametrize("rows", PERSISTENT_ROWS, ids=str)
@pytest.mark.parametrize("params", PERSISTENT_SETS, ids=lambda p: p.name)
def test_cuda_persistent_rotation_matches_ref(params, rows, cuda):
    """The persistent kernel (one cooperative launch a rotation) equals
    blind_rotate_ref bit for bit at every set, at 4 limbs at each Karatsuba
    depth from the set's own down to 0 and at 3 limbs where pallas3 runs
    (N >= 128), at AES's narrow row counts and on each side of the edge
    where rotation_plan hands over to the loop. Each case runs
    PERSISTENT_REPS times on fresh inputs, every one against the other
    launch at the same shape (the loop where the rotation takes the
    persistent kernel, the persistent kernel on the card's grid where it
    takes the loop), so a race in the grid barrier or the proxy fence
    would show; the first also against the plain version (at the
    published sets, whose plain rotation takes seconds on the card, at 1
    row and at the edge). A persistent rotation adds 1 to
    blind_rotate.persistent, its row-tile groups (persistent_groups) to
    blind_rotate.persistent_groups and 0 to rotdec; a loop n0 to
    rotdec."""
    from cufhe_tpu_torch.benchmarks.rotation import cases
    lp = params.lvl1
    sms = _build.sms(cuda)
    for nlimbs, depth in cases(params):
        bk_ext = _random_bk_ext(params, 160, cuda, nlimbs, depth)
        edge = _persistent_edge(params, nlimbs, depth, sms)
        B = {"edge": edge, "edge+1": edge + 1}.get(rows, rows)
        split, grid = BR.rotation_plan(B, lp.n, lp.k + 1, bk_ext.shape[1],
                                       sms, depth)
        assert (grid > 0) == (B <= edge) and grid <= sms
        for rep in range(PERSISTENT_REPS):
            acc, abar = _random_inputs(params, B, 1000 * rep + 161, cuda)
            before = counts()
            got = BR._blind_rotate_cuda(acc, abar, bk_ext, params, depth)
            after = counts()
            assert after["blind_rotate.persistent"] - \
                before["blind_rotate.persistent"] == (1 if grid else 0)
            assert after["blind_rotate.persistent_groups"] - \
                before["blind_rotate.persistent_groups"] == \
                (BR.persistent_groups(B, grid) if grid else 0)
            assert after["rotdec"] - before["rotdec"] == \
                (0 if grid else params.n0)
            other = BR._blind_rotate_cuda(acc, abar, bk_ext, params, depth,
                                          grid=0 if grid else sms)
            assert torch.equal(got, other), (nlimbs, depth, B, rep)
            if rep == 0 and (params not in FULL_PRESETS
                             or rows in (1, "edge")):
                assert torch.equal(got, BR._blind_rotate_ref(
                    acc, abar, bk_ext, params, depth)), (nlimbs, depth, B)


def test_cuda_persistent_rotation_refuses_a_grid_without_its_counter(cuda):
    """The C entry refuses a persistent launch without its barrier counter
    (cudaErrorInvalidValue) and launches nothing."""
    params = P.TINY
    bk_ext = _random_bk_ext(params, 162, cuda)
    acc, abar = _random_inputs(params, 3, 163, cuda)
    N, nbit, k, l, Bgbit, nd, dbits, off = _decomp_args(params)
    dec = torch.empty((3, bk_ext.shape[1] * N), dtype=torch.int8,
                      device=cuda)
    out = acc.clone()
    with pytest.raises(RuntimeError, match="invalid argument"):
        _build.call("cufhe_blind_rotate", cuda, out.data_ptr(),
                    abar.data_ptr(), bk_ext.data_ptr(), dec.data_ptr(), 3,
                    params.n0, N, nbit, k, l, Bgbit, nd, dbits, 4, 0, off, 2,
                    4, None)
    torch.cuda.synchronize()
    assert torch.equal(out, acc)


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
    before = counts()["blind_rotate"]
    outs = run_schedule(ctx, s, enc)
    assert counts()["blind_rotate"] - before == \
        EX.plan_rotations(EX.schedule_steps(ctx, s, 5))
    want = run_schedule(cpu, s, [Ctxt(c.data.cpu(), 0) for c in enc])
    for o, w in zip(outs, want):
        assert o.data.is_cuda
        assert np.array_equal(to_u32(o.data), to_u32(w.data))
    for o, b in zip(outs, EX.simulate_schedule(s, list(bits))):
        assert np.array_equal(decrypt_bits(o, sk), b)


def test_aes_blocks_reuse_one_program(cuda):
    """Two AES-128 blocks at batch 1 through one schedule at tfhepp_128bit:
    one program build and one hit, both blocks FIPS-197 AES-128 of their
    inputs, the hit's words equal to a new schedule's build on the same
    inputs; each block's 257 rotations persistent, in 833 row-tile groups;
    under torch.profiler the hit copies nothing from the host to the
    device before its first kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from cufhe_tpu_torch.runtime import netlists as NL
    from cufhe_tpu_torch.runtime.bristol import compile_bristol
    sk, ek = _keys(P.TFHEPP_128, 110)
    ctx = Context(ek)
    text = NL.aes128_bristol()
    sched, _ = compile_bristol(text)
    rng = np.random.default_rng(111)
    blocks = [(rng.bytes(16), rng.bytes(16)) for _ in range(2)]
    encs = [[encrypt_bits([b], sk, rng)
             for b in NL.bits_of(pt) + NL.bits_of(key)] for pt, key in blocks]
    before = counts()
    first = run_schedule(ctx, sched, encs[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        second = run_schedule(ctx, sched, encs[1])
        torch.cuda.synchronize()
    ran = counts() - before
    assert ran["executor.plans"] == 1 and ran["executor.plan_hits"] == 1
    assert ran["blind_rotate.persistent"] == 2 * 257
    assert ran["blind_rotate.persistent_groups"] == 2 * 833
    uncached = run_schedule(ctx, compile_bristol(text)[0], encs[1])
    assert (counts() - before)["executor.plans"] == 2
    for outs, (pt, key) in zip((first, second), blocks):
        got = NL.bytes_of([int(decrypt_bits(o, sk)[0]) for o in outs])
        assert got == NL.aes128_encrypt_block(pt, key)
    assert len(second) == len(uncached) == 128
    for o, w in zip(second, uncached):
        assert torch.equal(o.data, w.data)
    on_card = sorted((ev for ev in prof.events()
                      if ev.device_type == DeviceType.CUDA),
                     key=lambda ev: ev.time_range.start)
    kernels = [i for i, ev in enumerate(on_card)
               if not ev.name.startswith(("Memcpy", "Memset"))]
    assert kernels, "the profiler recorded no kernel on the card"
    early = [ev.name for ev in on_card[:kernels[0]] if "HtoD" in ev.name]
    assert not early, f"host-to-device copies before the first kernel: {early}"


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
                    (ctx.keys.bk_ext, ctx.keys.ksk_tiles,
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
        before = counts()["blind_rotate"]
        outs[dev] = (ictx.add_full(x, y) if op == "add_full"
                     else ictx.divmod_(n, d))
        if dev == "cuda":
            assert counts()["blind_rotate"] - before == \
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
        before = counts()["blind_rotate"]
        outs[dev] = ctx.nand(a, b)
        assert counts()["blind_rotate"] == before
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
    before = counts()["blind_rotate"]
    out = mesh_ctx.nand(a, b)
    assert counts()["blind_rotate"] == before + 2
    assert torch.equal(out.data, Context(ek).nand(a, b).data)


def _random_bk_ext3(params, seed, device):
    """The three-limb (pallas3) layout of the random BK _random_bk_ext
    draws from the same seed: limbs 1-3 of its four at depth 0."""
    return _random_bk_ext(params, seed, device,
                          depth=0)[:, :, :, 1:].contiguous()


def _by_nlimbs():
    """Rotations launched so far, by the key's limb count."""
    c = counts()
    return {3: c["blind_rotate.limbs3"], 4: c["blind_rotate.limbs4"]}


def _rotate3(acc, abar, bk_ext3, params):
    """One three-limb rotation through the kernel, counted: the pallas3
    instance launched once, the exact one not at all."""
    before = _by_nlimbs()
    got = BR.blind_rotate_cuda(acc, abar, bk_ext3, params)
    torch.cuda.synchronize()
    assert _by_nlimbs() == {3: before[3] + 1, 4: before[4]}
    return got


#: the tiny sets of the three-limb instances: N = 128 runs 32 outputs a
#: block, N = 512 64 outputs a block
TINY3 = [P.PALLAS_TINY, P.PALLAS_TINY_K2, P.PALLAS_BG10, P.PALLAS_KAR,
         P.PALLAS_BG10_KAR]


@pytest.mark.parametrize("rows", [1, 8, 63, 65, 129])
@pytest.mark.parametrize("params", TINY3, ids=lambda p: p.name)
def test_cuda_pallas3_kernel_matches_ref(params, rows, cuda):
    """The three-limb instances equal the plain version at the tiny sets
    (and the CPU's plain version) as uint32."""
    bk_ext3 = _random_bk_ext3(params, 130, cuda)
    acc, abar = _random_inputs(params, rows, 131, cuda)
    got = _rotate3(acc, abar, bk_ext3, params)
    assert torch.equal(got, BR.blind_rotate_ref(acc, abar, bk_ext3, params))
    assert torch.equal(got.cpu(), BR.blind_rotate_ref(
        acc.cpu(), abar.cpu(), bk_ext3.cpu(), params))


@pytest.mark.parametrize("rows", [1, 8, 63, 65, 129])
@pytest.mark.parametrize("params", [P.TFHEPP_128, P.TFHEPP_80],
                         ids=lambda p: p.name)
def test_cuda_pallas3_kernel_matches_ref_full_presets(params, rows, cuda):
    """At full width: tfhepp_128bit and tfhepp_80bit (nd = 2)."""
    bk_ext3 = _random_bk_ext3(params, 132, cuda)
    acc, abar = _random_inputs(params, rows, 133, cuda)
    got = _rotate3(acc, abar, bk_ext3, params)
    assert torch.equal(got, BR.blind_rotate_ref(acc, abar, bk_ext3, params))


def test_cuda_refuses_other_limb_counts(cuda):
    """cufhe_blind_rotate takes nlimbs 3 or 4, three limbs only at
    N >= 128, and 1 <= split <= the contraction's stages; anything else
    is cudaErrorInvalidValue (1) and launches nothing. The wrapper refuses
    a key of another limb count with ValueError, and raises the C entry's
    refusal."""
    lib = _build.load()

    def call(params, nlimbs, rows=2, split=1, depth=0):
        N, nbit, k, l, Bgbit, nd, dbits, off = _decomp_args(params)
        I = (k + 1) * l * nd
        acc, abar = _random_inputs(params, rows, 134, cuda)
        bk = torch.zeros((params.n0, I, k + 1, max(nlimbs, 1),
                          BR.leaf_width(N, depth)),
                         dtype=torch.int8, device=cuda)
        dec = torch.empty((rows, 3 ** depth * I * (N >> depth)),
                          dtype=torch.int8, device=cuda)
        return lib.cufhe_blind_rotate(
            acc.data_ptr(), abar.data_ptr(), bk.data_ptr(), dec.data_ptr(),
            rows, params.n0, N, nbit, k, l, Bgbit, nd, dbits, nlimbs, depth,
            off, split, 0, None, torch.cuda.current_stream().cuda_stream)

    for nlimbs in (0, 1, 2, 5, 8):
        assert call(P.PALLAS_TINY, nlimbs) == 1, nlimbs
    assert call(P.TINY, 3) == 1 and call(P.TINY, 4) == 0  # N = 64
    assert call(P.PALLAS_TINY, 3) == 0 and call(P.PALLAS_TINY, 4) == 0
    assert call(P.PALLAS_KAR, 3) == 0 and call(P.PALLAS_KAR, 4) == 0
    # PALLAS_TINY: I*N = 512 contraction bytes, 4 stages of 128
    assert call(P.PALLAS_TINY, 4, split=4) == 0
    for split in (0, 5, -1):
        assert call(P.PALLAS_TINY, 4, split=split) == 1, split
    # Karatsuba depth: 2 at PALLAS_KAR (leaves of 128), 9 x 4 stages; not
    # with three limbs, not past 2, not with leaves under 128 or digits
    # whose sums could leave int8 (Bgbit 8 at depth 1: 2 x 128)
    assert call(P.PALLAS_KAR, 4, depth=2) == 0
    assert call(P.PALLAS_KAR, 4, depth=2, split=36) == 0
    assert call(P.PALLAS_KAR, 4, depth=2, split=37) == 1
    assert call(P.PALLAS_KAR, 4, depth=1) == 0
    assert call(P.PALLAS_KAR, 3, depth=2) == 1
    assert call(P.PALLAS_KAR, 4, depth=3) == 1
    assert call(P.PALLAS_TINY, 4, depth=1) == 1
    assert call(P.CONCRETE, 4, depth=1) == 1
    torch.cuda.synchronize()
    bk2 = _random_bk_ext(P.PALLAS_TINY, 135, cuda)[:, :, :, 2:].contiguous()
    acc, abar = _random_inputs(P.PALLAS_TINY, 2, 136, cuda)
    before = counts()["blind_rotate"]
    with pytest.raises(ValueError, match="4 or 3"):
        BR.blind_rotate_cuda(acc, abar, bk2, P.PALLAS_TINY)
    acc64, abar64 = _random_inputs(P.TINY, 2, 136, cuda)
    with pytest.raises(RuntimeError, match="invalid argument"):
        BR.blind_rotate_cuda(acc64, abar64, _random_bk_ext3(P.TINY, 135,
                                                            cuda), P.TINY)
    assert counts()["blind_rotate"] == before


@pytest.mark.parametrize("params", [P.PALLAS_TINY, P.PALLAS_BG10],
                         ids=lambda p: p.name)
def test_cuda_pallas3_context_equals_the_cpu(params, cuda):
    """Context(ek, "pallas3") on the card equals the same context on the
    CPU as uint32 (nand, xor, mux), through the three-limb instance only,
    and decrypts right."""
    import warnings
    sk, ek = _keys(params, 137)
    rng = np.random.default_rng(138)
    bits0, bits1, bitsc = [0, 1, 0, 1], [0, 0, 1, 1], [1, 0, 1, 0]
    hosts = [G.encrypt_bit_batch(x, sk, rng) for x in (bits0, bits1, bitsc)]
    outs = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        for dev in ("cuda", "cpu"):
            ctx = Context(ek, "pallas3", device=dev)
            a, b, c = (Ctxt(from_u32(h, dev), 0) for h in hosts)
            before = _by_nlimbs()
            outs[dev] = [ctx.nand(a, b), ctx.xor(a, b), ctx.mux(c, a, b)]
            launched = {nl: _by_nlimbs()[nl] - before[nl] for nl in before}
            assert launched == ({3: 4, 4: 0} if dev == "cuda"
                                else {3: 0, 4: 0})
    for got, want in zip(outs["cuda"], outs["cpu"]):
        assert np.array_equal(to_u32(got.data), to_u32(want.data))
    assert decrypt_bits(outs["cuda"][0], sk).tolist() == [1, 1, 1, 0]
    assert decrypt_bits(outs["cuda"][1], sk).tolist() == [0, 1, 1, 0]
    assert decrypt_bits(outs["cuda"][2], sk).tolist() == [0, 0, 0, 1]


def test_timing_block_waits_for_the_card(cuda):
    """utils.timing.block synchronises the device of the CUDA tensors it
    is given: work enqueued before it has finished when it returns."""
    from cufhe_tpu_torch.utils.timing import block
    x = torch.ones((4096, 4096), device=cuda)
    torch.cuda._sleep(10_000_000)
    done = torch.cuda.Event()
    y = x @ x
    done.record()
    assert block([y])[0] is y
    assert done.query()


# -- Karatsuba leaves -------------------------------------------------------

#: (set, its Karatsuba depth): depth 2 at Bgbit 6 and at the nd = 2 set,
#: depth 1 at Bgbit 7
KAR_SETS = [(P.TFHEPP_128, 2), (P.TFHEPP_80, 2), (P.CGGI19, 1)]


@pytest.mark.parametrize("rows", [1, 63, 65, 4096])
@pytest.mark.parametrize("params,depth", KAR_SETS,
                         ids=[p.name for p, _ in KAR_SETS])
def test_cuda_karatsuba_kernel_matches_ref(params, depth, rows, cuda):
    """The leaf instances equal the plain leaf product and the depth-0
    instance on the same key bit for bit; 1, 63 and 65 rows split the
    contraction (the ranges cut leaves), 4096 does not."""
    assert BR.kar_depth(params) == depth
    lp = params.lvl1
    bk_ext = _random_bk_ext(params, 150, cuda)
    assert bk_ext.shape[-1] == BR.leaf_width(lp.n, depth)
    acc, abar = _random_inputs(params, rows, 151, cuda)
    split = BR.extprod_plan(rows, lp.n, lp.k + 1, bk_ext.shape[1],
                            _build.sms(acc.device), depth)
    assert (split > 1) == (rows < 4096)
    before = counts()
    got = BR.blind_rotate_cuda(acc, abar, bk_ext, params)
    torch.cuda.synchronize()
    after = counts()
    assert after[f"blind_rotate.kar{depth}"] == \
        before[f"blind_rotate.kar{depth}"] + 1
    assert torch.equal(got, BR.blind_rotate_ref(acc, abar, bk_ext, params))
    flat = _random_bk_ext(params, 150, cuda, depth=0)
    assert torch.equal(got, BR._blind_rotate_cuda(acc, abar, flat, params, 0))


@pytest.mark.parametrize("rows", [1, 8, 129])
@pytest.mark.parametrize("params", [P.PALLAS_KAR, P.PALLAS_BG10_KAR],
                         ids=lambda p: p.name)
def test_cuda_karatsuba_kernel_matches_ref_tiny(params, rows, cuda):
    """Depth 2 with leaves of 128 coefficients (one stage a key row)
    against the CPU's plain leaf product too."""
    bk_ext = _random_bk_ext(params, 152, cuda)
    acc, abar = _random_inputs(params, rows, 153, cuda)
    got = BR.blind_rotate_cuda(acc, abar, bk_ext, params)
    assert torch.equal(got.cpu(), BR.blind_rotate_ref(
        acc.cpu(), abar.cpu(), bk_ext.cpu(), params))


@pytest.mark.parametrize("params", [P.TFHEPP_128, P.CGGI19, P.PALLAS_KAR],
                         ids=lambda p: p.name)
def test_cuda_rotdec_leaf_operands_reach_the_int8_edge(params, cuda):
    """A row of acc = off/2 rotated by X^N (its negation) decomposes to
    digits of -Bg/2 everywhere: the leaf sums reach -128 at depth 2 (four
    digits of -32) and -128 at depth 1 (two of -64), as the plain model."""
    depth = BR.kar_depth(params)
    N, _, k, l, Bgbit, nd, _, off = _decomp_args(params)
    acc = torch.full((5, k + 1, N), off // 2, dtype=torch.int64)
    acc = from_u32(acc.numpy().astype(np.uint32), cuda)
    abar = torch.full((5,), N, dtype=torch.int32, device=cuda)
    got = BR.rotdec_cuda(acc, abar, params)
    digits = BR.rotdec_ref(acc, abar, params)
    assert int(digits.min()) == int(digits.max()) == -(1 << (Bgbit - 1))
    assert torch.equal(got, BR.leaf_operands(digits, depth))
    assert int(got.min()) == -128


def test_cuda_depth_follows_the_set_and_the_counter_counts(cuda):
    """tfhepp_128bit's exact key launches the depth-2 instance; concrete,
    tfhepp_128bit_bg8 and every three-limb key the depth-0 one, whose dec
    is [B, I, N] as before: blind_rotate.kar{d} counts each rotation once,
    at its depth."""
    def depths(params, nlimbs):
        keys = _random_bk_ext(params, 154, cuda, nlimbs)
        acc, abar = _random_inputs(params, 3, 155, cuda)
        before = counts()
        BR.blind_rotate_cuda(acc, abar, keys, params)
        after = counts()
        return [after[f"blind_rotate.kar{d}"] - before[f"blind_rotate.kar{d}"]
                for d in range(3)]

    assert depths(P.TFHEPP_128, 4) == [0, 0, 1]
    assert depths(P.CGGI19, 4) == [0, 1, 0]
    for params in (P.CONCRETE, P.TFHEPP_128_BG8):
        assert depths(params, 4) == [1, 0, 0]
    for params in (P.TFHEPP_128, P.TFHEPP_80, P.CONCRETE):
        assert depths(params, 3) == [1, 0, 0]
    acc, abar = RD.random_inputs(P.CONCRETE, 3, 156, cuda)
    lp = P.CONCRETE.lvl1
    assert tuple(BR.rotdec_cuda(acc, abar, P.CONCRETE).shape) == \
        (3, (lp.k + 1) * lp.l, lp.n)


@pytest.mark.parametrize("params,depth", [(P.TFHEPP_128, 0),
                                          (P.TFHEPP_128, 1),
                                          (P.CONCRETE, 1)],
                         ids=["tfhepp_128bit-d0", "tfhepp_128bit-d1",
                              "concrete-d1"])
def test_cuda_refuses_a_key_at_another_depth(params, depth, cuda):
    """The key's layout selects no depth: blind_rotate_cuda refuses a key
    built at a depth other than kar_depth's with ValueError and launches
    nothing."""
    bk_ext = _random_bk_ext(params, 157, cuda, depth=depth)
    acc, abar = _random_inputs(params, 2, 158, cuda)
    before = counts()["blind_rotate"]
    with pytest.raises(ValueError, match="want"):
        BR.blind_rotate_cuda(acc, abar, bk_ext, params)
    assert counts()["blind_rotate"] == before


def _random_ksk(params, seed, device):
    """A random KSK in ksk_tiles' layout on `device`, from random limbs
    [4, t*nb*d1, n0+1] int8. The kernel's arithmetic needs no real key."""
    kp = params.ks
    rng = np.random.default_rng(seed)
    limbs = torch.from_numpy(rng.integers(
        -128, 128, (4, kp.t * kp.numbase * params.lvl1.k * params.lvl1.n,
                    params.lvl0.dim + 1), dtype=np.int8)).to(device)
    return KS.ksk_tiles(limbs, params)


def _random_tlwe1(params, rows, seed, device):
    rng = np.random.default_rng(seed)
    d1 = params.lvl1.k * params.lvl1.n
    x = rng.integers(0, 1 << 32, (rows, d1 + 1), dtype=np.uint64)
    x[:1] = 0                        # every digit at its offset
    x[1:2] = (1 << 32) - 1
    return from_u32(x.astype(np.uint32), device)


@pytest.mark.parametrize("rows", [1, 7, 17, 48, 160, 480, 1024, 4096])
@pytest.mark.parametrize("params", list(P.PRESETS.values()),
                         ids=lambda p: p.name)
def test_cuda_key_switch_matches_ref(params, rows, cuda):
    """keyswitch_kernel bit for bit against its plain version
    (key_switch_ref, on the card) at every preset (t*numbase 8 to 28,
    basebit 3 at TINY_Q) and at row counts that take both row tiles and
    every kind of split, one launch each."""
    tiles = _random_ksk(params, 160, cuda)
    x = _random_tlwe1(params, rows, 161, cuda)
    before = counts()["key_switch"]
    got = KS.key_switch(x, tiles, params)
    want = KS.key_switch_ref(x, tiles, params)
    torch.cuda.synchronize()
    assert counts()["key_switch"] == before + 1
    assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.parametrize("rows", [17, 160])
@pytest.mark.parametrize("params", [P.TFHEPP_128, P.CONCRETE, P.TINY_Q],
                         ids=lambda p: p.name)
def test_cuda_key_switch_pre_add_and_perm(params, rows, cuda):
    """The pre-add (int and per-row constants) and the sei_perm gather in
    front of the kernel, against the kernel's plain version on the card
    and on the CPU."""
    tiles = _random_ksk(params, 162, cuda)
    x = _random_tlwe1(params, rows, 163, cuda)
    y = _random_tlwe1(params, rows, 164, cuda)
    perm = torch.from_numpy(TK.sei_perm(params)).to(cuda)
    per_row = torch.arange(rows, dtype=torch.int32, device=cuda) - 7
    for pre in (None, (1, -1, 1 << 29, y), (per_row, 1, -per_row, y)):
        for pm in (None, perm):
            got = KS.key_switch(x, tiles, params, pre, pm)
            assert torch.equal(got, KS.key_switch_ref(x, tiles, params, pre,
                                                      pm))
            cpu = lambda v: v.cpu() if isinstance(v, torch.Tensor) else v
            ref = KS.key_switch(x.cpu(), tiles.cpu(), params,
                                None if pre is None else tuple(map(cpu, pre)),
                                None if pm is None else pm.cpu())
            assert torch.equal(got.cpu(), ref)


def test_cuda_gates_launch_one_key_switch_and_no_int_mm(cuda, monkeypatch):
    """One keyswitch_kernel launch a lvl0 NAND, two a lvl1 mux; nothing on
    the card's gate path reaches torch._int_mm."""
    sk, ek = _keys(P.TINY, 165)
    rng = np.random.default_rng(166)
    ctx = Context(ek, device=cuda)
    a0, b0, c0 = (encrypt_bits(v, sk, rng, device=cuda)
                  for v in ([0, 1, 0, 1], [0, 0, 1, 1], [0, 1, 1, 0]))
    a1, b1, c1 = (encrypt_bits(v, sk, rng, device=cuda, level=1)
                  for v in ([0, 1, 0, 1], [0, 0, 1, 1], [0, 1, 1, 0]))

    def refuse(*args, **kwargs):
        raise AssertionError("torch._int_mm called on the card's gate path")

    monkeypatch.setattr(torch, "_int_mm", refuse)
    for fn, launches, want in (
            (lambda: ctx.nand(a0, b0), 1, [1, 1, 1, 0]),
            (lambda: ctx.mux(c1, a1, b1), 2, [0, 1, 0, 1]),
            (lambda: ctx.mux(c0, a0, b0), 1, [0, 1, 0, 1])):
        before = counts()
        out = fn()
        torch.cuda.synchronize()
        assert counts()["key_switch"] - before["key_switch"] == launches
        assert decrypt_bits(out, sk).tolist() == want


def test_cuda_key_switch_rejects_bad_inputs(cuda):
    params = P.TINY
    tiles = _random_ksk(params, 167, cuda)
    x = _random_tlwe1(params, 4, 168, cuda)
    with pytest.raises(ValueError, match="want"):
        KS.key_switch_cuda(x, tiles[:, :3], params)
    with pytest.raises(ValueError, match="CUDA device"):
        KS.key_switch_cuda(x, tiles.cpu(), params)
    # basebit 4 (eight KSK rows a digit) has digits that straddle the
    # kernel's 4-byte words: the C entry refuses it and launches nothing
    wide = P.GateParams(name="basebit4", lvl0=params.lvl0, lvl1=params.lvl1,
                        ks=P.KeySwitchParams(t=4, basebit=4))
    wtiles = _random_ksk(wide, 169, cuda)
    before = counts()["key_switch"]
    with pytest.raises(RuntimeError, match="invalid argument"):
        KS.key_switch_cuda(x, wtiles, wide)
    assert counts()["key_switch"] == before
