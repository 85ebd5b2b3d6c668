"""cufhe_tpu_torch on a CUDA device: the blind-rotation kernel against its
plain PyTorch version and the lvl0 gates against the golden model, as
uint32 equality. Every test skips without a CUDA device.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from cufhe_tpu import golden as G
from cufhe_tpu import params as P
from cufhe_tpu_torch import Context, decrypt_bits, encrypt_bits
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


@pytest.mark.parametrize("params", [P.PALLAS_TINY, P.PALLAS_TINY_K2,
                                    P.PALLAS_BG10, P.TINY, P.TINY_K2],
                         ids=lambda p: p.name)
def test_cuda_kernel_matches_ref(params, cuda):
    _, ek = _keys(params, 80)
    keys = TK.prepare_keys(ek, cuda)
    acc, abar = _random_inputs(params, 37, 81, cuda)   # a ragged row tile
    before = BR.blind_rotate_cuda.launches
    got = BR.blind_rotate(acc, abar, keys.bk_ext, params)
    want = BR.blind_rotate_ref(acc, abar, keys.bk_ext, params)
    torch.cuda.synchronize()
    assert BR.blind_rotate_cuda.launches == before + 1
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), BR.blind_rotate_ref(
        acc.cpu(), abar.cpu(), keys.bk_ext.cpu(), params))


def test_cuda_kernel_rejects_bad_inputs(cuda):
    params = P.TINY
    _, ek = _keys(params, 82)
    keys = TK.prepare_keys(ek, cuda)
    acc, abar = _random_inputs(params, 4, 83, cuda)
    with pytest.raises(ValueError, match="want"):
        BR.blind_rotate_cuda(acc.to(torch.int64), abar, keys.bk_ext, params)
    with pytest.raises(ValueError, match="contiguous"):
        BR.blind_rotate_cuda(acc.transpose(0, 1).contiguous().transpose(0, 1),
                             abar, keys.bk_ext, params)
    with pytest.raises(ValueError, match="CUDA device"):
        BR.blind_rotate_cuda(acc, abar.cpu(), keys.bk_ext, params)


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
