"""cufhe_tpu_torch blind rotation: the kernel's key layout, the plain
PyTorch version against the Pallas kernel (interpret mode, as
tests/test_pallas.py runs it) and the golden model. The CUDA kernel against
the plain version is tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cufhe_tpu import golden as G
from cufhe_tpu import params as P
from cufhe_tpu.ops import bootstrap as JB
from cufhe_tpu.ops import keys as JK
from cufhe_tpu_torch.ops import blind_rotate as BR
from cufhe_tpu_torch.ops import bootstrap as TB
from cufhe_tpu_torch.ops import keys as TK
from cufhe_tpu_torch.ops.limbs import decomp_digit_limb_plan
from cufhe_tpu_torch.torus import from_u32, to_u32
from cufhe_tpu_torch.utils.spans import counts

PALLAS_PRESETS = [P.PALLAS_TINY, P.PALLAS_TINY_K2, P.PALLAS_BG10]


def _keys(params, seed):
    sk = G.keygen(params, seed=seed)
    return sk, G.make_eval_key(sk, seed=seed + 1)


@pytest.mark.parametrize("params", [P.TINY, P.PALLAS_BG10, P.TINY_K2],
                         ids=lambda p: p.name)
def test_bk_ext_recombines_to_extended_generator(params):
    _, ek = _keys(params, 50)
    ext = BR.prepare_bk_ext(ek.bk, params)
    n0, I0, kp1, N = ek.bk.shape
    nd, dbits = decomp_digit_limb_plan(params.lvl1.Bgbit)
    assert ext.dtype == np.int8 and ext.shape == (n0, I0 * nd, kp1, 4, 2 * N)
    rec = sum(ext[:, :, :, li, :].astype(np.int64) << (8 * li)
              for li in range(4)).astype(np.uint32)
    for dl in range(nd):
        bk = ek.bk << np.uint32(dbits * dl)
        assert np.array_equal(rec[:, dl::nd, :, N:], bk)
        assert np.array_equal(rec[:, dl::nd, :, :N], np.zeros_like(bk) - bk)


@pytest.mark.parametrize("params", PALLAS_PRESETS, ids=lambda p: p.name)
def test_blind_rotate_ref_matches_pallas_and_golden(params):
    sk, ek = _keys(params, 60)
    rng = np.random.default_rng(61)
    cts = G.encrypt_bit_batch([0, 1, 1, 0], sk, rng)
    n0 = params.n0
    mu = params.lvl1.mu
    got = to_u32(TB.blind_rotate(from_u32(cts[:, :n0]), from_u32(cts[:, n0]),
                                 mu, TK.prepare_keys(ek, "cpu"), params))
    jkeys = JK.prepare_keys(ek, backends=("pallas",))
    want_pallas = np.asarray(JB.blind_rotate(
        jnp.asarray(cts[:, :n0]), jnp.asarray(cts[:, n0]), mu, jkeys, params,
        "pallas"))
    assert np.array_equal(got, want_pallas)
    want = np.stack([G.blind_rotate(c, mu, ek) for c in cts])
    assert np.array_equal(got, want)


def test_blind_rotate_dispatch_on_cpu():
    params = P.TINY
    _, ek = _keys(params, 70)
    keys = TK.prepare_keys(ek, "cpu")
    rng = np.random.default_rng(71)
    acc = from_u32(rng.integers(0, 1 << 32, (3, 2, params.lvl1.n),
                                dtype=np.uint64).astype(np.uint32))
    abar = from_u32(rng.integers(0, 2 * params.lvl1.n, (params.n0, 3))
                    .astype(np.uint32))
    before = counts()["blind_rotate"]
    out = BR.blind_rotate(acc, abar, keys.bk_ext, params)
    assert torch.equal(out, BR.blind_rotate_ref(acc, abar, keys.bk_ext,
                                                params))
    assert counts()["blind_rotate"] == before
    # the kernel's wrapper takes CUDA tensors only: no CPU fallback in it
    with pytest.raises(ValueError, match="CUDA"):
        BR.blind_rotate_cuda(acc, abar, keys.bk_ext, params)
