"""cufhe_tpu_torch's rotate-and-decompose step on the CPU: rotdec_ref
against the JAX reference (cufhe_tpu.ops.poly.decompose_rotate_sub and
split_decomp_digits, rows interleaved as (j*l + d)*nd + dl), the CPU
dispatch, the CUDA wrapper's input checks, and the bytes that bound the
kernel. The CUDA kernel against rotdec_ref is tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cufhe_tpu import params as JP
from cufhe_tpu.ops import poly as JPoly
from cufhe_tpu_torch import _build
from cufhe_tpu_torch import params as P
from cufhe_tpu_torch.benchmarks import rotdec as RD
from cufhe_tpu_torch.ops import blind_rotate as BR
from cufhe_tpu_torch.ops.limbs import decomp_digit_limb_plan
from cufhe_tpu_torch.ops.poly import decompose_rotate_sub
from cufhe_tpu_torch.torus import to_u32
from cufhe_tpu_torch.utils.spans import counts

PRESETS = ["PALLAS_TINY", "TINY", "TINY_K2", "PALLAS_BG10"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Intra-op threads off while this module runs: the suite runs several
    worker processes on the same cores, where torch's thread pool spends
    its time waiting for its own threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_rotdec(acc: np.ndarray, abar: np.ndarray, params) -> np.ndarray:
    """The JAX package's digits of one step, [B, I, N] int8."""
    lp = params.lvl1
    dec = JPoly.decompose_rotate_sub(jnp.asarray(acc), jnp.asarray(abar), lp)
    parts, _ = JPoly.split_decomp_digits(dec, lp.Bgbit)
    out = np.stack([np.asarray(p) for p in parts], axis=2)
    B, rows, nd, N = out.shape
    return out.reshape(B, rows * nd, N)


@pytest.mark.parametrize("name", PRESETS)
def test_rotdec_ref_matches_jax(name):
    params = getattr(P, name)
    acc, abar = RD.random_inputs(params, 7, 40, "cpu")
    assert to_u32(abar)[:4].tolist() == [0, params.lvl1.n - 1, params.lvl1.n,
                                         2 * params.lvl1.n - 1]
    got = BR.rotdec_ref(acc, abar, params)
    lp = params.lvl1
    I = (lp.k + 1) * lp.l * decomp_digit_limb_plan(lp.Bgbit)[0]
    assert got.dtype == torch.int8 and tuple(got.shape) == (7, I, lp.n)
    want = _jax_rotdec(to_u32(acc), to_u32(abar), getattr(JP, name))
    assert np.array_equal(got.numpy(), want)


def test_rotdec_ref_sub_digits_recombine():
    """At Bgbit 10 (nd = 2) rows 2r and 2r+1 are the balanced sub-digits of
    gadget digit r: low + (high << dbits) is the digit, in [-Bg/2, Bg/2)."""
    params = P.PALLAS_BG10
    lp = params.lvl1
    nd, dbits = decomp_digit_limb_plan(lp.Bgbit)
    assert nd == 2
    acc, abar = RD.random_inputs(params, 5, 41, "cpu")
    dec = BR.rotdec_ref(acc, abar, params).to(torch.int32)
    digits = dec[:, 0::2] + (dec[:, 1::2] << dbits)
    assert torch.equal(digits, decompose_rotate_sub(acc, abar, lp))
    assert int(digits.min()) >= -(lp.Bg // 2) and int(digits.max()) < lp.Bg // 2


def test_rotdec_dispatch_on_cpu():
    params = P.TINY
    acc, abar = RD.random_inputs(params, 3, 42, "cpu")
    before = counts()["rotdec"]
    assert torch.equal(BR.rotdec(acc, abar, params),
                       BR.rotdec_ref(acc, abar, params))
    assert counts()["rotdec"] == before
    with pytest.raises(NotImplementedError, match="meta"):
        BR.rotdec(acc.to("meta"), abar.to("meta"), params)


def test_rotdec_cuda_checks_before_any_build(monkeypatch):
    """Wrong device, dtype or shape raise ValueError before the kernel
    library is built (here the build would fail: no nvcc)."""
    def no_build(*args):
        raise AssertionError("the kernel library was built")
    monkeypatch.setattr(_build, "load", no_build)
    params = P.TINY
    acc, abar = RD.random_inputs(params, 3, 43, "cpu")
    before = counts()["rotdec"]
    with pytest.raises(ValueError, match="CUDA"):
        BR.rotdec_cuda(acc, abar, params)
    with pytest.raises(ValueError, match="want"):
        BR.rotdec_cuda(acc.to(torch.int64), abar, params)
    with pytest.raises(ValueError, match="want"):
        BR.rotdec_cuda(acc[:, :1], abar, params)
    with pytest.raises(ValueError, match="want"):
        BR.rotdec_cuda(acc, abar[:2], params)
    assert counts()["rotdec"] == before


def test_blind_rotate_ref_steps_through_rotdec_ref(monkeypatch):
    """The plain rotation takes its digits from rotdec_ref, once per step,
    with each step's rotations."""
    params = P.TINY
    seen = []
    real = BR.rotdec_ref

    def spy(acc, abar_i, p):
        seen.append(abar_i)
        return real(acc, abar_i, p)
    monkeypatch.setattr(BR, "rotdec_ref", spy)
    lp = params.lvl1
    acc, _ = RD.random_inputs(params, 2, 44, "cpu")
    abar = (torch.arange(params.n0 * 2, dtype=torch.int32) % (2 * lp.n)
            ).reshape(-1, 2)
    bk_ext = torch.zeros((params.n0, 2 * lp.l, 2, 4, 2 * lp.n),
                         dtype=torch.int8)
    out = BR.blind_rotate_ref(acc, abar, bk_ext, params)
    assert torch.equal(out, acc)                  # a zero key adds nothing
    assert len(seen) == params.n0
    assert all(torch.equal(s, abar[i]) for i, s in enumerate(seen))


def test_rotdec_bound_at_tfhepp_128():
    """One launch at batch 4096 reads 33.5 MB of acc (and 16 KB of abar)
    and writes the Karatsuba-2 leaf operands, 9 leaves of 6 rows of 256
    bytes a row (56.6 MB, 2.25x the 25.2 MB of the digits): 90.2 MB,
    26.9 us at 3.35 TB/s."""
    nbytes = RD.rotdec_bytes(P.TFHEPP_128, 4096)
    assert nbytes == 4096 * 2 * 1024 * 4 + 4096 * 4 + 4096 * 9 * 6 * 256
    assert nbytes / RD.HBM_BYTES_PER_S * 1e6 == pytest.approx(26.924, abs=1e-3)
    # nd = 2 doubles the digit rows
    lp = P.PALLAS_BG10.lvl1
    assert RD.rotdec_bytes(P.PALLAS_BG10, 3) == \
        3 * 2 * lp.n * 4 + 3 * 4 + 3 * 2 * lp.l * 2 * lp.n

