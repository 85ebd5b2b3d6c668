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
    ext = BR.prepare_bk_ext(from_u32(ek.bk), params).numpy()
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


# -- Karatsuba leaves ------------------------------------------------------

@pytest.fixture
def one_torch_thread():
    """Intra-op threads off while a test runs: the suite runs several
    worker processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("nlimbs", [4, 3])
@pytest.mark.parametrize("name", sorted(P.PRESETS))
def test_kar_depth_matches_jax(name, nlimbs, monkeypatch):
    """The port's depth rule is the JAX kernel's (without its environment
    override) for every preset at both key precisions."""
    from cufhe_tpu.ops.pallas_br import kar_depth
    from cufhe_tpu_torch import params as TP
    monkeypatch.delenv("CUFHE_KAR_DEPTH", raising=False)
    assert BR.kar_depth(TP.PRESETS[name], nlimbs) == \
        kar_depth(P.PRESETS[name].lvl1, nlimbs)


def test_kar_depth_of_the_published_sets():
    assert [BR.kar_depth(p) for p in (
        P.TFHEPP_128, P.TFHEPP_80, P.RADIX4_2048, P.CGGI19, P.CONCRETE,
        P.TFHEPP_128_BG8, P.TINY, P.PALLAS_TINY, P.PALLAS_KAR)] == \
        [2, 2, 2, 1, 0, 0, 0, 0, 2]
    assert BR.kar_depth(P.TFHEPP_128, 3) == 0


def _random_bk(params, n0, seed):
    lp = params.lvl1
    bk = np.random.default_rng(seed).integers(
        0, 1 << 32, (n0, (lp.k + 1) * lp.l, lp.k + 1, lp.n),
        dtype=np.uint64).astype(np.uint32)
    bk[0, 0, 0, :4] = [0, 1 << 31, (1 << 31) - 1, (1 << 32) - 1]
    return bk


@pytest.mark.parametrize("params", [P.PALLAS_KAR, P.PALLAS_BG10_KAR,
                                    P.CGGI19, P.TFHEPP_128],
                         ids=lambda p: p.name)
def test_leaf_generators_equal_child_exts(params, one_torch_thread):
    """prepare_bk_ext's leaf generators, recombined from their limbs, are
    _child_exts' leaves of the JAX package in uint32, and each limb is the
    JAX key's (prepare_wext at the same depth, its unrotated copy)."""
    from cufhe_tpu.ops.pallas_br import BK_COPIES, _child_exts, prepare_wext
    bk = _random_bk(params, 2, 80)
    depth = BR.kar_depth(params)
    assert depth > 0
    ext = BR.prepare_bk_ext(from_u32(bk), params).numpy()
    n0, I0, kp1, N = bk.shape
    nd, dbits = decomp_digit_limb_plan(params.lvl1.Bgbit)
    I, LN, L = I0 * nd, N >> depth, 3 ** depth
    assert ext.shape == (n0, I, kp1, 4, L * 2 * LN)
    rec = sum(ext[:, :, :, li].astype(np.int64) << (8 * li)
              for li in range(4)).astype(np.uint32)
    scaled = np.stack([bk << np.uint32(dbits * dl) for dl in range(nd)],
                      axis=2).reshape(n0, I, kp1, N)
    leaves = [np.concatenate([np.zeros_like(scaled) - scaled, scaled], -1)]
    for _ in range(depth):
        leaves = [c for e in leaves for c in _child_exts(e)]
    assert np.array_equal(rec, np.concatenate(leaves, axis=-1))
    wext = prepare_wext(bk, params, depth=depth)
    OL = kp1 * 4
    for v in (0, L // 2, L - 1):
        for o in range(kp1):
            for li in range(4):
                for j in range(I):
                    col = BK_COPIES * ((v * OL + o * 4 + li) * I + j)
                    assert np.array_equal(
                        ext[:, j, o, li, 2 * LN * v:2 * LN * (v + 1)],
                        wext[:, :, col])


@pytest.mark.parametrize("params,rows", [(P.PALLAS_KAR, 6),
                                         (P.PALLAS_BG10_KAR, 6),
                                         (P.TFHEPP_128, 3)],
                         ids=lambda v: getattr(v, "name", str(v)))
def test_leaf_product_equals_schoolbook(params, rows, one_torch_thread):
    """The plain leaf product, on the leaf operands in rotdec_kernel's
    layout (leaf_operands), the leaf windows of the key and the quarter
    post-add, equals the schoolbook product on the depth-0 key bit for
    bit; row 0 holds digits of -2^(dbits-1) only, so the depth-2 operands
    reach -128."""
    lp = params.lvl1
    depth = BR.kar_depth(params)
    nd, dbits = decomp_digit_limb_plan(lp.Bgbit)
    I = (lp.k + 1) * lp.l * nd
    bk = torch.from_numpy(_random_bk(params, 1, 81).view(np.int32))
    leaf_key = BR.prepare_bk_ext(bk, params)[0]
    flat_key = BR.prepare_bk_ext(bk, params, depth=0)[0]
    half = 1 << (dbits - 1)
    dec = torch.from_numpy(np.random.default_rng(82).integers(
        -half, half, (rows, I, lp.n)).astype(np.int8))
    dec[0] = -half
    ops = BR.leaf_operands(dec, depth)
    LN = lp.n >> depth
    assert tuple(ops.shape) == (rows, 3 ** depth, I, LN)
    assert int(ops[0].min()) == -half << depth == -128
    # leaf 0 is the sum of all quarters, leaf 3^d - 1 the first quarter
    assert torch.equal(ops[:, 0].int(), sum(
        dec[..., q * LN:(q + 1) * LN].int() for q in range(2 ** depth)))
    assert torch.equal(ops[:, -1], dec[..., :LN])
    assert torch.equal(BR.ext_product_ref(ops, leaf_key),
                       BR.ext_product_ref(dec, flat_key))


def test_leaf_operands_refuse_to_leave_int8():
    dec = torch.full((1, 2, 512), -64, dtype=torch.int8)
    assert int(BR.leaf_operands(dec, 1).min()) == -128
    with pytest.raises(ValueError, match="int8"):
        BR.leaf_operands(dec, 2)


@pytest.mark.parametrize("params", [P.PALLAS_KAR, P.PALLAS_BG10_KAR],
                         ids=lambda p: p.name)
def test_plain_rotation_at_depth_2_matches_golden(params, one_torch_thread):
    """A CPU context at a depth-2 set holds the leaf key and rotates
    through the plain leaf product, equal to the golden model."""
    sk, ek = _keys(params, 83)
    keys = TK.prepare_keys(ek, "cpu")
    assert keys.bk_ext.shape[-1] == BR.leaf_width(params.lvl1.n, 2)
    cts = G.encrypt_bit_batch([0, 1, 1], sk, np.random.default_rng(84))
    n0, mu = params.n0, params.lvl1.mu
    got = to_u32(TB.blind_rotate(from_u32(cts[:, :n0]), from_u32(cts[:, n0]),
                                 mu, keys, params))
    want = np.stack([G.blind_rotate(c, mu, ek) for c in cts])
    assert np.array_equal(got, want)


def test_plain_rotation_refuses_a_key_at_another_depth(one_torch_thread):
    """The key's layout selects no depth: at a depth-2 set blind_rotate_ref
    and the CPU dispatch refuse a depth-0 key with ValueError; the private
    entry takes it at depth 0 and equals the depth-2 rotation."""
    from cufhe_tpu_torch.benchmarks import rotation as RB
    params = P.PALLAS_KAR
    bk = torch.from_numpy(_random_bk(params, params.n0, 86).view(np.int32))
    flat = BR.prepare_bk_ext(bk, params, depth=0)
    acc, abar = RB.random_rotation_inputs(params, 2, 87, "cpu")
    with pytest.raises(ValueError, match="Karatsuba depth 2"):
        BR.blind_rotate_ref(acc, abar, flat, params)
    with pytest.raises(ValueError, match="Karatsuba depth 2"):
        BR.blind_rotate(acc, abar, flat, params)
    assert torch.equal(BR._blind_rotate_ref(acc, abar, flat, params, 0),
                       BR.blind_rotate_ref(acc, abar,
                                           BR.prepare_bk_ext(bk, params),
                                           params))


def test_rotdec_dispatch_writes_leaf_operands_on_cpu():
    """rotdec on CPU tensors at a depth-2 set returns the kernel's layout:
    the leaf operands of rotdec_ref's digits."""
    from cufhe_tpu_torch.benchmarks import rotdec as RD
    params = P.PALLAS_KAR
    acc, abar = RD.random_inputs(params, 3, 85, "cpu")
    got = BR.rotdec(acc, abar, params)
    assert tuple(got.shape) == (3, 9, 4, 128)
    assert torch.equal(got, BR.leaf_operands(BR.rotdec_ref(acc, abar, params),
                                             2))
