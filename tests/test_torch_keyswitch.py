"""cufhe_tpu_torch key switch and its KSK layouts against cufhe_tpu (JAX) and
the NumPy golden model, as uint32 equality: the kernel's layout (ksk_tiles)
and coefficient order (ks_stage_coeffs), the plain version of the kernel
(key_switch_ref), and a NumPy model of how the kernel builds its
coefficient words."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cufhe_tpu import golden as G
from cufhe_tpu import params as P
from cufhe_tpu.ops import keys as JK
from cufhe_tpu.ops import keyswitch as JKS
from cufhe_tpu.ops import poly as JP
from cufhe_tpu_torch import params as TP_
from cufhe_tpu_torch._build import H100_SMS
from cufhe_tpu_torch.ops import keys as TK
from cufhe_tpu_torch.ops import keyswitch as TKS
from cufhe_tpu_torch.ops import poly as TP
from cufhe_tpu_torch.torus import from_u32, to_u32

#: TINY and TINY_K2, a PALLAS_* set, and TINY_Q, whose key switch has
#: basebit 3 (four KSK rows a digit, 28 coefficient bytes an input)
KS_SETS = [P.TINY, P.TINY_K2, P.PALLAS_TINY, P.TINY_Q]


@pytest.fixture(scope="module", params=KS_SETS, ids=lambda p: p.name)
def setup(request):
    params = request.param
    sk = G.keygen(params, seed=40)
    ek = G.make_eval_key(sk, seed=41)
    jkeys = JK.prepare_keys(ek, backends=("conv",))
    tkeys = TK.prepare_keys(ek, "cpu")
    return params, ek, jkeys, tkeys


def _tlwe1(params, seed, rows=6):
    rng = np.random.default_rng(seed)
    d1 = params.lvl1.k * params.lvl1.n
    return rng.integers(0, 1 << 32, (rows, d1 + 1),
                        dtype=np.uint64).astype(np.uint32)


def _ks_params(t, basebit):
    """A small set whose only interest is its key switch shape."""
    return TP_.GateParams(name=f"ks-t{t}-b{basebit}", lvl0=TP_.LweParams(n=8),
                          lvl1=TP_.TrlweParams(nbit=5, k=1, l=2, Bgbit=6),
                          ks=TP_.KeySwitchParams(t=t, basebit=basebit))


def test_ksk_layout_matches_jax(setup):
    params, ek, jkeys, tkeys = setup
    n0 = params.lvl0.dim
    want = np.asarray(jkeys.ksk_limbs_sei.astype(jnp.float32)).astype(np.int8)
    got = TK.ksk_limbs_sei(ek.ksk, params)
    assert got.dtype == np.int8 and got.shape[2] == n0 + 1
    assert np.array_equal(got, want)
    assert torch.equal(tkeys.ksk_tiles,
                       TKS.ksk_tiles(torch.from_numpy(got), params))


@pytest.mark.parametrize("params", [TP_.TINY, TP_.TINY_K2, TP_.TINY_Q,
                                    TP_.CONCRETE, _ks_params(13, 1)],
                         ids=lambda p: p.name)
def test_ksk_tiles_against_ksk_limbs_sei(params):
    """Every byte of the kernel's layout: limb l, row (dig*nb + m)*d1 + j,
    column c of ksk_limbs_sei at [c // 64, s, l, c % 64, (j - sJ) P +
    dig*nb + m], s = j // J; zero everywhere else."""
    kp = params.ks
    t, nb = kp.t, kp.numbase
    d1, cols = params.lvl1.k * params.lvl1.n, params.lvl0.dim + 1
    P_, J, S, Mt = TKS.ks_layout(params)
    assert P_ % 4 == 0 and t * nb <= P_ < t * nb + 4 and J * P_ <= 128
    rng = np.random.default_rng(7)
    limbs = rng.integers(-128, 128, (4, t * nb * d1, cols), dtype=np.int8)
    got = TKS.ksk_tiles(torch.from_numpy(limbs), params).numpy()
    assert got.shape == (Mt, S, 4, 64, 128)
    l, dig, m, j, c = np.meshgrid(np.arange(4), np.arange(t), np.arange(nb),
                                  np.arange(d1), np.arange(cols),
                                  indexing="ij")
    at = (c // 64, j // J, l, c % 64, (j % J) * P_ + dig * nb + m)
    assert np.array_equal(got[at], limbs[l, (dig * nb + m) * d1 + j, c])
    mask = np.zeros(got.shape, dtype=bool)
    mask[at] = True
    assert not got[~mask].any()


def test_ks_decompose_coeffs(setup):
    """ks_stage_coeffs is the JAX package's ks_decompose_coeffs with its
    (dig, m, j)-major column (dig*nb + m)*d1 + j at byte (j // J) * 128 +
    (j % J) P + dig*nb + m of the kernel's stage order (ks_layout), and
    zero at every other byte."""
    params = setup[0]
    kp = params.ks
    d1 = params.lvl1.k * params.lvl1.n
    P_, J, S, _ = TKS.ks_layout(params)
    a_in = _tlwe1(params, 1)[:, :-1]
    got = TKS.ks_stage_coeffs(from_u32(a_in), params).numpy()
    jdec = np.asarray(JKS.ks_decompose_coeffs(jnp.asarray(a_in), params)
                      .astype(jnp.float32))
    dig, m, j = np.meshgrid(np.arange(kp.t), np.arange(kp.numbase),
                            np.arange(d1), indexing="ij")
    want = np.zeros((a_in.shape[0], S * 128), dtype=np.float32)
    want[:, ((j // J) * 128 + (j % J) * P_ + dig * kp.numbase + m).ravel()] \
        = jdec[:, ((dig * kp.numbase + m) * d1 + j).ravel()]
    assert got.dtype == np.int8
    assert np.array_equal(got.astype(np.float32), want)


def test_key_switch_after_extraction(setup):
    params, ek, jkeys, tkeys = setup
    lp = params.lvl1
    rng = np.random.default_rng(2)
    acc = rng.integers(0, 1 << 32, (5, lp.k + 1, lp.n),
                       dtype=np.uint64).astype(np.uint32)
    tl = TP.sample_extract_for_ks(from_u32(acc), lp)
    got = to_u32(TKS.key_switch(tl, tkeys.ksk_tiles, params))
    want_jax = np.asarray(JKS.key_switch(
        JP.sample_extract_for_ks(jnp.asarray(acc), lp), jkeys.ksk_limbs_sei,
        params))
    assert np.array_equal(got, want_jax)
    want = np.stack([G.key_switch(G.sample_extract_index0(a, lp), ek)
                     for a in acc])
    assert np.array_equal(got, want)


def test_key_switch_fused_pre_add(setup):
    params, ek, jkeys, tkeys = setup
    x, y = _tlwe1(params, 3), _tlwe1(params, 4)
    ca, cb, off = 1, (1 << 32) - 1, (-params.lvl1.mu) % (1 << 32)
    # the natural-order KSK: sample_extract_for_ks's permutation undone
    lp = params.lvl1
    perm = np.arange(lp.k * lp.n).reshape(lp.k, lp.n)
    perm = np.concatenate([perm[:, :1], perm[:, :0:-1]], axis=1).reshape(-1)
    inv = np.argsort(perm)
    limbs_nat = torch.from_numpy(TK.ksk_limbs_sei(ek.ksk[inv], params))
    pre = (ca, cb, off, from_u32(y))
    got = to_u32(TKS.key_switch(from_u32(x),
                                TKS.ksk_tiles(limbs_nat, params), params,
                                pre=pre))
    want_jax = np.asarray(JKS.key_switch(
        jnp.asarray(x), jkeys.ksk_limbs, params,
        pre=(np.uint32(ca), np.uint32(cb), np.uint32(off), jnp.asarray(y))))
    assert np.array_equal(got, want_jax)
    want = np.stack([G.key_switch(a, ek, pre=(ca, cb, off, b))
                     for a, b in zip(x, y)])
    assert np.array_equal(got, want)


def _jax_pre(pre):
    """A pre-add of key_switch's form as the JAX key switch takes it:
    uint32 scalars, per-row [B, 1] (ca, cb) and [B] (offset) arrays."""
    if pre is None:
        return None

    def u32(c, shape):
        if isinstance(c, torch.Tensor):
            return jnp.asarray(to_u32(c).reshape(shape))
        return np.uint32(c % (1 << 32))
    ca, cb, off, other = pre
    return (u32(ca, (-1, 1)), u32(cb, (-1, 1)), u32(off, (-1,)),
            jnp.asarray(to_u32(other)))


@pytest.mark.parametrize("rows", [1, 7, 17])
def test_key_switch_ref_equals_jax(setup, rows):
    """The plain version of the kernel, in its layout and contraction
    order, against the JAX package's key switch in its own layout: with
    and without the pre-add (int and per-row constants) and the sei_perm
    gather, at ragged row counts. Without the gather both read the
    sample-extract row order (ksk_limbs_sei); with it, the JAX key switch
    reads the natural-order KSK (ksk_limbs)."""
    params, ek, jkeys, tkeys = setup
    x, y = from_u32(_tlwe1(params, 5, rows)), from_u32(_tlwe1(params, 6, rows))
    per_row = torch.full((rows,), -5, dtype=torch.int32)
    for pre in (None, (1, -1, 12345, y), (per_row, 1, per_row, y)):
        for perm, jksk in ((None, jkeys.ksk_limbs_sei),
                           (tkeys.sei_perm, jkeys.ksk_limbs)):
            got = TKS.key_switch_ref(x, tkeys.ksk_tiles, params, pre, perm)
            want = JKS.key_switch(jnp.asarray(to_u32(x)), jksk, params,
                                  pre=_jax_pre(pre))
            assert np.array_equal(to_u32(got), np.asarray(want))
            assert torch.equal(got, TKS.key_switch(
                x, tkeys.ksk_tiles, params, pre, perm))


def _digit_word(idx, basebit):
    """csrc/keyswitch.cu:digit_word."""
    nb = 1 << (basebit - 1)
    spw = 4 // nb
    w = 0
    for e in range(spw):
        val = ((idx >> ((spw - 1 - e) * basebit))
               & ((1 << basebit) - 1)) - nb
        if val < 0:
            w |= 1 << (8 * (nb * e - val - 1))
        if val > 0:
            w |= 0xFF << (8 * (nb * e + val - 1))
    return w


def _kernel_coeff_tile(a, params):
    """The coefficient words keyswitch_kernel's producer writes, modelled
    in NumPy from its source: the digit table, each 16-byte chunk c's
    per-word map (coefficient jlo or jlo + 1 of the stage, shift, kept
    bytes) and the per-stage lookup, for every row and stage:
    [B, S * 128] int8."""
    kp = params.ks
    t, basebit = kp.t, kp.basebit
    nb = 1 << (basebit - 1)
    spw, tnb = 4 // nb, t * nb
    P_ = (tnb + 3) // 4 * 4
    J = 128 // P_
    B, d1 = a.shape
    S = -(-d1 // J)
    off = (kp.decomp_offset + kp.roundoffset) % (1 << 32)
    lut = np.array([_digit_word(i, basebit) for i in range(1 << spw * basebit)],
                   dtype=np.uint64)
    fmask = (1 << spw * basebit) - 1
    out = np.zeros((B, S, 32), dtype=np.uint32)
    assert P_ >= 8                     # the C entry refuses smaller
    for c in range(8):
        jlo = None
        for w in range(4):
            byte = 16 * c + 4 * w
            jl = byte // P_
            ob = byte - jl * P_
            keep = (0 if jl >= J or ob >= tnb else
                    (1 << 8 * (tnb - ob)) - 1 if ob + 4 > tnb else 0xFFFFFFFF)
            if keep and jlo is None:
                jlo = jl
            hi = int(bool(keep) and jl > jlo)
            assert not keep or jl - jlo == hi      # two coefficients a chunk
            sh = 32 - (ob // nb + spw) * basebit if keep else 0
            for s in range(S):
                j = s * J + (jlo or 0) + hi
                if keep == 0 or j >= d1:
                    continue
                x = (a[:, j].astype(np.uint64) + off) & 0xFFFFFFFF
                out[:, s, 4 * c + w] = lut[(x >> sh) & fmask] & keep
    return out.reshape(B, -1).view(np.int8)


@pytest.mark.parametrize("params", [TP_.TINY, TP_.TINY_Q, TP_.TINY_K2,
                                    TP_.CONCRETE, _ks_params(13, 1),
                                    _ks_params(30, 1), _ks_params(15, 2),
                                    _ks_params(10, 3)],
                         ids=lambda p: p.name)
def test_kernel_coefficient_words_model(params):
    """t*numbase of 8 to 40, basebit 1 to 3, stages with padding words and
    words cut at t*numbase: the kernel's words equal ks_stage_coeffs."""
    rng = np.random.default_rng(8)
    d1 = params.lvl1.k * params.lvl1.n
    a = rng.integers(0, 1 << 32, (4, d1), dtype=np.uint64).astype(np.uint32)
    a[0] = 0
    a[1] = 0xFFFFFFFF
    assert np.array_equal(_kernel_coeff_tile(a, params),
                          TKS.ks_stage_coeffs(from_u32(a), params).numpy())


@pytest.mark.parametrize("params", [TP_.TFHEPP_128, TP_.CONCRETE, TP_.TINY,
                                    TP_.TINY_Q, TP_.RADIX4_2048],
                         ids=lambda p: p.name)
@pytest.mark.parametrize("rows", [1, 48, 64, 65, 160, 480, 4096])
def test_ks_plan_covers_every_stage_once(params, rows):
    """ks_plan's row tile and split, and the kernel's ranges (z*S/Z ..
    (z+1)*S/Z, csrc/keyswitch.cu) cover the S stages once, none empty;
    where the tiles alone leave SMs idle the split fills at least half
    (or cuts every stage apart)."""
    row_tile, split = TKS.ks_plan(rows, params)
    assert row_tile == (64 if rows <= 64 else 128)
    _, _, S, Mt = TKS.ks_layout(params)
    assert 1 <= split <= S
    bounds = [z * S // split for z in range(split + 1)]
    assert bounds[0] == 0 and bounds[-1] == S
    assert all(b1 > b0 for b0, b1 in zip(bounds, bounds[1:]))
    blocks = Mt * -(-rows // row_tile)
    if blocks < H100_SMS:
        assert blocks * split >= min(H100_SMS // 2, blocks * S)


def test_ks_plan_at_aes_and_nand_shapes():
    """tfhepp_128bit: 10 column tiles, 128 stages; a 160-row AES step
    splits 6 ways (120 blocks), a 4096-row NAND call 2 ways."""
    assert TKS.ks_layout(TP_.TFHEPP_128) == (16, 8, 128, 10)
    assert TKS.ks_plan(160, TP_.TFHEPP_128) == (128, 6)
    assert TKS.ks_plan(4096, TP_.TFHEPP_128) == (128, 2)
    assert TKS.ks_layout(TP_.CONCRETE) == (12, 10, 103, 10)
