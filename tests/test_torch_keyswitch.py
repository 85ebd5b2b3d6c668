"""cufhe_tpu_torch key switch and its KSK layout against cufhe_tpu (JAX) and
the NumPy golden model, as uint32 equality."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cufhe_tpu import golden as G
from cufhe_tpu import params as P
from cufhe_tpu.ops import keys as JK
from cufhe_tpu.ops import keyswitch as JKS
from cufhe_tpu.ops import poly as JP
from cufhe_tpu_torch.ops import keys as TK
from cufhe_tpu_torch.ops import keyswitch as TKS
from cufhe_tpu_torch.ops import poly as TP
from cufhe_tpu_torch.torus import from_u32, to_u32


@pytest.fixture(scope="module", params=[P.TINY, P.TINY_K2],
                ids=lambda p: p.name)
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


def test_ksk_layout_matches_jax(setup):
    params, ek, jkeys, tkeys = setup
    n0 = params.lvl0.dim
    want = np.asarray(jkeys.ksk_limbs_sei.astype(jnp.float32)).astype(np.int8)
    got = tkeys.ksk_limbs_sei.numpy()
    assert got.dtype == np.int8 and got.shape[2] == n0 + 1
    assert np.array_equal(got, want)


def test_ks_decompose_coeffs(setup):
    params = setup[0]
    a_in = _tlwe1(params, 1)[:, :-1]
    got = TKS.ks_decompose_coeffs(from_u32(a_in), params).numpy()
    want = np.asarray(JKS.ks_decompose_coeffs(jnp.asarray(a_in), params)
                      .astype(jnp.float32))
    assert got.dtype == np.int8
    assert np.array_equal(got.astype(np.float32), want)


def test_key_switch_after_extraction(setup):
    params, ek, jkeys, tkeys = setup
    lp = params.lvl1
    rng = np.random.default_rng(2)
    acc = rng.integers(0, 1 << 32, (5, lp.k + 1, lp.n),
                       dtype=np.uint64).astype(np.uint32)
    tl = TP.sample_extract_for_ks(from_u32(acc), lp)
    got = to_u32(TKS.key_switch(tl, tkeys.ksk_limbs_sei, params))
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
    ksk_nat = torch.from_numpy(TK.ksk_limbs_sei(ek.ksk[inv], params))
    got = to_u32(TKS.key_switch(from_u32(x), ksk_nat, params,
                                pre=(ca, cb, off, from_u32(y))))
    want_jax = np.asarray(JKS.key_switch(
        jnp.asarray(x), jkeys.ksk_limbs, params,
        pre=(np.uint32(ca), np.uint32(cb), np.uint32(off), jnp.asarray(y))))
    assert np.array_equal(got, want_jax)
    want = np.stack([G.key_switch(a, ek, pre=(ca, cb, off, b))
                     for a, b in zip(x, y)])
    assert np.array_equal(got, want)
