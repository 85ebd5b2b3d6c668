"""cufhe_tpu_torch torus helpers and ops/poly.py against their cufhe_tpu (JAX)
counterparts and the NumPy golden model. Every comparison is uint32
equality: the arithmetic is exact integer arithmetic mod 2^32."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cufhe_tpu import golden as G
from cufhe_tpu import params as P
from cufhe_tpu.ops import poly as JP
from cufhe_tpu_torch import torus
from cufhe_tpu_torch.ops import poly as TP
from cufhe_tpu_torch.torus import from_u32, to_u32

PRESETS = [P.TINY, P.TINY_K2, P.PALLAS_BG10]


def _u32(rng, shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def _jax(x):
    return np.asarray(x)


def test_u32_roundtrip_and_i32():
    rng = np.random.default_rng(0)
    x = np.concatenate([_u32(rng, 64),
                        np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1],
                                 dtype=np.uint32)])
    t = from_u32(x)
    assert t.dtype == torch.int32
    assert np.array_equal(to_u32(t), x)
    for c in (0, 1, -1, 2**31, -2**31, 2**32 + 5, (-3) * (1 << 29)):
        v = torus.i32(c)
        assert -2**31 <= v < 2**31 and (v - c) % (1 << 32) == 0


@pytest.mark.parametrize("s", [1, 4, 21, 22, 31])
def test_srl_is_logical(s):
    rng = np.random.default_rng(s)
    x = np.concatenate([_u32(rng, 256),
                        np.array([2**31, 2**32 - 1], dtype=np.uint32)])
    assert np.array_equal(to_u32(torus.srl(from_u32(x), s)),
                          x >> np.uint32(s))


@pytest.mark.parametrize("shape", [(4, 637, 17), (40, 64, 24), (3, 5, 7)])
def test_int_mm_exact(shape):
    M, K, N = shape
    rng = np.random.default_rng(M * K)
    a = rng.integers(-128, 128, (M, K)).astype(np.int8)
    b = rng.integers(-128, 128, (K, N)).astype(np.int8)
    got = torus.int_mm(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32 and tuple(got.shape) == (M, N)
    assert np.array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64))


@pytest.mark.parametrize("params", PRESETS, ids=lambda p: p.name)
def test_batched_test_vector(params):
    lp = params.lvl1
    N = lp.n
    bar = np.array([1, 2, N - 1, N, N + 1, 2 * N - 1, 2 * N, 7],
                   dtype=np.uint32)
    mu = lp.mu
    got = to_u32(TP.batched_test_vector(from_u32(bar), mu, lp))
    assert np.array_equal(got, _jax(JP.batched_test_vector(
        jnp.asarray(bar), mu, lp)))
    want = np.stack([G.rotated_test_vector(lp, int(b), mu) for b in bar])
    assert np.array_equal(got, want)


@pytest.mark.parametrize("params", PRESETS, ids=lambda p: p.name)
def test_rotate_by_xai(params):
    lp = params.lvl1
    rng = np.random.default_rng(1)
    acc = _u32(rng, (6, lp.k + 1, lp.n))
    a_bar = np.array([0, 1, lp.n - 1, lp.n, lp.n + 3, 2 * lp.n - 1],
                     dtype=np.uint32)
    got = to_u32(TP.rotate_by_xai(from_u32(acc), from_u32(a_bar), lp))
    assert np.array_equal(got, _jax(JP.rotate_by_xai(
        jnp.asarray(acc), jnp.asarray(a_bar), lp)))
    want = np.stack([np.stack([G._rotate_by_xai(acc[b, j], int(a_bar[b]), lp)
                               for j in range(lp.k + 1)])
                     for b in range(len(a_bar))])
    assert np.array_equal(got, want)


@pytest.mark.parametrize("params", PRESETS, ids=lambda p: p.name)
def test_decompose_and_rotate_sub(params):
    lp = params.lvl1
    rng = np.random.default_rng(2)
    acc = _u32(rng, (5, lp.k + 1, lp.n))
    a_bar = rng.integers(0, 2 * lp.n, 5).astype(np.uint32)
    got = TP.decompose_rotate_sub(from_u32(acc), from_u32(a_bar), lp)
    assert got.dtype == torch.int32
    got = got.numpy()
    assert np.array_equal(got, _jax(JP.decompose_rotate_sub(
        jnp.asarray(acc), jnp.asarray(a_bar), lp)))
    want = np.stack([G.decompose_rotate_sub(acc[b], int(a_bar[b]), lp)
                     .reshape((lp.k + 1) * lp.l, lp.n) for b in range(5)])
    assert np.array_equal(got, want)
    temp = _u32(rng, (3, lp.k + 1, lp.n))
    assert np.array_equal(TP.decompose(from_u32(temp), lp).numpy(),
                          _jax(JP.decompose(jnp.asarray(temp), lp)))


@pytest.mark.parametrize("Bgbit", [6, 8, 10])
def test_split_decomp_digits(Bgbit):
    rng = np.random.default_rng(Bgbit)
    half = 1 << (Bgbit - 1)
    dec = rng.integers(-half, half, (4, 6, 32)).astype(np.int32)
    got, bits = TP.split_decomp_digits(torch.from_numpy(dec), Bgbit)
    want, wbits = JP.split_decomp_digits(jnp.asarray(dec), Bgbit)
    assert bits == wbits and len(got) == len(want)
    rec = np.zeros(dec.shape, dtype=np.int64)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.int8
        assert np.array_equal(g.numpy(), _jax(w))
        rec += g.numpy().astype(np.int64) << (bits * i)
    assert np.array_equal(rec, dec)


@pytest.mark.parametrize("params", PRESETS, ids=lambda p: p.name)
def test_negacyclic_conv_toeplitz(params):
    from cufhe_tpu.ops.limbs import u32_to_signed_limbs
    lp = params.lvl1
    rng = np.random.default_rng(3)
    I = (lp.k + 1) * lp.l
    dec8 = rng.integers(-32, 32, (3, I, lp.n)).astype(np.int8)
    bk = _u32(rng, (I, lp.k + 1, lp.n))
    limbs = np.moveaxis(u32_to_signed_limbs(bk), 3, 0)     # [L, I, k+1, N]
    got = to_u32(TP.negacyclic_conv_toeplitz(
        torch.from_numpy(dec8), torch.from_numpy(np.ascontiguousarray(limbs)),
        lp.k))
    assert np.array_equal(got, _jax(JP.negacyclic_conv_toeplitz(
        jnp.asarray(dec8), jnp.asarray(limbs), lp.k)))
    want = np.zeros((3, lp.k + 1, lp.n), dtype=np.int64)
    for b in range(3):
        for i in range(I):
            for o in range(lp.k + 1):
                want[b, o] += G.negacyclic_polymul(dec8[b, i], bk[i, o])
    assert np.array_equal(got, want.astype(np.uint32))


@pytest.mark.parametrize("params", [P.TINY, P.TINY_K2], ids=lambda p: p.name)
def test_sample_extract(params):
    lp = params.lvl1
    rng = np.random.default_rng(4)
    acc = _u32(rng, (4, lp.k + 1, lp.n))
    got0 = to_u32(TP.sample_extract_index0(from_u32(acc), lp))
    assert np.array_equal(got0, _jax(JP.sample_extract_index0(
        jnp.asarray(acc), lp)))
    assert np.array_equal(got0, np.stack([G.sample_extract_index0(a, lp)
                                          for a in acc]))
    got = to_u32(TP.sample_extract_for_ks(from_u32(acc), lp))
    assert np.array_equal(got, _jax(JP.sample_extract_for_ks(
        jnp.asarray(acc), lp)))
