"""The `ntt` backend of cufhe_tpu_torch (ops/ntt.py and the RAINTT-prime
blind rotation of ops/bootstrap.py) on the CPU, against cufhe_tpu.ops.ntt
and the JAX package's backend="ntt" path: the same numpy-seeded inputs
through both, compared as uint32 (no tolerance), and the transforms
against a naive negacyclic product."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cufhe_tpu import golden as JG
from cufhe_tpu.models import IntContext as JIntContext
from cufhe_tpu.models import api as JA
from cufhe_tpu.models import encrypt_uint as j_encrypt_uint
from cufhe_tpu.ops import bootstrap as JB
from cufhe_tpu.ops import keys as JK
from cufhe_tpu.ops import ntt as JN
from cufhe_tpu_torch import (Context, TrlweCtxt, decrypt_bits, encrypt_bits,
                             golden as G)
from cufhe_tpu_torch.models import IntContext, decrypt_uint, encrypt_uint
from cufhe_tpu_torch.ops import blind_rotate as BR
from cufhe_tpu_torch.ops import bootstrap as TB
from cufhe_tpu_torch.ops import keys as TK
from cufhe_tpu_torch.ops import ntt as TN
from cufhe_tpu_torch.torus import from_u32, to_u32

P = TN.P
_M32 = (1 << 32) - 1


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Intra-op threads off while this module runs: the suite runs several
    worker processes on the same cores, where torch's thread pool spends
    its time waiting for its own threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x: np.ndarray) -> torch.Tensor:
    """uint32 values as the port's int64 operand."""
    return torch.from_numpy(np.asarray(x, dtype=np.uint32).astype(np.int64))


def _u(x: torch.Tensor) -> np.ndarray:
    out = x.numpy()
    assert out.min() >= 0 and out.max() <= _M32
    return out.astype(np.uint32)


def _words(rng, n, hi=1 << 32, extremes=(0, P - 1, _M32)):
    """n random values below hi, with the extremes below hi first."""
    v = rng.integers(0, hi, n, dtype=np.uint64).astype(np.uint32)
    ext = [e for e in extremes if e < hi]
    v[:len(ext)] = ext
    return v


# -- the helpers, one for one ------------------------------------------------

@pytest.mark.parametrize("nbit", [6, 10])
def test_make_tables_equal_original(nbit):
    mine, theirs = TN.make_tables(nbit), JN.make_tables(nbit)
    assert sorted(mine) == sorted(theirs)
    for name in mine:
        assert np.array_equal(mine[name], theirs[name]), name
        assert np.asarray(mine[name]).dtype == np.uint32, name
    assert TN._find_generator() == JN._find_generator()


def test_mulhi_u32_equals_original():
    rng = np.random.default_rng(1)
    a, b = _words(rng, 4096), _words(rng, 4096)[::-1].copy()
    got = _u(TN._mulhi_u32(_t(a), _t(b)))
    assert np.array_equal(got, np.asarray(JN._mulhi_u32(jnp.asarray(a),
                                                        jnp.asarray(b))))
    assert np.array_equal(got, ((a.astype(np.uint64) * b) >> 32).astype(
        np.uint32))


def test_shoup_add_sub_equal_original():
    """mulmod_shoup on x < p (the path's domain) with twiddles w < p;
    addmod and submod on values < p and on uint32 extremes, where the JAX
    functions wrap mod 2^32."""
    rng = np.random.default_rng(2)
    x, w = _words(rng, 4096, P), _words(rng, 4096, P)[::-1].copy()
    ws = TN.shoup_precompute(w)
    assert np.array_equal(ws, JN.shoup_precompute(w))
    got = _u(TN.mulmod_shoup(_t(x), _t(w), _t(ws)))
    assert np.array_equal(got, np.asarray(JN.mulmod_shoup(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(ws))))
    assert np.array_equal(got, (x.astype(np.uint64) * w % P).astype(
        np.uint32))
    for a, b in ((x, w), (_words(rng, 4096), _words(rng, 4096)[::-1].copy())):
        for mine, theirs in ((TN.addmod, JN.addmod), (TN.submod, JN.submod)):
            assert np.array_equal(_u(mine(_t(a), _t(b))), np.asarray(
                theirs(jnp.asarray(a), jnp.asarray(b))))


def test_torus_switches_equal_original():
    rng = np.random.default_rng(3)
    a = _words(rng, 8192)
    got = _u(TN.torus_to_mod(_t(a)))
    assert np.array_equal(got, np.asarray(JN.torus_to_mod(jnp.asarray(a))))
    assert np.array_equal(got, TN.torus_to_mod_host(a))
    assert np.array_equal(TN.torus_to_mod_host(a), JN.torus_to_mod_host(a))
    m = _words(rng, 8192, P)
    got = _u(TN.mod_to_torus_jax(_t(m)))
    assert np.array_equal(got, np.asarray(JN.mod_to_torus_jax(
        jnp.asarray(m))))
    exact = TN.mod_to_torus(m)
    assert np.array_equal(exact, JN.mod_to_torus(m))
    diff = np.minimum(got - exact, exact - got)       # wraps as uint32
    assert diff.max() <= 2
    # and on uint32 inputs beyond p, still equal to the JAX function
    assert np.array_equal(_u(TN.mod_to_torus_jax(_t(a))), np.asarray(
        JN.mod_to_torus_jax(jnp.asarray(a))))


@pytest.mark.parametrize("nbit", [4, 10])
def test_transforms_equal_original(nbit):
    """Forward equals the host forward (and the JAX one, whose eager
    stages are held to it at the short length); inverse undoes it."""
    tab = TN.make_tables(nbit)
    rng = np.random.default_rng(4 + nbit)
    a = rng.integers(0, P, (3, 2, 1 << nbit)).astype(np.uint32)
    a[0, 0, :2] = (0, P - 1)
    fwd = TN.ntt_forward(_t(a), tab)
    assert np.array_equal(_u(fwd), TN.ntt_forward_host(a, tab))
    assert np.array_equal(TN.ntt_forward_host(a, tab),
                          JN.ntt_forward_host(a, JN.make_tables(nbit)))
    back = TN.ntt_inverse(fwd, tab)
    assert np.array_equal(_u(back), a)
    if nbit <= 4:
        jt = JN.make_tables(nbit)
        assert np.array_equal(_u(fwd), np.asarray(JN.ntt_forward(
            jnp.asarray(a), jt)))
        perturbed = (_u(fwd) + np.uint32(7)) % np.uint32(P)
        assert np.array_equal(_u(TN.ntt_inverse(_t(perturbed), tab)),
                              np.asarray(JN.ntt_inverse(
                                  jnp.asarray(perturbed), jt)))


def _naive_negacyclic(a, b):
    n = len(a)
    out = np.zeros(n, dtype=object)
    for i in range(n):
        for j in range(n):
            s = int(a[i]) * int(b[j])
            if i + j < n:
                out[i + j] += s
            else:
                out[i + j - n] -= s
    return np.array([v % P for v in out], dtype=np.uint32)


def test_negacyclic_mul_mod_p_vs_naive():
    nbit, N = 7, 128
    tab = TN.make_tables(nbit)
    rng = np.random.default_rng(5)
    for _ in range(2):
        a = rng.integers(0, P, N).astype(np.uint32)
        b = rng.integers(0, P, N).astype(np.uint32)
        b_ntt = TN.ntt_forward_host(b, tab)
        got = TN.negacyclic_mul_mod_p(_t(a)[None], _t(b_ntt)[None],
                                      _t(TN.shoup_precompute(b_ntt))[None],
                                      tab)
        assert np.array_equal(_u(got[0]), _naive_negacyclic(a, b))


def test_device_keys_hold_the_jax_ntt_key(tiny_key):
    sk, ek = tiny_key
    mine = TK.prepare_keys(ek, "cpu", ("ntt",))
    theirs = JK.prepare_keys(ek, backends=("ntt",))
    assert np.array_equal(to_u32(mine.bk_ntt), np.asarray(theirs.bk_ntt))
    assert np.array_equal(to_u32(mine.bk_ntt_shoup),
                          np.asarray(theirs.bk_ntt_shoup))
    assert mine.bk_ext.numel() == 0 and mine.ksk_tiles.numel() > 0
    exact = TK.prepare_keys(ek, "cpu")
    assert exact.bk_ntt.numel() == 0 and exact.bk_ext.numel() > 0


# -- the gate ------------------------------------------------------------------

@pytest.mark.parametrize("key", ["tiny_key", "tiny_k2_key"])
def test_gate_lvl0_ntt_equals_original(key, request, monkeypatch):
    """backend="ntt" through the port's ops equals the JAX package's, and
    never reaches the exact blind rotation."""
    sk, ek = request.getfixturevalue(key)
    p = sk.params
    rng = np.random.default_rng(60)
    c0 = JG.encrypt_bit_batch([0, 1, 0, 1, 1, 0], sk, rng)
    c1 = JG.encrypt_bit_batch([0, 0, 1, 1, 1, 1], sk, rng)
    want = np.asarray(JB.gate_lvl0(
        JG.GATE_CONSTANTS["nand"], jnp.asarray(c0), jnp.asarray(c1),
        JK.prepare_keys(ek, backends=("ntt",)), p, backend="ntt"))

    def exact(*_):
        raise AssertionError("the ntt path ran the exact blind rotation")
    monkeypatch.setattr(BR, "blind_rotate", exact)
    got = TB.gate_lvl0(JG.GATE_CONSTANTS["nand"], from_u32(c0),
                       from_u32(c1), TK.prepare_keys(ek, "cpu", ("ntt",)), p,
                       "ntt")
    assert np.array_equal(to_u32(got), want)
    assert G.decrypt_bit_batch(to_u32(got), sk).tolist() == \
        [1, 1, 1, 0, 0, 1]


def test_ntt_phase_envelope(tiny_key):
    """tests/test_ntt.py's envelope on the port: the ntt NAND decrypts to
    the truth table and its phase stays within 2^27 of the exact path's
    (golden), as the JAX test states for the same inputs."""
    rng = np.random.default_rng(77)
    sk, ek = tiny_key
    keys = TK.prepare_keys(ek, "cpu", ("ntt",))
    bits0, bits1 = [0, 1, 0, 1], [0, 0, 1, 1]
    c0 = [G.encrypt_bit(b, sk, rng) for b in bits0]
    c1 = [G.encrypt_bit(b, sk, rng) for b in bits1]
    got = to_u32(TB.gate_lvl0(G.GATE_CONSTANTS["nand"],
                              from_u32(np.stack(c0)), from_u32(np.stack(c1)),
                              keys, sk.params, "ntt"))
    assert [G.decrypt_bit(g, sk) for g in got] == \
        [1 - (a & b) for a, b in zip(bits0, bits1)]
    want = np.stack([G.gate_lvl0("nand", a, b, ek) for a, b in zip(c0, c1)])
    ph_g = np.array([G.tlwe_phase(g, sk.lvl0) for g in got], dtype=np.uint32)
    ph_w = np.array([G.tlwe_phase(w, sk.lvl0) for w in want],
                    dtype=np.uint32)
    diff = np.minimum(ph_g - ph_w, ph_w - ph_g).astype(np.int64)
    assert diff.max() < (1 << 27), diff.max()


# -- Context(ek, "ntt") against JA.Context(ek, backend="ntt") ---------------

@pytest.fixture(scope="module")
def ntt_contexts(tiny_key):
    sk, ek = tiny_key
    return sk, ek, Context(ek, "ntt", device="cpu"), JA.Context(ek, "ntt")


def _j(ct):
    return JA.Ctxt(jnp.asarray(to_u32(ct.data)), ct.level)


@pytest.mark.parametrize("level", [0, 1])
def test_context_ntt_gates_equal_original(level, ntt_contexts):
    sk, ek, ctx, jctx = ntt_contexts
    rng = np.random.default_rng(61 + level)
    bits0, bits1, bitsc = [0, 1, 0, 1], [0, 0, 1, 1], [1, 1, 0, 0]
    a, b, c = (encrypt_bits(x, sk, rng, level, device="cpu")
               for x in (bits0, bits1, bitsc))
    for name in ("nand", "xor"):
        out = ctx.gate(name, a, b)
        assert np.array_equal(to_u32(out.data), np.asarray(
            jctx.gate(name, _j(a), _j(b)).data)), name
        assert decrypt_bits(out, sk).tolist() == \
            [G.PLAIN_GATES[name](x, y) for x, y in zip(bits0, bits1)]
    mux = ctx.mux(c, a, b)
    assert np.array_equal(to_u32(mux.data), np.asarray(
        jctx.mux(_j(c), _j(a), _j(b)).data))
    assert decrypt_bits(mux, sk).tolist() == [0, 1, 1, 1]


def test_context_ntt_refresh_and_pbs_many_equal_original(ntt_contexts):
    sk, ek, ctx, jctx = ntt_contexts
    lp = sk.params.lvl1
    rng = np.random.default_rng(63)
    tr = np.stack([G.trlwe_encrypt_zero(lp, sk.lvl1, rng) for _ in range(3)])
    got = ctx.refresh(TrlweCtxt(from_u32(tr)))
    assert np.array_equal(to_u32(got.data), np.asarray(
        jctx.refresh(JA.TrlweCtxt(jnp.asarray(tr))).data))
    a = encrypt_bits([0, 1, 1], sk, rng, device="cpu")
    tv = rng.integers(0, 1 << 32, lp.n, dtype=np.uint64).astype(np.uint32)
    many = TB.pbs_many(a.data, from_u32(tv), 2, ctx.keys, sk.params, "ntt",
                       theta=1)
    assert np.array_equal(to_u32(many), np.asarray(JB.pbs_many(
        jnp.asarray(to_u32(a.data)), jnp.asarray(tv), 2, jctx.keys,
        sk.params, "ntt", theta=1)))


def test_context_ntt_int_add_equals_original(ntt_contexts):
    sk, ek, ctx, jctx = ntt_contexts
    xs, ys = [3, 9, 15, 6], [4, 8, 1, 10]
    x = encrypt_uint(xs, 4, sk, rng=np.random.default_rng(64), device="cpu")
    y = encrypt_uint(ys, 4, sk, rng=np.random.default_rng(65), device="cpu")
    got = IntContext(ctx).add(x, y)
    want = JIntContext(jctx).add(
        j_encrypt_uint(xs, 4, sk, rng=np.random.default_rng(64)),
        j_encrypt_uint(ys, 4, sk, rng=np.random.default_rng(65)))
    assert np.array_equal(to_u32(got.digits), np.asarray(want.digits))
    assert decrypt_uint(got, sk) == [(u + v) % 16 for u, v in zip(xs, ys)]


def test_ntt_key_lifecycle(tiny_key):
    """An ntt context holds no exact key; release_keys(("ntt",)) makes its
    gates raise (there is no silent exact path) and prepare_backend(ek,
    "ntt") restores them bit-exactly."""
    sk, ek = tiny_key
    ctx = Context(ek, "ntt", device="cpu")
    assert ctx.keys.bk_ext.numel() == 0
    rng = np.random.default_rng(66)
    a, b = (encrypt_bits(x, sk, rng, device="cpu")
            for x in ([1, 0, 1], [1, 1, 0]))
    before = ctx.nand(a, b)
    ctx.release_keys(("ntt",))
    assert ctx.keys.bk_ntt.numel() == ctx.keys.bk_ntt_shoup.numel() == 0
    with pytest.raises(ValueError, match="release_keys"):
        ctx.nand(a, b)
    ctx.prepare_backend(ek, "ntt")
    assert ctx.keys.bk_ext.numel() == 0
    assert torch.equal(ctx.nand(a, b).data, before.data)


def _jax_noise_bench():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parent.parent / "benchmarks" / \
        "noise.py"
    spec = importlib.util.spec_from_file_location("jax_noise_bench", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("backend", ["auto", "ntt"])
def test_noise_bench_records_on_the_cpu(backend, tiny_key):
    """benchmarks.noise keeps the JAX bench's floors and predicate, and its
    records on the CPU at TINY: no decrypt error, margins measured."""
    from cufhe_tpu_torch.benchmarks import noise as TNB
    jnb = _jax_noise_bench()
    assert TNB.MARGIN_FLOORS == jnb.MARGIN_FLOORS
    assert TNB.INT_MARGIN_FLOORS == jnb.INT_MARGIN_FLOORS
    for sig, floor in ((6.3, 6.0), (5.9, 6.0), (1.0, None), (None, 6.0)):
        assert TNB.margin_ok(sig, floor) == jnb.margin_ok(sig, floor)
    sk, ek = tiny_key
    rec = TNB.measure_noise(sk.params, backend, 16, ek, sk, device="cpu")
    assert rec["backend"] == backend and rec["batch"] == 16
    assert rec["decrypt_errors"] == rec["xor_of_bootstrapped_errors"] == 0
    assert rec["worst_gate_margin_sigmas"] > 2
    rows = TNB.measure_cmux_tree_noise(sk.params, backend, 2, 2, ek, sk,
                                       device="cpu")
    assert [r["depth"] for r in rows] == [1, 2]
    assert all(r["slot_errors"] == 0 for r in rows)
