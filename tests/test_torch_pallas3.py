"""The reduced-precision `pallas3` backend of cufhe_tpu_torch on the CPU,
against the JAX package's `pallas3` (its Pallas kernel in interpret mode,
as tests/test_pallas.py runs it): the three-limb key against prepare_wext,
the plain blind rotation and the gates bit for bit as uint32 at
PALLAS_TINY, PALLAS_TINY_K2 and PALLAS_BG10 (nd = 2: each digit row
contracts against its own truncated pre-scaled key row), the warning, the
key lifecycle, the layers above the Context (integers, the executor,
TOY8, a two-shard mesh) on the three-limb key, and the refusals."""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cufhe_tpu import golden as G
from cufhe_tpu import params as P
from cufhe_tpu.models import api as JA
from cufhe_tpu.ops import bootstrap as JB
from cufhe_tpu.ops import keys as JK
from cufhe_tpu.ops.pallas_br import BK_COPIES, prepare_wext
from cufhe_tpu_torch import Context, Ctxt, decrypt_bits, encrypt_bits
from cufhe_tpu_torch.models import IntContext, decrypt_uint, encrypt_uint
from cufhe_tpu_torch.models import processor as TOY
from cufhe_tpu_torch.ops import blind_rotate as BR
from cufhe_tpu_torch.ops import bootstrap as TB
from cufhe_tpu_torch.ops import keys as TK
from cufhe_tpu_torch.ops.limbs import decomp_digit_limb_plan
from cufhe_tpu_torch.parallel import data_mesh
from cufhe_tpu_torch.runtime import build_ripple_adder, run_schedule
from cufhe_tpu_torch.torus import from_u32, to_u32

PALLAS_PRESETS = [P.PALLAS_TINY, P.PALLAS_TINY_K2, P.PALLAS_BG10]
IDS = [p.name for p in PALLAS_PRESETS]
BITS0, BITS1, BITSC = [0, 1, 0, 1], [0, 0, 1, 1], [1, 0, 1, 0]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Intra-op threads off while this module runs: the suite runs several
    worker processes on the same cores, where torch's thread pool spends
    its time waiting for its own threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keys(params, seed):
    sk = G.keygen(params, seed=seed)
    return sk, G.make_eval_key(sk, seed=seed + 1)


def _quiet_context(ek, backend="pallas3", **kw) -> Context:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return Context(ek, backend, device="cpu", **kw)


@pytest.fixture(scope="module", params=PALLAS_PRESETS, ids=IDS)
def keyed(request):
    """(sk, ek, the port's pallas3 context, the JAX package's pallas3 keys)
    at one preset."""
    sk, ek = _keys(request.param, 40 + PALLAS_PRESETS.index(request.param))
    return sk, ek, _quiet_context(ek), JK.prepare_keys(
        ek, backends=("pallas3",))


@pytest.mark.parametrize("params", PALLAS_PRESETS, ids=IDS)
def test_bk_ext_three_limbs_are_the_top_three(params):
    """The three-limb key is limbs 1-3 of the four-limb one; its windows
    are the JAX prepare_wext(nlimbs=3) columns, limb for limb; the limbs
    recombine to each pre-scaled generator less its low balanced limb."""
    _, ek = _keys(params, 30)
    ext3 = BR.prepare_bk_ext(from_u32(ek.bk), params, 3).numpy()
    ext4 = BR.prepare_bk_ext(from_u32(ek.bk), params).numpy()
    n0, I0, kp1, N = ek.bk.shape
    nd, dbits = decomp_digit_limb_plan(params.lvl1.Bgbit)
    I = I0 * nd
    assert ext3.dtype == np.int8 and ext3.shape == (n0, I, kp1, 3, 2 * N)
    assert np.array_equal(ext3, ext4[:, :, :, 1:])
    wext = prepare_wext(ek.bk, params, nlimbs=3, depth=0)
    for o in range(kp1):
        for li in range(3):
            for j in range(I):
                col = BK_COPIES * ((o * 3 + li) * I + j)
                assert np.array_equal(ext3[:, j, o, li], wext[:, :, col])
    rec = sum(ext3[:, :, :, li].astype(np.int64) << (8 * (li + 1))
              for li in range(3))
    full = ((rec + ext4[:, :, :, 0]) % (1 << 32)).astype(np.uint32)
    for dl in range(nd):
        bk = ek.bk << np.uint32(dbits * dl)
        want = np.concatenate([np.zeros_like(bk) - bk, bk], axis=-1)
        assert np.array_equal(full[:, dl::nd], want)


@pytest.mark.parametrize("params", PALLAS_PRESETS, ids=IDS)
def test_plain_rotation_equals_jax_pallas3(params):
    """The plain blind rotation with the three-limb key equals the JAX
    package's pallas3 rotation (Pallas, interpret mode) as uint32, and
    is not the exact rotation."""
    sk, ek = _keys(params, 60)
    cts = G.encrypt_bit_batch([0, 1, 1, 0, 1], sk, np.random.default_rng(61))
    n0, mu = params.n0, params.lvl1.mu
    a, b = from_u32(cts[:, :n0]), from_u32(cts[:, n0])
    keys3 = TK.prepare_keys(ek, "cpu", ("pallas3",))
    got = to_u32(TB.blind_rotate(a, b, mu, keys3, params, "pallas3"))
    want = np.asarray(JB.blind_rotate(
        jnp.asarray(cts[:, :n0]), jnp.asarray(cts[:, n0]), mu,
        JK.prepare_keys(ek, backends=("pallas3",)), params, "pallas3"))
    assert np.array_equal(got, want)
    exact = to_u32(TB.blind_rotate(a, b, mu, TK.prepare_keys(ek, "cpu"),
                                   params))
    assert not np.array_equal(got, exact)


def test_plain_product_uses_each_pre_scaled_row():
    """At nd = 2 the three-limb product of sub-digit row dl reads key row
    r*nd + dl (bk << dbits*dl, truncated), which is not the truncated bk
    shifted: the trap a shift-after-truncation plain version falls in."""
    params = P.PALLAS_BG10
    _, ek = _keys(params, 70)
    nd, dbits = decomp_digit_limb_plan(params.lvl1.Bgbit)
    ext3 = BR.prepare_bk_ext(from_u32(ek.bk), params, 3)
    lim = [sum(ext3[0, dl::nd, :, li].long() << (8 * (li + 1))
               for li in range(3)) for dl in range(nd)]
    assert not torch.equal(lim[1] % (1 << 32), (lim[0] << dbits) % (1 << 32))


@pytest.mark.parametrize("params", [P.TINY, P.TINY_K2, P.PALLAS_BG10],
                         ids=lambda p: p.name)
def test_four_limb_plain_version_equals_the_independent_forms(params):
    """At four limbs the plain product, which reads both halves of the
    windows prepare_bk_ext writes (the -bk half too), equals a Toeplitz
    product that negates bk itself (poly.negacyclic_conv_toeplitz on the
    limbs of bk, sub-digit row dl shifted by dbits*dl); and the plain
    rotation equals the golden model's."""
    from cufhe_tpu_torch.ops.limbs import u32_to_signed_limbs
    from cufhe_tpu_torch.ops.poly import negacyclic_conv_toeplitz
    lp = params.lvl1
    nd, dbits = decomp_digit_limb_plan(lp.Bgbit)
    rng = np.random.default_rng(75)
    bk = rng.integers(0, 1 << 32, (2, (lp.k + 1) * lp.l, lp.k + 1, lp.n),
                      dtype=np.uint64).astype(np.uint32)
    ext = BR.prepare_bk_ext(from_u32(bk), params)
    half = 1 << (dbits - 1)
    dec = torch.from_numpy(rng.integers(
        -half, half, (3, (lp.k + 1) * lp.l * nd, lp.n)).astype(np.int8))
    for i in range(2):
        limbs = torch.from_numpy(np.ascontiguousarray(
            np.moveaxis(u32_to_signed_limbs(bk[i]), -1, 0)))
        want = sum(negacyclic_conv_toeplitz(dec[:, dl::nd], limbs, lp.k)
                   << (dbits * dl) for dl in range(nd))
        assert torch.equal(BR.ext_product_ref(dec, ext[i]), want)

    sk, ek = _keys(params, 76)
    cts = G.encrypt_bit_batch([0, 1, 1], sk, np.random.default_rng(77))
    n0, mu = params.n0, lp.mu
    got = to_u32(TB.blind_rotate(from_u32(cts[:, :n0]),
                                 from_u32(cts[:, n0]), mu,
                                 TK.prepare_keys(ek, "cpu"), params))
    assert np.array_equal(got, np.stack([G.blind_rotate(c, mu, ek)
                                         for c in cts]))


@pytest.mark.parametrize("gate", ["nand", "xor"])
def test_context_gates_equal_jax_pallas3(keyed, gate):
    """Context(ek, "pallas3", device="cpu") gates equal the JAX package's
    gate_lvl0(..., backend="pallas3") as uint32 and decrypt right."""
    sk, ek, ctx, jkeys = keyed
    rng = np.random.default_rng(80)
    a, b = (encrypt_bits(x, sk, rng, device="cpu") for x in (BITS0, BITS1))
    out = ctx.gate(gate, a, b)
    want = np.asarray(JB.gate_lvl0(
        G.GATE_CONSTANTS[gate], jnp.asarray(to_u32(a.data)),
        jnp.asarray(to_u32(b.data)), jkeys, sk.params, backend="pallas3"))
    assert np.array_equal(to_u32(out.data), want)
    assert decrypt_bits(out, sk).tolist() == \
        [G.PLAIN_GATES[gate](x, y) for x, y in zip(BITS0, BITS1)]


def test_context_mux_equals_jax_pallas3(keyed):
    sk, ek, ctx, jkeys = keyed
    rng = np.random.default_rng(81)
    c, a, b = (encrypt_bits(x, sk, rng, device="cpu")
               for x in (BITSC, BITS0, BITS1))
    out = ctx.mux(c, a, b)
    want = np.asarray(JB.mux_lvl0(
        *(jnp.asarray(to_u32(x.data)) for x in (c, a, b)), jkeys,
        sk.params, backend="pallas3"))
    assert np.array_equal(to_u32(out.data), want)
    assert decrypt_bits(out, sk).tolist() == \
        [y if s else z for s, y, z in zip(BITSC, BITS0, BITS1)]


def test_pallas3_warns_as_jax_does():
    """The JAX package's UserWarning, word for word, on every pallas3
    Context (and on compat.Initialize, which builds one)."""
    import cufhe_tpu_torch.compat as cf
    _, ek = _keys(P.PALLAS_TINY, 90)
    with pytest.warns(UserWarning) as mine:
        Context(ek, "pallas3", device="cpu")
    with pytest.warns(UserWarning) as jax_side:
        JA.Context(ek, backend="pallas3")
    assert [str(w.message) for w in mine] == \
        [str(w.message) for w in jax_side]
    assert "EXPERIMENTAL reduced-precision" in str(mine[0].message)
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        Context(ek, device="cpu")                  # the exact path: silent
    pub = cf.PubKey(P.PALLAS_TINY)
    pub.ek = ek
    saved = cf._ctx
    try:
        with pytest.warns(UserWarning, match="EXPERIMENTAL"):
            cf.Initialize(pub, backend="pallas3", device="cpu")
        assert cf._ctx.backend == "pallas3"
        assert cf._ctx.keys.bk_ext.shape[3] == 3
    finally:
        cf._ctx = saved


def test_pallas3_key_lifecycle():
    """release_keys(("pallas3",)) frees bk_ext and a gate then raises;
    prepare_backend(ek, "pallas3") restores it bit-exactly; switching to
    the exact path and back swaps the key's precision in place (one
    precision per context); reinitialize takes the name."""
    sk, ek = _keys(P.PALLAS_TINY, 100)
    rng = np.random.default_rng(101)
    a, b = (encrypt_bits(x, sk, rng, device="cpu") for x in (BITS0, BITS1))
    ctx = _quiet_context(ek)
    assert ctx.keys.bk_ext.shape[3] == 3 and ctx._path == "pallas3"
    before = ctx.nand(a, b)
    ctx.release_keys(("pallas3",))
    assert ctx.keys.bk_ext.numel() == 0 and ctx.keys.ksk_tiles.numel()
    with pytest.raises(ValueError, match="release_keys"):
        ctx.nand(a, b)
    with pytest.warns(UserWarning, match="EXPERIMENTAL"):
        ctx.prepare_backend(ek, "pallas3")
    assert torch.equal(ctx.nand(a, b).data, before.data)
    ctx.prepare_backend(ek)                        # the exact key instead
    assert ctx.keys.bk_ext.shape[3] == 4 and ctx.backend == "auto"
    exact = ctx.nand(a, b)
    assert torch.equal(exact.data, Context(ek, device="cpu").nand(a, b).data)
    assert not torch.equal(exact.data, before.data)
    with pytest.warns(UserWarning, match="EXPERIMENTAL"):
        ctx.prepare_backend(ek, "pallas3")
    assert torch.equal(ctx.nand(a, b).data, before.data)
    ctx.release_keys()
    sk2, ek2 = _keys(P.PALLAS_TINY_K2, 102)
    with pytest.warns(UserWarning, match="EXPERIMENTAL"):
        ctx.reinitialize(ek2, "pallas3")
    x, y = (encrypt_bits(v, sk2, rng, device="cpu") for v in (BITS0, BITS1))
    assert ctx.keys.bk_ext.shape[3] == 3
    assert decrypt_bits(ctx.nand(x, y), sk2).tolist() == [1, 1, 1, 0]
    with pytest.raises(ValueError, match="one pallas key precision"):
        TK.prepare_keys(ek, "cpu", ("pallas", "pallas3"))


def test_path_refuses_a_key_of_the_other_precision():
    """No path reads the other's key: the exact path on a three-limb key,
    and pallas3 on a four-limb one, raise ValueError."""
    sk, ek = _keys(P.PALLAS_TINY, 110)
    p = ek.params
    rng = np.random.default_rng(111)
    a, b = (from_u32(G.encrypt_bit_batch(x, sk, rng)) for x in (BITS0, BITS1))
    nand = G.GATE_CONSTANTS["nand"]
    keys3 = TK.prepare_keys(ek, "cpu", ("pallas3",))
    keys4 = TK.prepare_keys(ek, "cpu")
    with pytest.raises(ValueError, match="3-limb key"):
        TB.gate_lvl0(nand, a, b, keys4, p, "pallas3")
    with pytest.raises(ValueError, match="4-limb key"):
        TB.gate_lvl0(nand, a, b, keys3, p, "pallas")
    assert TB.resolve_backend("pallas3") == "pallas3"
    assert {TB.resolve_backend(n) for n in TB.EXACT_BACKENDS} == {"pallas"}


def test_pallas3_refused_below_n128(tiny_key):
    """The JAX package's pallas3 kernel needs N % 128 == 0; at TINY
    (N = 64) the port refuses the backend with ValueError saying why, at
    the Context and at the key."""
    _, ek = tiny_key
    with pytest.raises(ValueError, match="N >= 128"):
        _quiet_context(ek)
    with pytest.raises(ValueError, match="N = 64"):
        BR.prepare_bk_ext(from_u32(ek.bk), ek.params, 3)
    with pytest.raises(ValueError, match="4 limbs"):
        BR.prepare_bk_ext(from_u32(ek.bk), ek.params, 2)


@pytest.fixture(scope="module")
def tiny3():
    """PALLAS_TINY's pallas3 context, with a spy on the plain rotation
    that records the limbs of every key it is given."""
    sk, ek = _keys(P.PALLAS_TINY, 120)
    return sk, ek, _quiet_context(ek)


def _limbs_seen(monkeypatch):
    seen = []
    real = BR.blind_rotate_ref

    def spy(acc, abar, bk_ext, params):
        seen.append(bk_ext.shape[3])
        return real(acc, abar, bk_ext, params)
    monkeypatch.setattr(BR, "blind_rotate_ref", spy)
    return seen


def test_integers_follow_the_context(tiny3, monkeypatch):
    """IntContext on a pallas3 context rotates with the three-limb key
    only, and its sums decrypt right."""
    sk, ek, ctx = tiny3
    seen = _limbs_seen(monkeypatch)
    rng = np.random.default_rng(121)
    xs, ys = ([int(v) for v in rng.integers(0, 16, 4)] for _ in range(2))
    x, y = (encrypt_uint(v, 4, sk, rng=rng, device="cpu") for v in (xs, ys))
    s = IntContext(ctx).add(x, y)
    assert decrypt_uint(s, sk) == [(a + b) % 16 for a, b in zip(xs, ys)]
    assert seen and set(seen) == {3}


def test_executor_follows_the_context(tiny3, monkeypatch):
    """run_schedule on a pallas3 context: the three-limb key only, the
    outputs equal to the same gates called one by one."""
    sk, ek, ctx = tiny3
    seen = _limbs_seen(monkeypatch)
    s = build_ripple_adder(2)[0].compile()
    rng = np.random.default_rng(122)
    bits = [rng.integers(0, 2, 4) for _ in s.inputs]
    cts = [encrypt_bits(b, sk, rng, device="cpu") for b in bits]
    outs = run_schedule(ctx, s, cts)
    vals = dict(zip(s.inputs, cts))
    for groups in s.levels:
        for op, quads in groups:
            for q in quads:
                vals[q[0]] = ctx.gate(op, vals[q[1]], vals[q[2]])
    for w, o in zip(s.outputs, outs):
        assert torch.equal(o.data, vals[w].data)
    assert seen and set(seen) == {3}


def test_processor_follows_the_context(tiny3, monkeypatch):
    """One TOY8 cycle on two lanes of a pallas3 context: the three-limb
    key only, the state equal to the interpreter's."""
    sk, ek, ctx = tiny3
    seen = _limbs_seen(monkeypatch)
    progs = [[("ldi", 0x5A), ("add", 0x33)], [("ldi", 7), ("jz", 0)]]
    ins = TOY.encrypt_state(progs, sk, np.random.default_rng(123),
                            device="cpu")
    sched = TOY.build_cycle()[0].compile()
    acc, pc = TOY.decrypt_state(TOY.run_cycles(ctx, sched, ins, 1), sk)
    for lane, prog in enumerate(progs):
        assert (acc[lane], pc[lane]) == TOY.interpret(prog, 1)
    assert seen and set(seen) == {3}


def test_two_shard_mesh_equals_the_plain_context(tiny3):
    """A pallas3 context on a two-shard CPU mesh equals the plain pallas3
    context as uint32, with the three-limb key on each shard."""
    sk, ek, ctx = tiny3
    mctx = _quiet_context(ek, mesh=data_mesh(["cpu"] * 2))
    assert mctx.backend == "pallas3" and mctx.keys.bk_ext.shape[3] == 3
    rng = np.random.default_rng(124)
    a, b, c = (encrypt_bits(rng.integers(0, 2, 8), sk, rng, device="cpu")
               for _ in range(3))
    assert torch.equal(mctx.nand(a, b).data, ctx.nand(a, b).data)
    assert torch.equal(mctx.mux(c, a, b).data, ctx.mux(c, a, b).data)
    assert isinstance(mctx.nand(a, b), Ctxt)


def test_bench_reads_backend_and_params_from_the_environment(monkeypatch):
    """BENCH_BACKEND and BENCH_PARAMS reach the bench's Context, as the
    JAX bench reads them, and its record names both; unset, they are
    auto and tfhepp_128bit."""
    from cufhe_tpu_torch import bench
    for name in ("BENCH_BACKEND", "BENCH_PARAMS"):
        monkeypatch.delenv(name, raising=False)
    cfg = bench.settings()
    assert (cfg["backend"], cfg["params"].name) == ("auto", "tfhepp_128bit")
    for name, value in (("BENCH_BACKEND", "pallas3"),
                        ("BENCH_PARAMS", P.PALLAS_TINY.name),
                        ("BENCH_BATCH", "4"), ("BENCH_ITERS", "1"),
                        ("BENCH_REPS", "1")):
        monkeypatch.setenv(name, value)
    seen = []

    def spy(ek, backend="auto", mesh=None, *, device="cuda"):
        ctx = _quiet_context(ek, backend, mesh=mesh) if device == "cpu" \
            else None
        seen.append((ek.params.name, backend, ctx.keys.bk_ext.shape[3]))
        return ctx
    monkeypatch.setattr(bench, "Context", spy)
    rec = bench.run(**bench.settings(), device="cpu")
    assert seen == [(P.PALLAS_TINY.name, "pallas3", 3)]
    assert (rec["backend"], rec["params"]) == ("pallas3", P.PALLAS_TINY.name)
    assert rec["batch"] == 4 and rec["decrypt_errors"] == 0
    monkeypatch.setenv("BENCH_PARAMS", "no-such-preset")
    with pytest.raises(ValueError, match="BENCH_PARAMS"):
        bench.settings()


def test_phase_breakdown_takes_the_backend():
    """phase_breakdown's phases on a pallas3 key compose to the pallas3
    gate, and its timer runs them on the CPU."""
    from cufhe_tpu_torch.benchmarks import phase_breakdown as PB
    _, ek = _keys(P.PALLAS_TINY, 130)
    p = ek.params
    keys3 = TK.prepare_keys(ek, "cpu", ("pallas3",))
    a, b = PB.random_inputs(p, 4, "cpu")
    acc = PB.blind_rotate_only(a, b, keys3, p, "pallas3")
    assert torch.equal(PB.extract_ks_only(acc, keys3, p),
                       PB.full_nand(a, b, keys3, p, "pallas3"))
    with pytest.raises(ValueError, match="4-limb key"):
        PB.full_nand(a, b, keys3, p)
    rec = PB.breakdown(keys3, p, 4, device="cpu", backend="pallas3")
    assert all(v >= 0 for k, v in rec.items() if k.endswith("_ms"))
