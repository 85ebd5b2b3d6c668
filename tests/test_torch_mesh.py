"""Meshes of cufhe_tpu_torch (parallel/mesh.py and Context(mesh=...)) on
the CPU: the cases of tests/test_mesh.py, each on a port mesh of 2, 4 or 8
CPU shards, equal as uint32 to the port's unsharded context and to the JAX
package's Context(ek, mesh=data_mesh()) on the same numpy-seeded inputs
(the JAX side on the eight virtual CPU devices of conftest.py). Also: every
shard gets its share of the rows, the gate path calls nothing of
torch.distributed, and the refusals."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cufhe_tpu import golden as JG
from cufhe_tpu import params as JP
from cufhe_tpu.models import IntContext as JIntContext
from cufhe_tpu.models import api as JA
from cufhe_tpu.models import encrypt_uint as j_encrypt_uint
from cufhe_tpu.ops import bootstrap as JB
from cufhe_tpu.ops import keys as JK
from cufhe_tpu.parallel import mesh as JM
from cufhe_tpu.runtime import CircuitBuilder as JCircuitBuilder
from cufhe_tpu.runtime import build_ripple_adder as j_build_ripple_adder
from cufhe_tpu.runtime import run_schedule as j_run_schedule
from cufhe_tpu.runtime import run_schedule_loop as j_run_schedule_loop
from cufhe_tpu_torch import (Context, Ctxt, TrlweCtxt, decrypt_bits,
                             encrypt_bits)
from cufhe_tpu_torch.models import IntContext, decrypt_uint, encrypt_uint
from cufhe_tpu_torch.ops import bootstrap as TB
from cufhe_tpu_torch.parallel import mesh as M
from cufhe_tpu_torch.runtime import (CircuitBuilder, Stream,
                                     build_ripple_adder, run_schedule,
                                     run_schedule_loop)
from cufhe_tpu_torch.runtime import executor as EX
from cufhe_tpu_torch.torus import from_u32, to_u32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Intra-op threads off while this module runs: the suite runs several
    worker processes on the same cores, where torch's thread pool spends
    its time waiting for its own threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(n: int) -> M.DataMesh:
    return M.data_mesh(["cpu"] * n)


@pytest.fixture(scope="module")
def pallas_key():
    sk = JG.keygen(JP.PALLAS_TINY, seed=11)
    return sk, JG.make_eval_key(sk, seed=12)


@pytest.fixture(scope="module")
def pallas_ctxs(pallas_key):
    """(sk, ek, the port's unsharded context, the JAX mesh context)."""
    sk, ek = pallas_key
    return (sk, ek, Context(ek, device="cpu"),
            JA.Context(ek, mesh=JM.data_mesh()))


@pytest.fixture(scope="module")
def tiny_ctxs(tiny_key):
    sk, ek = tiny_key
    return sk, ek, Context(ek, device="cpu"), JA.Context(
        ek, mesh=JM.data_mesh())


def _pair(sk, seed, n=16):
    rng = np.random.default_rng(seed)
    bits = [rng.integers(0, 2, n) for _ in range(2)]
    return bits, [encrypt_bits(b, sk, rng, device="cpu") for b in bits]


def _j(ct: Ctxt) -> JA.Ctxt:
    return JA.Ctxt(jnp.asarray(to_u32(ct.data)), ct.level)


def _same(t: torch.Tensor, *others) -> bool:
    got = to_u32(t)
    return all(np.array_equal(got, o if isinstance(o, np.ndarray)
                              else to_u32(o)) for o in others)


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_pallas_gate_sharded_matches_unsharded(shards, pallas_ctxs):
    sk, ek, plain, jmesh = pallas_ctxs
    (bits0, bits1), (a, b) = _pair(sk, 30)
    ctx = Context(ek, mesh=cpu_mesh(shards))
    assert ctx.device == torch.device("cpu") and ctx.mesh.size == shards
    out = ctx.nand(a, b)
    want = np.asarray(jmesh.nand(_j(a), _j(b)).data)
    assert _same(out.data, plain.nand(a, b).data, want)
    assert decrypt_bits(out, sk).tolist() == (1 - (bits0 & bits1)).tolist()


def test_pallas_k2_sharded_matches_unsharded(tiny_k2_key):
    sk, ek = tiny_k2_key
    bits0, bits1 = [1, 0, 1, 1, 0, 0, 1, 0], [1, 1, 0, 1, 0, 1, 0, 0]
    rng = np.random.default_rng(31)
    a, b = (encrypt_bits(x, sk, rng, device="cpu") for x in (bits0, bits1))
    out = Context(ek, mesh=cpu_mesh(8)).xor(a, b)
    jout = JA.Context(ek, mesh=JM.data_mesh()).xor(_j(a), _j(b))
    assert _same(out.data, Context(ek, device="cpu").xor(a, b).data,
                 np.asarray(jout.data))
    assert decrypt_bits(out, sk).tolist() == \
        [x ^ y for x, y in zip(bits0, bits1)]


def test_every_shard_gets_its_rows(tiny_ctxs, monkeypatch):
    """The counterpart of len(sharding.device_set) == 8: each of the mesh's
    gate calls sees B / size rows."""
    sk, ek, plain, _ = tiny_ctxs
    _, (a, b) = _pair(sk, 32)
    seen = []
    real = TB.gate_lvl0

    def spy(c, x, y, *rest):
        seen.append(x.shape[0])
        return real(c, x, y, *rest)
    monkeypatch.setattr(TB, "gate_lvl0", spy)
    ctx = Context(ek, mesh=cpu_mesh(4))
    ctx.nand(a, b)
    assert seen == [4, 4, 4, 4]


def test_gate_sharded_no_collectives(tiny_ctxs):
    """A mesh gate calls no torch.distributed function: with every public
    one patched to raise, it still runs and equals the unsharded gate."""
    from cufhe_tpu_torch.benchmarks.scaling import _no_collectives
    sk, ek, plain, _ = tiny_ctxs
    _, (a, b) = _pair(sk, 33)
    ctx = Context(ek, mesh=cpu_mesh(8))
    with _no_collectives():
        with pytest.raises(AssertionError, match="all_reduce"):
            torch.distributed.all_reduce(torch.zeros(1))
        out = ctx.nand(a, b)
    assert torch.equal(out.data, plain.nand(a, b).data)


def test_gate_rows_per_row_constants_shard_with_the_batch(tiny_ctxs):
    """[G, 3] constants are tiled gate-major before the cut, so every shard
    gets its rows' constants (JAX api.py:300-304)."""
    sk, ek, plain, jmesh = tiny_ctxs
    (bits0, bits1), (a, b) = _pair(sk, 34)
    names = ["xor", "andyn", "nand", "orny"]
    c3 = TB.encode_gate_consts_rows(names, sk.params.lvl0.mu)
    out = Context(ek, mesh=cpu_mesh(8)).gate_rows(c3, a, b)
    want = np.asarray(jmesh.gate_rows(JB.encode_gate_consts_rows(
        names, sk.params.lvl0.mu), _j(a), _j(b)).data)
    assert _same(out.data, plain.gate_rows(c3, a, b).data, want)
    per_row = [names[r // 4] for r in range(16)]
    assert decrypt_bits(out, sk).tolist() == [
        JG.PLAIN_GATES[nm](x, y) for nm, x, y in zip(per_row, bits0, bits1)]


def test_pbs_per_batch_tv_sharded_matches_unsharded(tiny_ctxs):
    sk, ek, plain, jmesh = tiny_ctxs
    rng = np.random.default_rng(35)
    cts = encrypt_bits(rng.integers(0, 2, 16), sk, rng, device="cpu")
    tvs = rng.integers(0, 1 << 32, (16, sk.params.lvl1.n),
                       dtype=np.uint64).astype(np.uint32)
    out = Context(ek, mesh=cpu_mesh(4)).pbs_tlwe2trlwe(cts, tvs)
    want = np.asarray(jmesh.pbs_tlwe2trlwe(_j(cts), tvs).data)
    assert _same(out.data, plain.pbs_tlwe2trlwe(cts, tvs).data, want)
    one = tvs[0]                         # an [N] test vector: read whole
    assert torch.equal(
        Context(ek, mesh=cpu_mesh(4)).programmable_bootstrap(cts, one).data,
        plain.programmable_bootstrap(cts, one).data)


def test_gate_chain_sharded_matches_unsharded(tiny_ctxs):
    sk, ek, plain, jmesh = tiny_ctxs
    _, (a, b) = _pair(sk, 36)
    names = ["nand", "xor", "or", "and"]
    out = Context(ek, mesh=cpu_mesh(8)).gate_chain(names, a, b)
    want = np.asarray(jmesh.gate_chain(names, _j(a), _j(b)).data)
    assert _same(out.data, plain.gate_chain(names, a, b).data, want)


def test_cmux_sharded_matches_unsharded(tiny_ctxs):
    """cmux cuts both TRLWE batches across the mesh and copies the TRGSW
    to every shard; it reads no evaluation key, so it runs on a context
    whose keys were released."""
    sk, ek, plain, jmesh = tiny_ctxs
    lp = sk.params.lvl1
    rng = np.random.default_rng(43)
    tg = JG.trgsw_encrypt(1, lp, sk.lvl1, rng)
    c1, c0 = (np.stack([JG.trlwe_encrypt_zero(lp, sk.lvl1, rng)
                        for _ in range(8)]) for _ in range(2))
    ctx = Context(ek, mesh=cpu_mesh(4))
    ctx.release_keys()
    out = ctx.cmux(ctx.prepare_trgsw(tg), TrlweCtxt(from_u32(c1)),
                   TrlweCtxt(from_u32(c0)))
    want = np.asarray(jmesh.cmux(JK.prepare_trgsw(tg, sk.params),
                                 JA.TrlweCtxt(jnp.asarray(c1)),
                                 JA.TrlweCtxt(jnp.asarray(c0))).data)
    assert _same(out.data, plain.cmux(plain.prepare_trgsw(tg),
                                      TrlweCtxt(from_u32(c1)),
                                      TrlweCtxt(from_u32(c0))).data, want)


def test_integer_add_sharded_matches_unsharded(pallas_ctxs):
    sk, ek, plain, jmesh = pallas_ctxs
    rng = np.random.default_rng(37)
    xs = [int(v) for v in rng.integers(0, 16, 16)]
    ys = [int(v) for v in rng.integers(0, 16, 16)]
    x = encrypt_uint(xs, 4, sk, rng=np.random.default_rng(38), device="cpu")
    y = encrypt_uint(ys, 4, sk, rng=np.random.default_rng(39), device="cpu")
    out = IntContext(Context(ek, mesh=cpu_mesh(8))).add(x, y)
    want = JIntContext(jmesh).add(
        j_encrypt_uint(xs, 4, sk, rng=np.random.default_rng(38)),
        j_encrypt_uint(ys, 4, sk, rng=np.random.default_rng(39)))
    assert _same(out.digits, IntContext(plain).add(x, y).digits,
                 np.asarray(want.digits))
    assert decrypt_uint(out, sk) == [(u + v) % 16 for u, v in zip(xs, ys)]


def test_run_schedule_sharded_matches_unsharded(tiny_ctxs):
    sk, ek, plain, jmesh = tiny_ctxs
    sched = build_ripple_adder(3)[0].compile()
    jsched = j_build_ripple_adder(3)[0].compile()
    rng = np.random.default_rng(40)
    cts = [encrypt_bits(rng.integers(0, 2, 8), sk, rng, device="cpu")
           for _ in sched.inputs]
    mesh_ctx = Context(ek, mesh=cpu_mesh(2))
    assert EX.precompile_schedule(mesh_ctx, sched, 8) == 0
    got = run_schedule(mesh_ctx, sched, cts)
    want = j_run_schedule(jmesh, jsched, [_j(c) for c in cts])
    for g, p, w in zip(got, run_schedule(plain, sched, cts), want):
        assert _same(g.data, p.data, np.asarray(w.data))


def _feedback_circuit(builder):
    cb = builder()
    sel, x = cb.input(), cb.input()
    one = cb.const(1)
    y = cb.gate("nand", x, one)
    cb.output(cb.gate("mux", sel, y, one))
    return cb.compile()


@pytest.mark.parametrize("shards", [2, 8])
def test_run_schedule_loop_sharded_matches_unsharded(shards, tiny_ctxs):
    sk, ek, plain, jmesh = tiny_ctxs
    s = _feedback_circuit(CircuitBuilder)
    B_ = 16
    sel_bits = np.array([i & 1 for i in range(B_)])
    x_bits = np.array([(i >> 1) & 1 for i in range(B_)])
    ins = [encrypt_bits(sel_bits, sk, np.random.default_rng(33),
                        device="cpu"),
           encrypt_bits(x_bits, sk, np.random.default_rng(34), device="cpu")]
    got = run_schedule_loop(Context(ek, mesh=cpu_mesh(shards)), s, ins,
                            cycles=3, feedback=[(0, 1)])
    want = j_run_schedule_loop(jmesh, _feedback_circuit(JCircuitBuilder),
                               [_j(c) for c in ins], cycles=3,
                               feedback=[(0, 1)])
    assert _same(got[0].data, run_schedule_loop(
        plain, s, ins, cycles=3, feedback=[(0, 1)])[0].data,
        np.asarray(want[0].data))
    want_bits = x_bits.copy()
    for _ in range(3):
        want_bits = np.where(sel_bits == 1, 1 - (want_bits & 1), 1)
    assert np.array_equal(decrypt_bits(got[0], sk), want_bits)


def test_run_schedule_loop_mesh_batch_divisibility(tiny_key):
    sk, ek = tiny_key
    ctx = Context(ek, mesh=cpu_mesh(4))
    cb = CircuitBuilder()
    a, b = cb.input(), cb.input()
    cb.output(cb.gate("nand", a, b))
    s = cb.compile()
    rng = np.random.default_rng(41)
    ins = [encrypt_bits([1] * 6, sk, rng, device="cpu"),
           encrypt_bits([0] * 6, sk, rng, device="cpu")]
    with pytest.raises(ValueError, match="divisible"):
        run_schedule_loop(ctx, s, ins, cycles=2, feedback=[(0, 0)])
    with pytest.raises(ValueError, match="divisible"):
        run_schedule(ctx, s, ins)
    with pytest.raises(ValueError, match="divisible"):
        ctx.nand(*ins)


def test_mesh_context_refusals_and_keys(tiny_key, monkeypatch):
    """stream= and a mesh exclude each other; data_mesh() without CUDA
    raises (no CPU fallback); a mesh of one device holds one key set; a
    released key raises on every shard and prepare_backend restores it."""
    sk, ek = tiny_key
    ctx = Context(ek, mesh=cpu_mesh(4))
    rng = np.random.default_rng(42)
    a, b = (encrypt_bits(x, sk, rng, device="cpu")
            for x in ([1, 0, 1, 0], [1, 1, 0, 0]))
    with pytest.raises(ValueError, match="mutually exclusive"):
        ctx.nand(a, b, stream=Stream(device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        M.data_mesh()
    monkeypatch.undo()
    assert ctx._dev_keys == {}                 # the one device is its own
    reps = M.replicate(ctx.keys, ctx.mesh)
    assert list(reps) == [torch.device("cpu")] and reps[ctx.device] is ctx.keys
    before = ctx.nand(a, b)
    ctx.release_keys()
    with pytest.raises(ValueError, match="release_keys"):
        ctx.nand(a, b)
    ctx.prepare_backend(ek)
    assert torch.equal(ctx.nand(a, b).data, before.data)
    ntt = Context(ek, "ntt", mesh=cpu_mesh(2))
    assert torch.equal(ntt.nand(a, b).data,
                       Context(ek, "ntt", device="cpu").nand(a, b).data)


def test_shard_helpers():
    mesh = M.data_mesh(["cpu", "cpu", "cpu"], n_devices=2)
    assert mesh.size == 2 and mesh.device == torch.device("cpu")
    x = torch.arange(12).reshape(6, 2)
    blocks = M.shard_batch(x, mesh)
    assert [tuple(b.shape) for b in blocks] == [(3, 2), (3, 2)]
    assert torch.equal(torch.cat(blocks), x)
    double = M.data_parallel(lambda k, v, s: v * k + s, mesh, (1,))
    assert torch.equal(double(2, x, torch.tensor(1)), x * 2 + 1)
    assert torch.equal(M.local_rows(x, rank=1, world_size=3), x[2:4])
    with pytest.raises(ValueError, match="divisible"):
        M.local_rows(x, rank=0, world_size=4)
    with pytest.raises(ValueError, match="at least one"):
        M.data_mesh([])


def test_scaling_bench_cpu_sweep():
    """Part 1 of benchmarks.scaling: sharded == unsharded at 1, 2, 4 and 8
    CPU shards, with torch.distributed refused while the gates run."""
    from cufhe_tpu_torch.benchmarks import scaling
    rec = scaling.cpu_mesh_sweep()
    assert rec["pass"] and [r["shards"] for r in rec["rows"]] == [1, 2, 4, 8]
