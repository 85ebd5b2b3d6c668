"""cufhe_tpu_torch.runtime on the CPU against cufhe_tpu.runtime (JAX): the
scheduler (native and force_python), the Bristol importer, the AES-128 and
SHA-256 netlist generators, slot allocation, the executor (run_schedule,
chunked steps, run_schedule_loop) and streams on the CPU lane, at TINY.
Ciphertexts are compared as uint32."""
import itertools

import numpy as np
import pytest
import torch

from cufhe_tpu.models import api as JA
from cufhe_tpu.runtime import bristol as JBR
from cufhe_tpu.runtime import executor as JEX
from cufhe_tpu.runtime import graph as JGR
from cufhe_tpu.runtime import netlists as JNL
from cufhe_tpu_torch import Context, Ctxt, decrypt_bits, encrypt_bits
from cufhe_tpu_torch import _build
from cufhe_tpu_torch.ops import blind_rotate as BR
from cufhe_tpu_torch.runtime import bristol as BRI
from cufhe_tpu_torch.runtime import executor as EX
from cufhe_tpu_torch.runtime import graph as GR
from cufhe_tpu_torch.runtime import netlists as NL
from cufhe_tpu_torch.runtime import (Stream, run_schedule, run_schedule_loop,
                                     stream_query, synchronize)
from cufhe_tpu_torch.torus import to_u32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Intra-op threads off while this module runs: the suite runs several
    worker processes on the same cores, where torch's thread pool spends
    its time waiting for its own threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REF_ROTATE = BR.blind_rotate_ref

# a 2-bit adder and a const/INV/MUX circuit in Bristol Fashion (the JAX
# package's tests/test_runtime.py texts)
ADDER2 = """\
9 16
2 2 2
1 3
2 1 0 2 13 XOR
2 1 0 2 5 AND
2 1 1 3 6 XOR
2 1 1 3 7 AND
2 1 6 5 14 XOR
2 1 6 5 9 AND
2 1 9 7 10 OR
1 1 10 11 EQW
1 1 11 15 EQW
"""
CONST_INV_MUX = """\
3 5
2 1 1
1 1
1 1 1 2 EQ
1 1 1 3 INV
3 1 0 2 3 4 MUX
"""


def _same_schedule(s, j):
    """A port Schedule equal to a JAX one, field by field."""
    assert s.num_wires == j.num_wires
    assert s.inputs == j.inputs and s.outputs == j.outputs
    assert s.consts == j.consts
    assert s.num_levels == j.num_levels and s.num_gates == j.num_gates
    assert s.levels == [[(op, [tuple(q) for q in qs]) for op, qs in lvl]
                        for lvl in j.levels]


def _jax(cts):
    return [JA.Ctxt(to_u32(c.data), c.level) for c in cts]


@pytest.fixture(scope="module")
def setup(tiny_key):
    sk, ek = tiny_key
    return sk, ek, Context(ek, device="cpu"), JA.Context(ek)


def _enc(bits_list, sk, seed):
    rng = np.random.default_rng(seed)
    return [encrypt_bits(b, sk, rng, device="cpu") for b in bits_list]


# -- scheduler ------------------------------------------------------------

def test_native_scheduler_builds_into_the_build_dir():
    assert GR.native_available()
    lib = _build.build_host()
    assert lib.parent == _build.host_build_dir()
    assert lib.parent.parent == _build.BUILD_DIR
    assert not (_build.HOST_SRC.parent / "libcufhe_circuit.so").exists()


def test_failed_native_build_raises(monkeypatch, tmp_path):
    """No silent fallback: a scheduler that cannot be built raises from
    CircuitBuilder(); force_python stays the explicit pure-Python path."""
    monkeypatch.setattr(GR, "_LIB", None)
    monkeypatch.setattr(_build, "_host_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "no-such-compiler-here")
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        GR.CircuitBuilder()
    assert not GR.native_available()
    cb = GR.CircuitBuilder(force_python=True)
    cb.output(cb.gate("nand", cb.input(), cb.input()))
    assert cb.compile().num_gates == 1


def test_opcode_tables_equal_original():
    assert GR.OPCODES == JGR.OPCODES
    assert GR.OPNAMES == JGR.OPNAMES
    assert GR.NEG_VARIANT == JGR.NEG_VARIANT
    assert GR.OPS_2IN + GR.OPS_3IN + GR.OPS_1IN == \
        JGR.OPS_2IN + JGR.OPS_3IN + JGR.OPS_1IN


@pytest.mark.parametrize("force_python", [False, True])
def test_schedule_levels_and_dce(force_python):
    cb = GR.CircuitBuilder(force_python=force_python)
    a, b, c = cb.input(), cb.input(), cb.input()
    x = cb.gate("and", a, b)
    y = cb.gate("xor", x, c)
    cb.gate("or", a, b)               # dead
    z = cb.gate("nand", x, y)
    cb.output(z)
    s = cb.compile()
    assert s.num_gates == 3
    assert [[op for op, _ in lvl] for lvl in s.levels] == \
        [["and"], ["xor"], ["nand"]]
    assert s.outputs == [z] and s.inputs == [a, b, c]
    with pytest.raises(ValueError, match="invalid wire"):
        cb.gate("and", a, 99)
    with pytest.raises(ValueError, match="takes 2 args"):
        cb.gate("and", a)


def _random_circuit(cb, ops, seed):
    rng = np.random.default_rng(seed)
    wires = [cb.input() for _ in range(6)] + [cb.const(1)]
    for _ in range(80):
        k = rng.integers(0, 5)
        pick = lambda: int(rng.choice(wires))     # noqa: E731
        if k == 0:
            wires.append(cb.gate("not", pick()))
        elif k == 1:
            wires.append(cb.gate("copy", pick()))
        elif k == 2:
            wires.append(cb.gate("mux", pick(), pick(), pick()))
        else:
            wires.append(cb.gate(ops[int(rng.integers(0, len(ops)))],
                                 pick(), pick()))
    for w in wires[-5:]:
        cb.output(w)
    return cb


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("force_python", [False, True])
def test_random_circuit_schedule_equals_original(force_python, optimize):
    """NOT/COPY absorption, DCE, levels and grouping on a random circuit
    with mux and constants: equal to the JAX package's native schedule."""
    s = _random_circuit(GR.CircuitBuilder(force_python=force_python),
                        GR.OPS_2IN, 3).compile(optimize=optimize)
    j = _random_circuit(JGR.CircuitBuilder(), JGR.OPS_2IN,
                        3).compile(optimize=optimize)
    _same_schedule(s, j)


@pytest.fixture(scope="module")
def netlists():
    """(port text, JAX text) of the three generated netlists."""
    return {name: (getattr(NL, name)(), getattr(JNL, name)())
            for name in ("aes128_bristol", "sha256_block_bristol",
                         "sha256_compress_bristol")}


def test_netlist_generators_equal_original(netlists):
    for name, (mine, ref) in netlists.items():
        assert mine == ref, name
    rng = np.random.default_rng(4)
    for _ in range(3):
        pt, key = (bytes(rng.integers(0, 256, 16, dtype=np.uint8))
                   for _ in range(2))
        assert NL.aes128_encrypt_block(pt, key) == \
            JNL.aes128_encrypt_block(pt, key)
        assert NL.bits_of(pt) == JNL.bits_of(pt)
        assert NL.bytes_of(NL.bits_of(pt)) == pt
    for n in (0, 3, 55, 56, 200):
        msg = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        assert NL.sha256_pad_blocks(msg) == JNL.sha256_pad_blocks(msg)
        assert NL.sha256_pad(msg[:55]) == JNL.sha256_pad(msg[:55])
    assert NL.sha256_iv_bits() == JNL.sha256_iv_bits()
    assert NL.aes_sbox_table() == JNL.aes_sbox_table()


def _python_builder(monkeypatch, force_python):
    """Make the Bristol importer build through the pure-Python scheduler
    when force_python is set."""
    if force_python:
        monkeypatch.setattr(BRI, "CircuitBuilder",
                            lambda: GR.CircuitBuilder(force_python=True))


@pytest.mark.parametrize("force_python", [False, True])
@pytest.mark.parametrize("name", ["ripple8", "aes128_bristol",
                                  "sha256_block_bristol"])
def test_schedules_equal_original(name, force_python, netlists,
                                  monkeypatch):
    """The ripple adder and the AES and SHA netlists through the port's
    importer and scheduler (native, then pure Python) against the JAX
    package's native scheduler; slots as allocate_slots assigns them."""
    _python_builder(monkeypatch, force_python)
    if name == "ripple8":
        s = GR.build_ripple_adder(8, force_python=force_python)[0].compile()
        j = JGR.build_ripple_adder(8)[0].compile()
    else:
        mine, ref = netlists[name]
        s, meta = BRI.compile_bristol(mine)
        j, jmeta = JBR.compile_bristol(ref)
        assert meta == jmeta
    _same_schedule(s, j)
    assert EX.allocate_slots(s) == JEX.allocate_slots(j)


@pytest.mark.parametrize("force_python", [False, True])
@pytest.mark.parametrize("text", [ADDER2, CONST_INV_MUX],
                         ids=["adder2", "const_inv_mux"])
def test_bristol_parse_equals_original(text, force_python, monkeypatch):
    _python_builder(monkeypatch, force_python)
    s, meta = BRI.compile_bristol(text)
    j, jmeta = JBR.compile_bristol(text)
    assert meta == jmeta
    _same_schedule(s, j)
    with pytest.raises(ValueError, match="topologically"):
        BRI.compile_bristol("2 4\n1 2\n1 1\n2 1 0 3 2 XOR\n2 1 0 2 3 XOR\n")


def test_simulate_schedule_equals_original(netlists):
    """The plaintext oracle on AES (three blocks) and its result."""
    s, _ = BRI.compile_bristol(netlists["aes128_bristol"][0])
    j, _ = JBR.compile_bristol(netlists["aes128_bristol"][1])
    rng = np.random.default_rng(5)
    pts = [bytes(rng.integers(0, 256, 16, dtype=np.uint8)) for _ in range(3)]
    keys = [bytes(rng.integers(0, 256, 16, dtype=np.uint8)) for _ in range(3)]
    bits = np.array([NL.bits_of(p) + NL.bits_of(k)
                     for p, k in zip(pts, keys)]).T
    out = np.stack(EX.simulate_schedule(s, list(bits)))
    assert np.array_equal(out, np.stack(JEX.simulate_schedule(j,
                                                              list(bits))))
    for i, (p, k) in enumerate(zip(pts, keys)):
        assert NL.bytes_of(out[:, i]) == NL.aes128_encrypt_block(p, k)


# -- executor ---------------------------------------------------------------

def test_trivial_ciphertext_equals_original(tiny_key):
    p = tiny_key[1].params
    for v in (0, 1):
        got = EX.trivial_ciphertext(v, p.lvl0.dim, p.lvl0.mu, 3,
                                    device="cpu")
        assert got.dtype == torch.int32 and got.device.type == "cpu"
        assert np.array_equal(to_u32(got), np.asarray(
            JEX.trivial_ciphertext(v, p.lvl0.dim, p.lvl0.mu, 3)))


def test_exec_chunk_equals_original(monkeypatch):
    """Gates per step: the same rule as the JAX executor's, and the same
    CUFHE_EXEC_CHUNK override."""
    for env in ("", "3"):
        monkeypatch.setenv("CUFHE_EXEC_CHUNK", env)
        for batch in (1, 8, 64, 256, 4096):
            assert EX._exec_chunk(batch) == JEX._exec_chunk(batch)


def _adder_inputs(sk, nbits, B, seed):
    rng = np.random.default_rng(seed)
    a, b = rng.integers(0, 1 << nbits, B), rng.integers(0, 1 << nbits, B)
    bits = ([(a >> i) & 1 for i in range(nbits)]
            + [(b >> i) & 1 for i in range(nbits)] + [rng.integers(0, 2, B)])
    return bits, _enc(bits, sk, seed + 1)


@pytest.mark.parametrize("chunk", ["", "2"], ids=["one-step", "chunked"])
def test_run_schedule_equals_original(setup, monkeypatch, chunk):
    """The 4-bit ripple adder: every output equal as uint32 to the JAX
    executor's, whose plaintext oracle the decryptions match; chunk=2
    splits each level into several steps."""
    sk, ek, ctx, jctx = setup
    monkeypatch.setenv("CUFHE_EXEC_CHUNK", chunk)
    s = GR.build_ripple_adder(4)[0].compile()
    bits, enc = _adder_inputs(sk, 4, 3, 40)
    steps = EX.schedule_steps(ctx, s, 3)
    if chunk:
        assert max(len(p) for p in steps) > 1
    calls = []
    monkeypatch.setattr(BR, "blind_rotate_ref",
                        lambda *a: calls.append(1) or REF_ROTATE(*a))
    outs = run_schedule(ctx, s, enc)
    assert len(calls) == EX.plan_rotations(steps)
    want = JEX.run_schedule(jctx, JGR.build_ripple_adder(4)[0].compile(),
                            _jax(enc))
    for o, w in zip(outs, want):
        assert o.data.device.type == "cpu" and o.level == 0
        assert np.array_equal(to_u32(o.data), np.asarray(w.data))
    for o, b in zip(outs, EX.simulate_schedule(s, bits)):
        assert np.array_equal(decrypt_bits(o, sk), b)



def test_bristol_mux_const_inv_equals_original(setup):
    sk, ek, ctx, jctx = setup
    s, _ = BRI.compile_bristol(CONST_INV_MUX)
    j, _ = JBR.compile_bristol(CONST_INV_MUX)
    bits = [np.array([0, 1, 0, 1]), np.array([0, 0, 1, 1])]
    enc = _enc(bits, sk, 41)
    got = run_schedule(ctx, s, enc)[0]
    want = JEX.run_schedule(jctx, j, _jax(enc))[0]
    assert np.array_equal(to_u32(got.data), np.asarray(want.data))
    assert np.array_equal(decrypt_bits(got, sk),
                          EX.simulate_schedule(s, bits)[0])
    assert np.array_equal(decrypt_bits(got, sk),
                          np.where(bits[0] == 1, 1 - bits[1], 1))


def _loop_circuit(builder):
    cb = builder()
    sel, x = cb.input(), cb.input()
    one = cb.const(1)
    y = cb.gate("nand", x, one)      # x' = sel ? (x nand 1) : 1
    cb.output(cb.gate("mux", sel, y, one))
    cb.output(cb.gate("xor", x, sel))
    return cb.compile()


@pytest.mark.parametrize("segment", [0, 2])
def test_run_schedule_loop_equals_original(setup, segment):
    """Feedback and constants over three cycles: equal to the JAX scanned
    loop and to run_schedule called cycle by cycle; segment= changes
    nothing."""
    sk, ek, ctx, jctx = setup
    s = _loop_circuit(GR.CircuitBuilder)
    bits = [np.array([0, 1, 0, 1]), np.array([0, 0, 1, 1])]
    enc = _enc(bits, sk, 42)
    got = run_schedule_loop(ctx, s, enc, cycles=3, feedback=[(0, 1)],
                            segment=segment)
    want = JEX.run_schedule_loop(jctx, _loop_circuit(JGR.CircuitBuilder),
                                 _jax(enc), cycles=3, feedback=[(0, 1)])
    for o, w in zip(got, want):
        assert np.array_equal(to_u32(o.data), np.asarray(w.data))
    state = enc
    for _ in range(3):
        outs = run_schedule(ctx, s, state)
        state = [state[0], outs[0]]
    assert np.array_equal(to_u32(got[0].data), to_u32(outs[0].data))
    x = bits[1]
    for _ in range(3):
        x_prev, x = x, np.where(bits[0] == 1, 1 - x, 1)
    assert np.array_equal(decrypt_bits(got[0], sk), x)
    assert np.array_equal(decrypt_bits(got[1], sk), x_prev ^ bits[0])


def test_executor_rejects_bad_inputs(setup):
    sk, ek, ctx, _ = setup
    s = GR.build_ripple_adder(2)[0].compile()
    enc = _enc([np.array([0, 1])] * 5, sk, 43)
    with pytest.raises(ValueError, match="inputs"):
        run_schedule(ctx, s, enc[:4])
    with pytest.raises(ValueError, match="share shape and level"):
        run_schedule(ctx, s, enc[:4] + [Ctxt(enc[4].data[:1], 0)])
    with pytest.raises(ValueError, match="out of range"):
        run_schedule_loop(ctx, s, enc, 2, feedback=[(9, 0)])
    with pytest.raises(ValueError, match="cycles"):
        run_schedule_loop(ctx, s, enc, 0, feedback=[])


def test_empty_circuit_returns_nothing(setup):
    """A circuit with neither inputs nor constants runs nothing and returns
    [], as the JAX package's run_schedule does; constants without inputs
    have no batch shape and are refused by both."""
    sk, ek, ctx, jctx = setup
    empty = GR.CircuitBuilder().compile()
    jempty = JGR.CircuitBuilder().compile()
    assert empty.inputs == empty.outputs == [] and not empty.consts
    assert run_schedule(ctx, empty, []) == JEX.run_schedule(jctx, jempty,
                                                            []) == []
    cb, jcb = GR.CircuitBuilder(), JGR.CircuitBuilder()
    for b in (cb, jcb):
        b.output(b.const(1))
    for runner, c, s in ((run_schedule, ctx, cb.compile()),
                         (JEX.run_schedule, jctx, jcb.compile())):
        with pytest.raises(ValueError, match="batch shape"):
            runner(c, s, [])
    with pytest.raises(ValueError, match="inputs"):
        run_schedule(ctx, empty, _enc([np.array([0, 1])], sk, 44))


def test_precompile_counts_step_shapes(setup, monkeypatch):
    sk, ek, ctx, _ = setup
    s = GR.build_ripple_adder(4)[0].compile()
    steps = EX.schedule_steps(ctx, s, 3)
    shapes = {(st[0], st[1].shape[0]) for p in steps for st in p}
    assert EX.precompile_schedule(ctx, s, 3) == len(shapes)
    monkeypatch.setenv("CUFHE_EXEC_CHUNK", "1")
    assert EX.precompile_schedule(ctx, s, 3) == 1


# -- streams on the CPU lane ------------------------------------------------

def test_cpu_stream_lane(setup):
    """Stream(device="cpu"): the completion-polling chain of the
    reference's test_intensive on the synchronous lane, equal to the
    same gates without a stream."""
    sk, ek, ctx, _ = setup
    rng = np.random.default_rng(44)
    bits = rng.integers(0, 2, (3, 4))
    cts = [encrypt_bits(b, sk, rng, device="cpu") for b in bits]
    plain = list(cts)
    streams = [Stream(device="cpu") for _ in cts]
    assert all(st.device == torch.device("cpu") for st in streams)
    for _, (i, st) in itertools.product(range(2), enumerate(streams)):
        assert stream_query(st)
        cts[i] = ctx.nand(cts[i], cts[(i + 1) % 3], stream=st)
        plain[i] = ctx.nand(plain[i], plain[(i + 1) % 3])
        st.record(cts[i])
    synchronize(*streams)
    synchronize()
    for c, p in zip(cts, plain):
        assert torch.equal(c.data, p.data) and c.ready is None
    for st in streams:
        assert st.query()
    out = ctx.mux(cts[0], cts[1], cts[2], stream=streams[0])
    assert torch.equal(out.data, ctx.mux(plain[0], plain[1], plain[2]).data)
    assert torch.equal(ctx.not_(cts[0], stream=streams[1]).data,
                       -cts[0].data)
    assert ctx.copy(cts[0], stream=streams[2]).data is cts[0].data
    chained = ctx.gate_chain(["xor", "nand"], cts[0], cts[1],
                             stream=streams[0])
    assert torch.equal(chained.data, ctx.nand(ctx.xor(cts[0], cts[1]),
                                              cts[1]).data)


def test_stream_needs_a_device():
    if torch.cuda.is_available():
        assert Stream().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            Stream()
    with pytest.raises(ValueError, match="no streams"):
        Stream(device="meta")
