"""cufhe_tpu_torch.models.processor (TOY8) on the CPU against
cufhe_tpu.models.processor (JAX): the assembler and ISA interpreter, the
cycle circuit's schedule (native and force_python), and an encrypted run
at TINY equal as uint32 to the JAX run and to the interpreter, in both
the loop and the scan mode."""
import numpy as np
import pytest
import torch

from cufhe_tpu.models import api as JA
from cufhe_tpu.models import processor as JTOY
from cufhe_tpu_torch import Context, Ctxt
from cufhe_tpu_torch.models import processor as TOY
from cufhe_tpu_torch.ops import blind_rotate as BR
from cufhe_tpu_torch.runtime import executor as EX
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


# the four programs of tests/test_processor.py
PROGRAMS = {
    "alu": [("ldi", 0x5A), ("add", 0x33), ("xor", 0xFF), ("and", 0x7E),
            ("or", 0x81)],
    "loop": [("ldi", 0), ("add", 1), ("jmp", 1)],
    "countdown": [("ldi", 3), ("add", 0xFF), ("jz", 5), ("jmp", 1),
                  ("nop", 0), ("ldi", 0x99)],
    "jz_untaken": [("ldi", 7), ("jz", 0), ("add", 1)],
}


def _random_programs(n, seed):
    rng = np.random.default_rng(seed)
    ops = list(TOY.OPCODES)
    return [[(ops[rng.integers(len(ops))], int(rng.integers(256)))
             for _ in range(int(rng.integers(1, 17)))] for _ in range(n)]


def test_isa_tables_equal_original():
    assert TOY.OPCODES == JTOY.OPCODES
    assert (TOY.PROG_SLOTS, TOY.INSTR_BITS, TOY.ACC_BITS, TOY.PC_BITS) == \
        (JTOY.PROG_SLOTS, JTOY.INSTR_BITS, JTOY.ACC_BITS, JTOY.PC_BITS)


@pytest.mark.parametrize("prog", list(PROGRAMS.values())
                         + _random_programs(4, 42),
                         ids=list(PROGRAMS) + [f"random{i}" for i in range(4)])
def test_assemble_and_interpret_equal_original(prog):
    assert np.array_equal(TOY.assemble(prog), JTOY.assemble(prog))
    for cycles in (1, 4, 9):
        assert TOY.interpret(prog, cycles) == JTOY.interpret(prog, cycles)


@pytest.mark.parametrize("force_python", [False, True])
def test_cycle_schedule_equals_original(force_python):
    cb, meta = TOY.build_cycle(force_python=force_python)
    jcb, jmeta = JTOY.build_cycle(force_python=force_python)
    s, j = cb.compile(), jcb.compile()
    assert meta == jmeta
    assert s.inputs == j.inputs and s.outputs == j.outputs
    assert s.consts == j.consts and s.num_wires == j.num_wires
    assert (s.num_gates, s.num_levels) == (j.num_gates, j.num_levels) == \
        (296, 22)
    assert s.levels == [[(op, [tuple(q) for q in qs]) for op, qs in lvl]
                        for lvl in j.levels]


def test_encrypt_state_layout(tiny_key):
    sk, _ = tiny_key
    progs = [PROGRAMS["alu"], PROGRAMS["loop"]]
    ins = TOY.encrypt_state(progs, sk, np.random.default_rng(3),
                            device="cpu")
    want = JTOY.encrypt_state(progs, sk, np.random.default_rng(3))
    assert len(ins) == len(want) == 188
    for got, w in zip(ins, want):
        assert got.data.device.type == "cpu" and got.level == 0
        assert np.array_equal(to_u32(got.data), np.asarray(w.data))
    acc, pc = TOY.decrypt_state(ins[-12:], sk)
    assert acc.tolist() == [0, 0] and pc.tolist() == [0, 0]


@pytest.fixture(scope="module")
def run3(tiny_key):
    """Three encrypted lanes, two cycles, through the port's loop mode."""
    sk, ek = tiny_key
    sched = TOY.build_cycle()[0].compile()
    progs = [PROGRAMS["alu"], PROGRAMS["countdown"], PROGRAMS["jz_untaken"]]
    ins = TOY.encrypt_state(progs, sk, np.random.default_rng(4),
                            device="cpu")
    ctx = Context(ek, device="cpu")
    return sk, ek, ctx, sched, progs, ins, TOY.run_cycles(ctx, sched, ins, 2)


def test_encrypted_run_equals_original(run3):
    """The same ciphertexts through cufhe_tpu's run_cycles: equal as
    uint32, and equal to the interpreter."""
    sk, ek, _, sched, progs, ins, state = run3
    jsched = JTOY.build_cycle()[0].compile()
    want = JTOY.run_cycles(JA.Context(ek), jsched,
                           [JA.Ctxt(to_u32(c.data), 0) for c in ins], 2)
    assert len(state) == len(want) == 12
    for got, w in zip(state, want):
        assert np.array_equal(to_u32(got.data), np.asarray(w.data))
    acc, pc = TOY.decrypt_state(state, sk)
    for lane, prog in enumerate(progs):
        assert (acc[lane], pc[lane]) == TOY.interpret(prog, 2)


def test_scan_equals_loop(run3, monkeypatch):
    """scan=True (run_schedule_loop with the 12 feedback pairs) is
    bit-identical to the loop and launches the plan's rotations per
    cycle."""
    sk, _, ctx, sched, progs, ins, state = run3
    count = [0]
    orig = BR.blind_rotate

    def counting(*args, **kwargs):
        count[0] += 1
        return orig(*args, **kwargs)
    monkeypatch.setattr(BR, "blind_rotate", counting)
    scanned = TOY.run_cycles(ctx, sched, ins, 2, scan=True)
    assert count[0] == 2 * EX.plan_rotations(
        EX.schedule_steps(ctx, sched, len(progs)))
    for a, b in zip(state, scanned):
        assert torch.equal(a.data, b.data)
    assert all(isinstance(c, Ctxt) for c in scanned)
