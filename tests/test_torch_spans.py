"""cufhe_tpu_torch.utils.spans on the CPU: span builds nothing while no
profiler records; under torch.profiler the executor, the gate program, the
key switch and the blind rotation give the tree of cufhe.* spans the
benchmark reads, one span per planned step and per rotation; the
executor.plans counter counts every _Program built and executor.plan_hits
every call served by one built before."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cufhe_tpu_torch import Context, TINY, encrypt_bits
from cufhe_tpu_torch import golden as G
from cufhe_tpu_torch.runtime import executor as EX
from cufhe_tpu_torch.runtime import run_schedule, run_schedule_loop
from cufhe_tpu_torch.runtime.bristol import compile_bristol
from cufhe_tpu_torch.utils import spans

#: a 2-bit adder (XOR, AND, OR, EQW) and a circuit with a constant, INV
#: and MUX, in Bristol Fashion
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
CIRCUITS = {"adder2": ADDER2, "const_inv_mux": CONST_INV_MUX}


@pytest.fixture(scope="module")
def tiny():
    """A CPU context at TINY, its secret key and an input maker."""
    sk = G.keygen(TINY, seed=31)
    ek = G.make_eval_key(sk, seed=32)
    rng = np.random.default_rng(33)

    def inputs(sched, batch=2):
        return [encrypt_bits(rng.integers(0, 2, batch), sk, rng,
                             device="cpu") for _ in sched.inputs]
    return Context(ek, device="cpu"), inputs


def _program_spans(prof):
    """[(event, the nearest enclosing cufhe.* span's name or None)] for
    every cufhe.* span the profiler recorded."""
    out = []
    for ev in prof.events():
        if not ev.name.startswith("cufhe."):
            continue
        up = ev.cpu_parent
        while up is not None and not up.name.startswith("cufhe."):
            up = up.cpu_parent
        out.append((ev, up.name if up is not None else None))
    return out


def test_span_without_a_profiler_builds_nothing(monkeypatch, tiny):
    def no_record(*args, **kwargs):
        raise AssertionError("record_function built with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", no_record)
    assert spans.span("cufhe.test") is spans._NULL
    assert spans.span("cufhe.other") is spans._NULL
    ctx, inputs = tiny
    sched, _ = compile_bristol(ADDER2)
    assert len(run_schedule(ctx, sched, inputs(sched))) == len(sched.outputs)


def test_span_records_only_while_a_profiler_does():
    with spans.span("cufhe.test.off"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("cufhe.test.on") as s:
            assert s is not spans._NULL
    names = [ev.name for ev in prof.events()]
    assert names.count("cufhe.test.on") == 1
    assert "cufhe.test.off" not in names
    assert spans.span("cufhe.test.after") is spans._NULL


@pytest.mark.parametrize("chunk", ["", "1"])
@pytest.mark.parametrize("circuit", sorted(CIRCUITS))
def test_run_schedule_span_tree(monkeypatch, tiny, circuit, chunk):
    """run > plan; run > step > gate (two-input) or gate.mux (mux) >
    {blind_rotate, key_switch}; one step span per planned step, one
    blind_rotate span per planned rotation, two a mux. CUFHE_EXEC_CHUNK=1
    cuts each level into one step per gate."""
    monkeypatch.setenv("CUFHE_EXEC_CHUNK", chunk)
    ctx, inputs = tiny
    sched, _ = compile_bristol(CIRCUITS[circuit])
    cts = inputs(sched)
    plans = EX.schedule_steps(ctx, sched, 2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_schedule(ctx, sched, cts)
    got = _program_spans(prof)
    parents = {}
    for ev, up in got:
        parents.setdefault(ev.name, []).append(up)
    assert parents["cufhe.executor.run"] == [None]
    assert parents["cufhe.executor.plan"] == ["cufhe.executor.run"]
    steps = sum(len(plan) for plan in plans)
    assert parents["cufhe.executor.step"] == ["cufhe.executor.run"] * steps
    steps_of = [step[0] for plan in plans for step in plan]
    kinds = {"cufhe.gate": steps_of.count("two"),
             "cufhe.gate.mux": steps_of.count("mux")}
    programs = [name for name, n in kinds.items() if n]
    assert programs, "the circuit runs no bootstrapped gate"
    for name in programs:
        assert parents[name] == ["cufhe.executor.step"] * kinds[name]
    assert sorted(parents["cufhe.blind_rotate"]) == sorted(
        ["cufhe.gate"] * kinds["cufhe.gate"]
        + ["cufhe.gate.mux"] * 2 * kinds["cufhe.gate.mux"])
    assert len(parents["cufhe.blind_rotate"]) == EX.plan_rotations(plans)
    # every gate at lvl0 ends in one key switch, a mux included
    assert sorted(parents["cufhe.key_switch"]) == sorted(
        name for name in programs for _ in range(kinds[name]))
    assert set(parents) == {"cufhe.executor.run", "cufhe.executor.plan",
                            "cufhe.executor.step", "cufhe.blind_rotate",
                            "cufhe.key_switch", *programs}
    # the spans nest in time as well as in the tree
    for ev, _ in got:
        if ev.cpu_parent is not None:
            assert ev.cpu_parent.time_range.start <= ev.time_range.start
            assert ev.time_range.end <= ev.cpu_parent.time_range.end


def test_run_schedule_loop_spans_a_run_per_cycle(tiny):
    ctx, inputs = tiny
    sched, _ = compile_bristol(ADDER2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_schedule_loop(ctx, sched, inputs(sched), 3, [(0, 0)])
    names = [ev.name for ev, _ in _program_spans(prof)]
    assert names.count("cufhe.executor.run") == 3
    assert names.count("cufhe.executor.plan") == 1
    assert names.count("cufhe.executor.step") == 3 * sum(
        len(plan) for plan in EX.schedule_steps(ctx, sched, 2))


def test_executor_plans_counts_every_program(tiny):
    """One program a key: three run_schedule calls of one schedule are one
    build and two hits, and run_schedule_loop on the same key is a hit."""
    ctx, inputs = tiny
    sched, _ = compile_bristol(ADDER2)
    cts = inputs(sched)
    before = spans.counts()
    for i in range(1, 4):
        run_schedule(ctx, sched, cts)
        now = spans.counts() - before
        assert now["executor.plans"] == 1
        assert now["executor.plan_hits"] == i - 1
    run_schedule_loop(ctx, sched, cts, 2, [(0, 0)])
    now = spans.counts() - before
    assert now["executor.plans"] == 1 and now["executor.plan_hits"] == 3


def test_counts_is_a_snapshot():
    snap = spans.counts()
    assert snap["cufhe.test.never"] == 0
    spans.count("test.counter", 3)
    spans.count("test.counter")
    now = spans.counts()
    assert now["test.counter"] - snap["test.counter"] == 4
    assert (now - snap) == {"test.counter": 4}
    now["test.counter"] = -1
    assert spans.counts()["test.counter"] == snap["test.counter"] + 4
