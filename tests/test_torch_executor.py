"""The executor's program cache on the CPU (runtime/executor.py:_program):
one program a (context, schedule object, batch, level, step chunk), built
on the key's first call and reused by every later one. A hit gives the
build's words exactly, opens the same one cufhe.executor.plan span, and
still refuses released keys; a new schedule object, batch, level or chunk
builds its own program."""
import gc
import weakref

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from cufhe_tpu_torch import Context, TINY, decrypt_bits, encrypt_bits
from cufhe_tpu_torch import golden as G
from cufhe_tpu_torch.parallel import data_mesh
from cufhe_tpu_torch.runtime import executor as EX
from cufhe_tpu_torch.runtime import run_schedule, run_schedule_loop
from cufhe_tpu_torch.runtime.bristol import compile_bristol
from cufhe_tpu_torch.torus import to_u32
from cufhe_tpu_torch.utils import spans
from test_torch_spans import ADDER2, CIRCUITS


@pytest.fixture(scope="module")
def keys():
    sk = G.keygen(TINY, seed=51)
    return sk, G.make_eval_key(sk, seed=52)


@pytest.fixture(scope="module")
def tiny(keys):
    """A CPU context at TINY and an input maker."""
    sk, ek = keys
    rng = np.random.default_rng(53)

    def inputs(sched, batch=2, level=0):
        return [encrypt_bits(rng.integers(0, 2, batch), sk, rng, level,
                             device="cpu") for _ in sched.inputs]
    return Context(ek, device="cpu"), inputs


def _words(outs):
    return [to_u32(o.data) for o in outs]


def _delta(before):
    now = spans.counts() - before
    return now["executor.plans"], now["executor.plan_hits"]


@pytest.mark.parametrize("change", ["batch", "level", "chunk"])
def test_another_shape_builds_another_program(tiny, keys, monkeypatch,
                                              change):
    """Another batch, level or CUFHE_EXEC_CHUNK is another key: a build,
    after which both keys are hits; each decrypts to the plaintext
    circuit's outputs (lvl1 inputs too)."""
    ctx, inputs = tiny
    sk = keys[0]
    sched, _ = compile_bristol(ADDER2)
    first = inputs(sched)
    second = {"batch": lambda: inputs(sched, batch=3),
              "level": lambda: inputs(sched, level=1),
              "chunk": lambda: first}[change]()
    before = spans.counts()
    run_schedule(ctx, sched, first)
    if change == "chunk":
        monkeypatch.setenv("CUFHE_EXEC_CHUNK", "1")
    run_schedule(ctx, sched, second)
    assert _delta(before) == (2, 0)
    outs = run_schedule(ctx, sched, second)
    monkeypatch.delenv("CUFHE_EXEC_CHUNK", raising=False)
    run_schedule(ctx, sched, first)
    assert _delta(before) == (2, 2)
    bits = [decrypt_bits(c, sk) for c in second]
    for o, want in zip(outs, EX.simulate_schedule(sched, bits)):
        assert o.level == second[0].level
        assert np.array_equal(decrypt_bits(o, sk), want)


def test_a_new_schedule_builds_its_own_program(tiny):
    """Programs belong to the schedule object, held weakly: a schedule
    compiled from the same text, after the first was freed, builds anew,
    and the freed schedule's programs went with it."""
    ctx, inputs = tiny
    sched, _ = compile_bristol(ADDER2)
    cts = inputs(sched)
    want = _words(run_schedule(ctx, sched, cts))
    held = len(EX._PROGRAMS[ctx])
    gone = weakref.ref(sched)
    del sched
    gc.collect()
    assert gone() is None and len(EX._PROGRAMS[ctx]) == held - 1
    before = spans.counts()
    again, _ = compile_bristol(ADDER2)
    got = _words(run_schedule(ctx, again, cts))
    assert _delta(before) == (1, 0)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    other, _ = compile_bristol(ADDER2)     # a second live copy: its own
    run_schedule(ctx, other, cts)
    assert _delta(before) == (2, 0)


@pytest.mark.parametrize("circuit", sorted(CIRCUITS))
def test_a_hit_gives_the_builds_words(tiny, keys, circuit):
    """A hit's outputs equal the build's word for word, and a fresh
    context's (its own build); so does run_schedule_loop on the cached
    program, one cycle with no feedback."""
    ctx, inputs = tiny
    sched, _ = compile_bristol(CIRCUITS[circuit])
    cts = inputs(sched, batch=4)
    before = spans.counts()
    built = _words(run_schedule(ctx, sched, cts))
    hit = _words(run_schedule(ctx, sched, cts))
    loop = _words(run_schedule_loop(ctx, sched, cts, 1, []))
    assert _delta(before) == (1, 2)
    fresh = _words(run_schedule(Context(keys[1], device="cpu"), sched, cts))
    assert _delta(before) == (2, 2)
    for words in (hit, loop, fresh):
        assert len(words) == len(built)
        for g, w in zip(words, built):
            assert np.array_equal(g, w)


@pytest.mark.parametrize("circuit", sorted(CIRCUITS))
def test_one_plan_span_a_call(tiny, circuit):
    """Every call opens exactly one cufhe.executor.plan span inside its
    cufhe.executor.run, the build's and each hit's alike."""
    ctx, inputs = tiny
    sched, _ = compile_bristol(CIRCUITS[circuit])
    cts = inputs(sched)
    before = spans.counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            run_schedule(ctx, sched, cts)
    assert _delta(before) == (1, 2)
    plans = [ev for ev in prof.events() if ev.name == "cufhe.executor.plan"]
    runs = [ev for ev in prof.events() if ev.name == "cufhe.executor.run"]
    assert len(plans) == len(runs) == 3
    assert [ev.cpu_parent.name for ev in plans] == ["cufhe.executor.run"] * 3


def test_released_keys_raise_on_a_cached_program(keys):
    """A cached program still checks the keys on every call: released
    keys raise, restored keys run the hit to the build's words."""
    sk, ek = keys
    ctx = Context(ek, device="cpu")
    sched, _ = compile_bristol(ADDER2)
    rng = np.random.default_rng(54)
    cts = [encrypt_bits(rng.integers(0, 2, 2), sk, rng, device="cpu")
           for _ in sched.inputs]
    want = _words(run_schedule(ctx, sched, cts))
    ctx.release_keys()
    before = spans.counts()
    with pytest.raises(ValueError, match="released"):
        run_schedule(ctx, sched, cts)
    with pytest.raises(ValueError, match="released"):
        run_schedule_loop(ctx, sched, cts, 2, [(0, 0)])
    assert _delta(before) == (0, 2)
    ctx.prepare_backend(ek)
    for g, w in zip(_words(run_schedule(ctx, sched, cts)), want):
        assert np.array_equal(g, w)
    assert _delta(before) == (0, 3)


def test_a_program_is_the_contexts_own(tiny, keys):
    """The cache is per context: the same schedule on a two-shard CPU mesh
    context builds its own program, gives the plain context's words, and
    precompile_schedule there builds the program the first call reuses."""
    ctx, inputs = tiny
    sched, _ = compile_bristol(ADDER2)
    cts = inputs(sched, batch=4)
    want = _words(run_schedule(ctx, sched, cts))
    mesh_ctx = Context(keys[1], mesh=data_mesh(["cpu"] * 2))
    before = spans.counts()
    assert EX.precompile_schedule(mesh_ctx, sched, 4) == 0
    assert _delta(before) == (1, 0)
    got = _words(run_schedule(mesh_ctx, sched, cts))
    assert _delta(before) == (1, 1)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_the_cache_frees_with_its_context(keys):
    """A context's programs go when the context does."""
    sk, ek = keys
    ctx = Context(ek, device="cpu")
    sched, _ = compile_bristol(ADDER2)
    rng = np.random.default_rng(55)
    run_schedule(ctx, sched, [encrypt_bits(rng.integers(0, 2, 2), sk, rng,
                                           device="cpu")
                              for _ in sched.inputs])
    assert ctx in EX._PROGRAMS
    gone = weakref.ref(ctx)
    del ctx
    gc.collect()
    assert gone() is None
