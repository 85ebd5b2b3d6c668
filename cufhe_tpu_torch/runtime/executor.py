"""Schedule executor: runs a compiled circuit level by level on a Context.

The counterpart of cufhe_tpu/runtime/executor.py, bit-identical to it. The
register file is one [S, B, dim+1] int32 tensor on the context's device
(S = peak-liveness slots, allocate_slots). Each step of a level gathers its
operand rows with index_select, runs one batched gate program
(ops.bootstrap: every two-input gate of the level through gate_lvl0/1 with
per-row constants, mux_lvl0/1, or the linear not/copy) and scatters the
result back in place with index_copy_. This realizes on the batch axis the
concurrency the reference gets from one CUDA block per gate across streams
(reference cufhe_gpu.cuh:152-189); the level schedule makes it
dependence-safe (the reference's StreamQuery polling loop,
test_intensive.cc:21-54, done statically by the native scheduler).

Every step is one eager call: the JAX package's whole-schedule fusion and
its tail-bucket padding exist only to bound XLA compiles and are left out
(their padding duplicates rows and never changes a result). Each step's
gate call goes through Context._map, so it runs the context's backend and,
under a mesh, cuts the step's rows across the mesh's devices; the batch
must then divide by the mesh's size.
"""
from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..models.api import Context, Ctxt
from ..ops import bootstrap as B
from ..torus import i32
from ..utils.spans import count, span
from .graph import Schedule

_LINEAR = ("not", "copy")
_MUX = ("mux", "nmux")


def trivial_ciphertext(value: int, dim: int, mu: int, batch: int,
                       device="cuda") -> torch.Tensor:
    """Noiseless public ciphertext of a constant bit: a = 0, b = +-mu, as
    [batch, dim+1] int32 on `device` (TFHE 'trivial sample'; decrypts to
    `value` under any key)."""
    ct = torch.zeros((batch, dim + 1), dtype=torch.int32, device=device)
    ct[:, dim] = i32(mu if value else -mu)
    return ct


def allocate_slots(sched: Schedule) -> Dict[int, int]:
    """Liveness-based register allocation: wire -> physical slot (a copy of
    the JAX package's).

    A dense [num_wires, B, width] register file does not scale (a Bristol
    AES-128 netlist is ~36k wires). The scheduler already levelizes, so a
    wire's slot can be recycled once its last read has executed, but NOT
    within that same level: each step of a level scatters in place as soon
    as it runs, so slots freed by level L's reads only become allocatable
    at L+1. Returns the wire->slot map; the register file needs
    max(slot)+1 = peak-liveness slots instead of num_wires.
    """
    last_read: Dict[int, int] = {}
    for lvl, groups in enumerate(sched.levels, start=1):
        for _, quads in groups:
            for q in quads:
                for w in q[1:]:
                    if w >= 0:
                        last_read[w] = lvl
    for w in sched.outputs:
        last_read[w] = len(sched.levels) + 1   # outputs live to the end

    expire: Dict[int, List[int]] = {}
    for w, lvl in last_read.items():
        expire.setdefault(lvl, []).append(w)

    slot: Dict[int, int] = {}
    free: List[int] = []
    hi = 0

    def alloc(w: int) -> None:
        nonlocal hi
        if w in slot:
            return
        if free:
            slot[w] = free.pop()
        else:
            slot[w] = hi
            hi += 1

    for w in sched.inputs:
        alloc(w)
    for w in sched.consts:
        alloc(w)
    for lvl, groups in enumerate(sched.levels, start=1):
        # a level's outputs may not reuse slots freed by that same level's
        # operand reads: a later step of the level would read a slot an
        # earlier step already overwrote
        for _, quads in groups:
            for q in quads:
                alloc(q[0])
        for w in expire.get(lvl, ()):
            if w in slot:              # defined earlier => slot assigned
                free.append(slot[w])
    return slot


def simulate_schedule(sched: Schedule,
                      inputs: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Plaintext (cleartext-bit) execution of a compiled circuit: the
    oracle for encrypted runs (the reference's plain.h truth-table model,
    test/plain.h:10-69, applied to whole netlists). inputs[i] is a bit
    array feeding sched.inputs[i]; arrays broadcast together (batch)."""
    from ..golden import PLAIN_GATES

    vals: Dict[int, np.ndarray] = {}
    for w, bits in zip(sched.inputs, inputs):
        vals[w] = np.asarray(bits).astype(np.int64)
    for w, v in sched.consts.items():
        vals[w] = np.int64(v)
    for groups in sched.levels:
        for opname, quads in groups:
            if opname in _MUX:  # PLAIN_GATES mux is scalar-only
                for q in quads:
                    sel = np.where(vals[q[1]] == 1, vals[q[2]], vals[q[3]])
                    vals[q[0]] = (1 - sel) if opname == "nmux" else sel
                continue
            fn = PLAIN_GATES[opname]
            for q in quads:
                args = [vals[a] for a in q[1:] if a >= 0]
                vals[q[0]] = fn(*args)
    return [vals[w] for w in sched.outputs]


def _exec_chunk(batch: int) -> int:
    """Most two-input gates per step: about 16k bootstraps per call while
    batch <= 256 (64 gates at least, 1024 at most). CUFHE_EXEC_CHUNK
    overrides it (the tests force several steps per level with it)."""
    env = os.environ.get("CUFHE_EXEC_CHUNK", "")
    if env:
        return int(env)
    return min(1024, max(64, (16384 // batch) // 64 * 64))


def plan_schedule(sched: Schedule, slot: Dict[int, int], chunk: int,
                  mu: int, device) -> List[List[tuple]]:
    """Per level, the steps run_schedule takes, in order:
    ("lin", idx, outs, negate) for a not/copy group, ("mux", ic, i1, i0,
    outs, negate) for a mux/nmux group, and ("two", ina, inb, outs, c3) for
    each chunk of at most `chunk` two-input gates of any of the ten kinds,
    c3 their per-gate constants [G, 3] (encode_gate_consts_rows). Index
    tensors are int64 slot numbers on `device`."""
    def idx(vals):
        return torch.tensor(vals, dtype=torch.int64, device=device)

    plans = []
    for groups in sched.levels:
        plan, two, names = [], [], []
        for opname, quads in groups:
            if opname in _LINEAR:
                plan.append(("lin", idx([slot[q[1]] for q in quads]),
                             idx([slot[q[0]] for q in quads]),
                             opname == "not"))
            elif opname in _MUX:
                plan.append(("mux", *(idx([slot[q[j]] for q in quads])
                                      for j in (1, 2, 3, 0)),
                             opname == "nmux"))
            else:
                two.extend(quads)
                names.extend([opname] * len(quads))
        for pos in range(0, len(two), chunk):
            quads = two[pos:pos + chunk]
            plan.append(("two", idx([slot[q[1]] for q in quads]),
                         idx([slot[q[2]] for q in quads]),
                         idx([slot[q[0]] for q in quads]),
                         B.encode_gate_consts_rows(names[pos:pos + chunk],
                                                   mu, device)))
        plans.append(plan)
    return plans


def plan_rotations(plans: List[List[tuple]]) -> int:
    """Blind rotations the plan launches: one per two-input step, two per
    mux step."""
    return sum({"two": 1, "mux": 2}.get(step[0], 0)
               for plan in plans for step in plan)


def _run_step(ctx: Context, regs: torch.Tensor, step: tuple,
              level: int) -> None:
    """Gather -> one batched gate program (through ctx._map) -> in-place
    scatter."""
    S, bsz, width = regs.shape
    p, path = ctx.params, ctx._path

    def rows(idx):
        return regs.index_select(0, idx).reshape(-1, width)

    kind = step[0]
    if kind == "two":
        _, ina, inb, outs, c3 = step
        fn = B.gate_lvl0 if level == 0 else B.gate_lvl1
        res = ctx._map(lambda k, c, x, y: fn(c, x, y, k, p, path),
                       [c3.repeat_interleave(bsz, dim=0), rows(ina),
                        rows(inb)])
    elif kind == "mux":
        _, ic, i1, i0, outs, neg = step
        fn = B.mux_lvl0 if level == 0 else B.mux_lvl1
        res = ctx._map(lambda k, c, x1, x0: fn(c, x1, x0, k, p, neg, path),
                       [rows(ic), rows(i1), rows(i0)])
    else:
        _, idx, outs, neg = step
        res = rows(idx)
        if neg:
            res = B.not_gate(res)
    regs.index_copy_(0, outs, res.reshape(-1, bsz, width))


def _check_inputs(ctx: Context, sched: Schedule, inputs: Sequence[Ctxt]):
    if len(inputs) != len(sched.inputs):
        raise ValueError(f"circuit has {len(sched.inputs)} inputs, "
                         f"got {len(inputs)}")
    if not inputs:
        raise ValueError("a circuit needs at least one input to define the "
                         "batch shape")
    Bsz, width = inputs[0].data.shape
    lvl = inputs[0].level
    for ct in inputs:
        if tuple(ct.data.shape) != (Bsz, width) or ct.level != lvl:
            raise ValueError("all inputs must share shape and level")
    if ctx.mesh is not None and Bsz % ctx.mesh.size:
        raise ValueError(f"batch {Bsz} is not divisible by the "
                         f"{ctx.mesh.size}-device mesh")
    return Bsz, width, lvl


class _Program:
    """A schedule laid out for one batch shape and level on a context: its
    slot map, register-file size and step plan."""

    def __init__(self, ctx: Context, sched: Schedule, batch: int,
                 level: int):
        count("executor.plans")
        with span("cufhe.executor.plan"):
            lp = ctx.params.lvl0 if level == 0 else ctx.params.lvl1
            self.width = lp.dim + 1
            self.mu = lp.mu
            self.level = level
            self.slot = allocate_slots(sched)
            self.num_slots = max(self.slot.values()) + 1 if self.slot else 1
            self.plans = plan_schedule(sched, self.slot, _exec_chunk(batch),
                                       lp.mu, ctx.device)
            self.const_rows = [(self.slot[w], v)
                               for w, v in sched.consts.items()]

    def registers(self, ctx: Context, rows: List[int],
                  planes: List[torch.Tensor]) -> torch.Tensor:
        """A fresh register file holding the input planes at `rows` and the
        trivial ciphertexts of the constants."""
        Bsz = planes[0].shape[0]
        regs = torch.zeros((self.num_slots, Bsz, self.width),
                           dtype=torch.int32, device=ctx.device)
        for row, val in self.const_rows:
            regs[row] = trivial_ciphertext(val, self.width - 1, self.mu, Bsz,
                                           ctx.device)
        regs[torch.tensor(rows, dtype=torch.int64,
                          device=ctx.device)] = torch.stack(planes)
        return regs

    def outputs(self, regs: torch.Tensor,
                sched: Schedule) -> List[torch.Tensor]:
        """The output rows, copied out of the register file."""
        rows = torch.tensor([self.slot[w] for w in sched.outputs],
                            dtype=torch.int64, device=regs.device)
        return list(regs.index_select(0, rows).unbind(0))

    def run(self, ctx: Context, regs: torch.Tensor) -> torch.Tensor:
        ctx._check_keys()                   # raises on released keys
        for plan in self.plans:
            for step in plan:
                with span("cufhe.executor.step"):
                    _run_step(ctx, regs, step, self.level)
        return regs


def schedule_steps(ctx: Context, sched: Schedule, batch: int,
                   level: int = 0) -> List[List[tuple]]:
    """The step plan run_schedule follows for `batch` rows at `level`
    (see plan_schedule)."""
    return _Program(ctx, sched, batch, level).plans


def precompile_schedule(ctx: Context, sched: Schedule, batch: int,
                        level: int = 0) -> int:
    """Build the kernels run_schedule will launch (nothing to build on the
    CPU) and return the number of distinct step shapes of its plan: the
    programs a per-shape CUDA-graph capture would record. Under a mesh it
    returns 0, as the JAX package's does."""
    if ctx.mesh is not None:
        return 0
    if ctx.device.type == "cuda":
        from .._build import load
        load()
    shapes = {(step[0], step[1].shape[0], step[-1] if step[0] != "two"
               else None)
              for plan in schedule_steps(ctx, sched, batch, level)
              for step in plan}
    return len(shapes)


def run_schedule(ctx: Context, sched: Schedule, inputs: Sequence[Ctxt],
                 level: int = 0) -> List[Ctxt]:
    """Execute a compiled circuit. inputs[i] feeds sched.inputs[i]; every
    input batch must share shape [B, dim+1] and level. Returns output Ctxts
    in declaration order, on the context's device. Runs on the current
    stream after the inputs' producers (Ctxt.ready). A circuit with neither
    inputs nor constants has nothing to run and returns []; one with
    constants but no inputs has no batch shape and raises."""
    if not inputs and not sched.inputs and not sched.consts:
        return []
    Bsz, _, lvl = _check_inputs(ctx, sched, inputs)
    with span("cufhe.executor.run"):
        prog = _Program(ctx, sched, Bsz, lvl)
        regs = prog.registers(ctx, [prog.slot[w] for w in sched.inputs],
                              ctx._inputs(*inputs))
        prog.run(ctx, regs)
        return ctx._outputs(prog.outputs(regs, sched), lvl)


def run_schedule_loop(ctx: Context, sched: Schedule, inputs: Sequence[Ctxt],
                      cycles: int, feedback: Sequence[Tuple[int, int]],
                      level: int = 0, segment: int = 0) -> List[Ctxt]:
    """Run a feedback circuit for `cycles` iterations: each iteration,
    output `o` feeds input `i` for every (o, i) pair in `feedback`; all
    other inputs are re-presented unchanged (e.g. an encrypted ROM), and
    constants are re-written. Returns the final iteration's outputs,
    bit-identical to calling run_schedule in a loop and copying outputs to
    inputs.

    The JAX package runs the loop as one scanned program, cut into
    dispatches of `segment` cycles; here every cycle is a loop of eager
    steps, so `segment` is accepted and changes nothing."""
    if cycles < 1 or segment < 0:
        raise ValueError("need cycles >= 1 and segment >= 0")
    Bsz, _, lvl = _check_inputs(ctx, sched, inputs)
    n_out = len(sched.outputs)
    for o, i in feedback:
        if not (0 <= o < n_out and 0 <= i < len(inputs)):
            raise ValueError(f"feedback pair {(o, i)} out of range")
    prog = _Program(ctx, sched, Bsz, lvl)
    in_rows = [prog.slot[w] for w in sched.inputs]
    planes = ctx._inputs(*inputs)
    for _ in range(cycles):
        with span("cufhe.executor.run"):
            regs = prog.run(ctx, prog.registers(ctx, in_rows, planes))
            outs = prog.outputs(regs, sched)
            for o, i in feedback:
                planes[i] = outs[o]
    return ctx._outputs(outs, lvl)
