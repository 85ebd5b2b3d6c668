"""Circuit graph builder + level scheduler (native C++ core, ctypes ABI).

A copy of cufhe_tpu/runtime/graph.py. The reference leaves gate scheduling
to callers polling CUDA streams (reference test_intensive.cc:21-54 is the
canonical hand-rolled scheduler). Here scheduling is a first-class native
runtime component: the C++ core (`_native/circuit.cpp`, built by
_build.load_host) builds the DAG, dead-code-eliminates it, levelizes it
ASAP, and groups each level by opcode; the executor then runs each level's
groups as batched gate calls on the card.

There is no silent fallback: a failed native build raises.
CircuitBuilder(force_python=True) is the explicit pure-Python path, with
identical semantics (the tests hold the two against each other).
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Opcodes (shared contract between Python and the native scheduler; the
# scheduler itself only interprets arity).
# ---------------------------------------------------------------------------
OPS_2IN = ("and", "andyn", "andny", "or", "oryn", "orny", "nand", "nor",
           "xor", "xnor")
OPS_3IN = ("mux", "nmux")
OPS_1IN = ("not", "copy")
OPCODES: Dict[str, int] = {name: i for i, name in
                           enumerate(OPS_2IN + OPS_3IN + OPS_1IN)}
OPNAMES: Dict[int, str] = {v: k for k, v in OPCODES.items()}


def _op_arity(name: str) -> int:
    if name in OPS_2IN:
        return 2
    if name in OPS_3IN:
        return 3
    return 1


#: NEG_VARIANT[op][i] = the gate computing `op` with input i negated.
#: TFHE NOT is ciphertext negation and the variants' linear-combination
#: constants (golden.GATE_CONSTANTS) differ by exactly that sign, so
#: op(not(x), b) -> NEG_VARIANT[op][0](x, b) is ciphertext-BIT-exact for
#: the eight +-1-coefficient gates (and mux/copy rewrites are bit-exact
#: too). xor/xnor use +-2 coefficients: there the rewrite's pre-rotation
#: sum differs by 4x the negated input's *noise* (4*mu wraps to 0 mod
#: 2^32), so it is decode-equivalent with an identical noise bound but
#: not bit-identical. (Reference per-gate constant table:
#: bootstrap_gpu.cu:424-512.) Mirrored by kNegVar in _native/circuit.cpp
#: (test_runtime asserts agreement).
NEG_VARIANT: Dict[str, Tuple[str, str]] = {
    "and": ("andny", "andyn"), "andyn": ("nor", "and"),
    "andny": ("and", "nor"), "or": ("orny", "oryn"),
    "oryn": ("nand", "or"), "orny": ("or", "nand"),
    "nand": ("oryn", "orny"), "nor": ("andyn", "andny"),
    "xor": ("xnor", "xnor"), "xnor": ("xor", "xor"),
}
_NEG2: Dict[int, Tuple[int, int]] = {
    OPCODES[k]: (OPCODES[a], OPCODES[b]) for k, (a, b) in NEG_VARIANT.items()}


def _optimize_wires(wires, outputs):
    """NOT/COPY absorption (the Python mirror of the native optimize_pass).

    Canonicalize every wire to (root, parity) — COPY aliases, NOT flips
    parity — then fold operand parity into the negated-input gate variants
    (bit-exact, see NEG_VARIANT), swap mux branches on a negated selector,
    and route mux data operands / circuit outputs that need a materialized
    negation through one canonical NOT wire per root. Returns rewritten
    (wires, outputs); absorbed NOT/COPY gates become dead and fall to DCE.
    """
    NOT, COPY = OPCODES["not"], OPCODES["copy"]
    MUX, NMUX = OPCODES["mux"], OPCODES["nmux"]
    n = len(wires)
    root = [0] * n
    par = [0] * n
    not_of: Dict[int, int] = {}
    new = list(wires)
    for w, (op, args) in enumerate(wires):
        if op == COPY and len(args) == 1:
            root[w], par[w] = root[args[0]], par[args[0]]
        elif op == NOT and len(args) == 1:
            a = args[0]
            root[w], par[w] = root[a], par[a] ^ 1
            if par[w]:
                new[w] = (NOT, (root[a],))   # canonical NOT reads the root
                not_of.setdefault(root[w], w)
        else:
            root[w], par[w] = w, 0
            if op >= 0 and len(args) == 2:
                o = op
                aa = []
                for i, a in enumerate(args):
                    if par[a]:
                        o = _NEG2[o][i]
                    aa.append(root[a])
                new[w] = (o, tuple(aa))
            elif op in (MUX, NMUX) and len(args) == 3:
                c, t, f = args
                if par[c]:
                    t, f = f, t
                t = not_of[root[t]] if par[t] else root[t]
                f = not_of[root[f]] if par[f] else root[f]
                new[w] = (op, (root[c], t, f))
    outs = [not_of[root[o]] if par[o] else root[o] for o in outputs]
    return new, outs


# ---------------------------------------------------------------------------
# Native library build/load
# ---------------------------------------------------------------------------
_LIB: Optional[ctypes.CDLL] = None


def _load_native() -> ctypes.CDLL:
    """The native scheduler, built at first use; raises if it cannot be
    built or loaded."""
    global _LIB
    if _LIB is None:
        from .._build import load_host
        lib = load_host()
        _bind_native(lib)
        _LIB = lib
    return _LIB


def _bind_native(lib: ctypes.CDLL) -> None:
    I32, P = ctypes.c_int32, ctypes.POINTER(ctypes.c_int32)
    lib.cb_new.restype = ctypes.c_void_p
    lib.cb_free.argtypes = [ctypes.c_void_p]
    lib.cb_input.argtypes = [ctypes.c_void_p]
    lib.cb_input.restype = I32
    lib.cb_const.argtypes = [ctypes.c_void_p, I32]
    lib.cb_const.restype = I32
    lib.cb_gate.argtypes = [ctypes.c_void_p, I32, I32, P]
    lib.cb_gate.restype = I32
    lib.cb_output.argtypes = [ctypes.c_void_p, I32]
    lib.cb_output.restype = I32
    lib.cb_compile.argtypes = [ctypes.c_void_p]
    lib.cb_compile.restype = I32
    lib.cb_set_optimize.argtypes = [ctypes.c_void_p, I32]
    lib.cb_set_optimize.restype = None
    for fn in ("cb_num_wires", "cb_num_levels", "cb_num_outputs",
               "cb_num_inputs"):
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
        getattr(lib, fn).restype = I32
    lib.cb_level_num_ops.argtypes = [ctypes.c_void_p, I32]
    lib.cb_level_num_ops.restype = I32
    lib.cb_level_op.argtypes = [ctypes.c_void_p, I32, I32, P]
    lib.cb_level_op.restype = I32
    lib.cb_level_gates.argtypes = [ctypes.c_void_p, I32, I32, P]
    lib.cb_level_gates.restype = I32
    lib.cb_outputs.argtypes = [ctypes.c_void_p, P]
    lib.cb_inputs.argtypes = [ctypes.c_void_p, P]
    lib.cb_const_value.argtypes = [ctypes.c_void_p, I32]
    lib.cb_const_value.restype = I32
    lib.cb_wire_level.argtypes = [ctypes.c_void_p, I32]
    lib.cb_wire_level.restype = I32


def native_available() -> bool:
    """Whether the native scheduler builds and loads here (CircuitBuilder()
    raises where it does not)."""
    try:
        _load_native()
    except (RuntimeError, OSError):
        return False
    return True


# ---------------------------------------------------------------------------
# Schedule container
# ---------------------------------------------------------------------------
class Schedule:
    """Compiled circuit: per-level, per-op flat [out, a, b, c] gate lists."""

    def __init__(self, num_wires: int, inputs: List[int], outputs: List[int],
                 consts: Dict[int, int],
                 levels: List[List[Tuple[str, List[Tuple[int, int, int, int]]]]]):
        self.num_wires = num_wires
        self.inputs = inputs
        self.outputs = outputs
        self.consts = consts              # wire -> 0/1
        self.levels = levels              # [level][(opname, [(out,a,b,c)])]

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    @property
    def num_gates(self) -> int:
        return sum(len(g) for lvl in self.levels for _, g in lvl)


class CircuitBuilder:
    """DAG builder. Uses the native C++ scheduler (raising if it cannot be
    built), or with force_python=True a semantically identical pure-Python
    path (exercised by tests either way).
    """

    def __init__(self, force_python: bool = False):
        self._lib = None if force_python else _load_native()
        if self._lib is not None:
            self._h = ctypes.c_void_p(self._lib.cb_new())
        else:
            self._wires: List[Tuple[int, Tuple[int, ...]]] = []  # (op, args)
            self._inputs: List[int] = []
            self._outputs: List[int] = []
        self._consts: Dict[int, int] = {}

    def __del__(self):
        if getattr(self, "_lib", None) is not None and self._h:
            self._lib.cb_free(self._h)
            self._h = None

    # -- construction ----------------------------------------------------
    def input(self) -> int:
        if self._lib is not None:
            return self._lib.cb_input(self._h)
        self._wires.append((-1, ()))
        self._inputs.append(len(self._wires) - 1)
        return len(self._wires) - 1

    def const(self, value: int) -> int:
        if self._lib is not None:
            w = self._lib.cb_const(self._h, int(value))
        else:
            self._wires.append((-2, ()))
            w = len(self._wires) - 1
        self._consts[w] = int(value) & 1
        return w

    def gate(self, op: str, *args: int) -> int:
        if op not in OPCODES:
            raise ValueError(f"unknown op {op!r}")
        if len(args) != _op_arity(op):
            raise ValueError(f"{op} takes {_op_arity(op)} args, got "
                             f"{len(args)}")
        if self._lib is not None:
            arr = (ctypes.c_int32 * len(args))(*args)
            w = self._lib.cb_gate(self._h, OPCODES[op], len(args), arr)
            if w < 0:
                raise ValueError(f"invalid wire among {args}")
            return w
        n = len(self._wires)
        if any(a < 0 or a >= n for a in args):
            raise ValueError(f"invalid wire among {args}")
        self._wires.append((OPCODES[op], tuple(args)))
        return n

    def output(self, wire: int) -> None:
        if self._lib is not None:
            if self._lib.cb_output(self._h, wire) < 0:
                raise ValueError(f"invalid wire {wire}")
            return
        if wire < 0 or wire >= len(self._wires):
            raise ValueError(f"invalid wire {wire}")
        self._outputs.append(wire)

    # convenience named builders
    def __getattr__(self, name):
        if name in OPCODES:
            return lambda *args: self.gate(name, *args)
        raise AttributeError(name)

    # -- compilation -------------------------------------------------------
    def compile(self, optimize: bool = True) -> Schedule:
        """Levelize (+ DCE) the DAG into a Schedule. optimize=True (default)
        first absorbs NOT/COPY chains into gate variants — bit-exact on
        ciphertexts (NEG_VARIANT) — removing their levels and dispatch
        steps. The native pass rewrites wires in place, so a builder that
        has compiled optimized once stays optimized."""
        if self._lib is not None:
            return self._compile_native(optimize)
        return self._compile_python(optimize)

    def _compile_native(self, optimize: bool = True) -> Schedule:
        lib, h = self._lib, self._h
        lib.cb_set_optimize(h, 1 if optimize else 0)
        nlv = lib.cb_compile(h)
        if nlv < 0:
            raise RuntimeError("native compile failed")
        n_out = lib.cb_num_outputs(h)
        outs = (ctypes.c_int32 * max(n_out, 1))()
        lib.cb_outputs(h, outs)
        n_in = lib.cb_num_inputs(h)
        ins = (ctypes.c_int32 * max(n_in, 1))()
        lib.cb_inputs(h, ins)
        levels = []
        for lvl in range(1, nlv):
            groups = []
            cnt = ctypes.c_int32(0)
            for idx in range(lib.cb_level_num_ops(h, lvl)):
                op = lib.cb_level_op(h, lvl, idx, ctypes.byref(cnt))
                buf = (ctypes.c_int32 * (cnt.value * 4))()
                lib.cb_level_gates(h, lvl, op, buf)
                quads = [(buf[4 * i], buf[4 * i + 1], buf[4 * i + 2],
                          buf[4 * i + 3]) for i in range(cnt.value)]
                groups.append((OPNAMES[op], quads))
            levels.append(groups)
        return Schedule(lib.cb_num_wires(h), list(ins[:n_in]),
                        list(outs[:n_out]), dict(self._consts), levels)

    def _compile_python(self, optimize: bool = True) -> Schedule:
        wires, outputs = self._wires, self._outputs
        if optimize:
            wires, outputs = _optimize_wires(wires, outputs)
        n = len(wires)
        live = [False] * n
        stack = list(outputs)
        while stack:
            w = stack.pop()
            if live[w]:
                continue
            live[w] = True
            stack.extend(wires[w][1])
        level = [0] * n
        max_level = 0
        for w, (op, args) in enumerate(wires):
            if not live[w]:
                level[w] = -1
                continue
            if not args:
                level[w] = 0
                continue
            level[w] = 1 + max(level[a] for a in args)
            max_level = max(max_level, level[w])
        # one pass in wire order: each (level, op) group keeps wire order
        by_level: List[Dict[int, List[Tuple[int, int, int, int]]]] = [
            {} for _ in range(max_level + 1)]
        for w, (op, args) in enumerate(wires):
            if level[w] <= 0 or not args:
                continue
            a = list(args) + [-1] * (3 - len(args))
            by_level[level[w]].setdefault(op, []).append((w, a[0], a[1],
                                                          a[2]))
        levels = [[(OPNAMES[op], by_op[op]) for op in sorted(by_op)]
                  for by_op in by_level[1:]]
        return Schedule(n, list(self._inputs), list(outputs),
                        dict(self._consts), levels)


# ---------------------------------------------------------------------------
# Netlist helpers for common circuits (mirrors models.circuits, but as graphs
# the scheduler can extract level-parallelism from).
# ---------------------------------------------------------------------------
def build_ripple_adder(nbits: int, force_python: bool = False
                       ) -> Tuple[CircuitBuilder, dict]:
    """n-bit ripple-carry adder netlist. Returns (builder, wires) with wires
    a/b (lists LSB-first), cin, sum (list), cout."""
    cb = CircuitBuilder(force_python=force_python)
    a = [cb.input() for _ in range(nbits)]
    b = [cb.input() for _ in range(nbits)]
    cin = cb.input()
    c = cin
    s_bits = []
    for i in range(nbits):
        s1 = cb.gate("xor", a[i], b[i])
        s_bits.append(cb.gate("xor", s1, c))
        c1 = cb.gate("and", a[i], b[i])
        c2 = cb.gate("and", s1, c)
        c = cb.gate("or", c1, c2)
    for s in s_bits:
        cb.output(s)
    cb.output(c)
    return cb, {"a": a, "b": b, "cin": cin, "sum": s_bits, "cout": c}
