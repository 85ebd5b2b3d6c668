"""Bristol Fashion circuit importer.

Bristol Fashion is the de-facto standard netlist interchange format for
MPC/FHE tooling (AES/SHA reference circuits etc. are published in it). The
reference library has no netlist support at all — its intended consumer
(the Virtual Secure Platform toolchain) hand-drives gates; here standard
circuits load directly into the native scheduler and run as batched
encrypted programs. A copy of cufhe_tpu/runtime/bristol.py.

Format (new-style "Bristol Fashion"):
    line 1: <num_gates> <num_wires>
    line 2: <n_input_values> <width_0> ... <width_{n-1}>
    line 3: <n_output_values> <width_0> ...
    then one gate per line: <n_in> <n_out> <in...> <out> <OP>
Supported ops: XOR AND OR INV NOT EQ (constant) EQW (copy) NAND NOR XNOR
ANDYN ANDNY ORYN ORNY MUX (3-input: sel a b -> sel ? b : a, per SCALE-MAMBA
convention where the first listed wire is the selector).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from .graph import CircuitBuilder, Schedule

_OP_MAP = {
    "XOR": "xor", "AND": "and", "OR": "or", "NAND": "nand", "NOR": "nor",
    "XNOR": "xnor", "ANDYN": "andyn", "ANDNY": "andny", "ORYN": "oryn",
    "ORNY": "orny",
}


def parse_bristol(text: str) -> Tuple[CircuitBuilder, dict]:
    """Parse a Bristol Fashion netlist into a CircuitBuilder.

    Returns (builder, meta) where meta has 'input_widths', 'output_widths',
    and 'inputs' (builder wire ids per input value, flattened order).
    Gate lines may appear in any topological order; non-ready gates are
    deferred and retried.
    """
    lines = [ln.split() for ln in text.strip().splitlines() if ln.strip()]
    n_gates, n_wires = int(lines[0][0]), int(lines[0][1])
    in_widths = [int(x) for x in lines[1][1:1 + int(lines[1][0])]]
    out_widths = [int(x) for x in lines[2][1:1 + int(lines[2][0])]]
    gate_lines = lines[3:]
    if len(gate_lines) != n_gates:
        raise ValueError(f"expected {n_gates} gates, found {len(gate_lines)}")

    cb = CircuitBuilder()
    wire_map: Dict[int, int] = {}
    n_inputs = sum(in_widths)
    for w in range(n_inputs):
        wire_map[w] = cb.input()

    pending: List[List[str]] = list(gate_lines)
    while pending:
        progressed = False
        nxt: List[List[str]] = []
        for toks in pending:
            n_in, n_out = int(toks[0]), int(toks[1])
            ins = [int(x) for x in toks[2:2 + n_in]]
            outs = [int(x) for x in toks[2 + n_in:2 + n_in + n_out]]
            op = toks[2 + n_in + n_out].upper()
            if n_out != 1:
                raise ValueError(f"unsupported multi-output gate {op}")
            if op == "EQ":
                # input token is the constant value 0/1, not a wire
                wire_map[outs[0]] = cb.const(ins[0])
                progressed = True
                continue
            if any(w not in wire_map for w in ins):
                nxt.append(toks)
                continue
            args = [wire_map[w] for w in ins]
            if op in _OP_MAP:
                wid = cb.gate(_OP_MAP[op], *args)
            elif op in ("INV", "NOT"):
                wid = cb.gate("not", *args)
            elif op == "EQW":
                wid = cb.gate("copy", *args)
            elif op == "MUX":
                # Bristol MUX: (sel, a, b) -> sel ? b : a
                wid = cb.gate("mux", args[0], args[2], args[1])
            else:
                raise ValueError(f"unsupported gate op {op!r}")
            wire_map[outs[0]] = wid
            progressed = True
        if not progressed and nxt:
            missing = sorted({w for t in nxt
                              for w in map(int, t[2:2 + int(t[0])])
                              if w not in wire_map})[:8]
            raise ValueError(f"circuit not topologically satisfiable; "
                             f"undefined wires {missing}")
        pending = nxt

    # outputs are the last sum(out_widths) wires, in order
    n_outputs = sum(out_widths)
    for w in range(n_wires - n_outputs, n_wires):
        if w not in wire_map:
            raise ValueError(f"output wire {w} never defined")
        cb.output(wire_map[w])
    return cb, {"input_widths": in_widths, "output_widths": out_widths,
                "num_wires": n_wires}


def load_bristol(path: str) -> Tuple[CircuitBuilder, dict]:
    with open(path) as f:
        return parse_bristol(f.read())


def compile_bristol(text: str, optimize: bool = True
                    ) -> Tuple[Schedule, dict]:
    cb, meta = parse_bristol(text)
    return cb.compile(optimize=optimize), meta
