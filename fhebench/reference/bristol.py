"""Plain evaluation of a Bristol Fashion netlist on cleartext bits.

A reference for circuits that have no standard of their own: it reads the
netlist text and evaluates each gate line on bits, in file order (the
format lists gates topologically). Inputs are the first wires, outputs the
last ones, as the format defines them.
"""
from __future__ import annotations

import numpy as np

_OPS = {
    "XOR": lambda a, b: a ^ b, "AND": lambda a, b: a & b,
    "OR": lambda a, b: a | b, "NAND": lambda a, b: 1 - (a & b),
    "NOR": lambda a, b: 1 - (a | b), "XNOR": lambda a, b: 1 - (a ^ b),
    "ANDYN": lambda a, b: a & (1 - b), "ANDNY": lambda a, b: (1 - a) & b,
    "ORYN": lambda a, b: a | (1 - b), "ORNY": lambda a, b: (1 - a) | b,
    "INV": lambda a: 1 - a, "NOT": lambda a: 1 - a, "EQW": lambda a: a,
    "MUX": lambda s, a, b: np.where(s == 1, b, a),
}


def outputs(bristol: str, inputs: np.ndarray) -> np.ndarray:
    """Output bits [B, n_out] of input bits [B, n_in]."""
    lines = [ln.split() for ln in bristol.strip().splitlines() if ln.strip()]
    n_wires = int(lines[0][1])
    n_in = sum(int(w) for w in lines[1][1:1 + int(lines[1][0])])
    n_out = sum(int(w) for w in lines[2][1:1 + int(lines[2][0])])
    inputs = np.asarray(inputs, dtype=np.int64)
    wires = {w: inputs[:, w] for w in range(n_in)}
    for toks in lines[3:]:
        k = int(toks[0])
        ins, out, op = toks[2:2 + k], int(toks[2 + k]), toks[3 + k].upper()
        if op == "EQ":
            wires[out] = np.full(inputs.shape[0], int(ins[0]))
        else:
            wires[out] = _OPS[op](*(wires[int(w)] for w in ins))
    return np.stack([wires[w] for w in range(n_wires - n_out, n_wires)],
                    axis=1)
