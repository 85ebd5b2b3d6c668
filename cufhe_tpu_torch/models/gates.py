"""Gate registry: the reference's 14 logical ops with their
linear-combination constants (a copy of cufhe_tpu/models/gates.py, which is
reachable only through a package that imports JAX)."""
from __future__ import annotations

from ..golden import GATE_CONSTANTS, PLAIN_GATES  # single source

#: two-input bootstrapped gates
TWO_INPUT = tuple(GATE_CONSTANTS)
#: three-input (double-rotation) gates
MUX_GATES = ("mux", "nmux")
#: linear (non-bootstrapped) gates
LINEAR = ("not", "copy")

ALL_GATES = TWO_INPUT + MUX_GATES + LINEAR

__all__ = ["GATE_CONSTANTS", "PLAIN_GATES", "TWO_INPUT", "MUX_GATES",
           "LINEAR", "ALL_GATES"]
