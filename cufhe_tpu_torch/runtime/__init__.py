"""Native runtime: circuit graph builder + level scheduler (C++ core),
batched schedule executor, and streams on CUDA streams and events."""
from .bristol import compile_bristol, load_bristol, parse_bristol
from .executor import (run_schedule, run_schedule_loop,
                       trivial_ciphertext)
from .graph import (CircuitBuilder, OPCODES, Schedule, build_ripple_adder,
                    native_available)
from .stream import Stream, stream_query, synchronize

__all__ = ["CircuitBuilder", "OPCODES", "Schedule", "build_ripple_adder",
           "native_available", "run_schedule", "run_schedule_loop",
           "trivial_ciphertext",
           "Stream", "stream_query", "synchronize",
           "compile_bristol", "load_bristol", "parse_bristol"]
