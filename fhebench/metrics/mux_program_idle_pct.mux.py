"""mux_program_idle_pct.mux: the share of the traced window, in percent,
in which the device was idle in gaps that opened while the host was in a
MUX program's own time (cufhe.gate.mux: the pre-adds, test vectors and
mod switches of both rotations, their sum, extraction) or in the key
switch (cufhe.key_switch). Moves bootstraps_per_s.

A program that records its MUX under cufhe.gate, as the port did before
it had a span of its own for the MUX, reads nothing (None); a window with
neither span raises, as a renamed span must never read as 0."""
from fhebench import spans

NAMES = ("cufhe.gate.mux", "cufhe.key_switch")


def read(reading):
    sp = spans.Spans(reading.trace)
    if sp and "cufhe.gate.mux" not in sp.names and "cufhe.gate" in sp.names:
        return None
    return spans.idle_pct(reading.trace, NAMES)
