"""gate_program_idle_pct.aes: the share of the traced window, in percent,
in which the device was idle in gaps that opened while the host was in a
gate program's own time (cufhe.gate: pre-add, test vector, mod switch,
extraction) or in the key switch (cufhe.key_switch). Moves
aes_block_ms."""
from fhebench import spans

NAMES = ("cufhe.gate", "cufhe.key_switch")


def read(reading):
    return spans.idle_pct(reading.trace, NAMES)
