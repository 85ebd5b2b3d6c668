"""outside_rotation_ms.gates: device milliseconds a gate call (a batch) of
every operation outside the blind-rotation layer in the traced window:
pre-add, test vector, sample extraction, key switch. Moves
bootstraps_per_s."""
from fhebench import trace


def read(reading):
    _, outside = trace.layer_s(reading.trace, "blind rotation")
    return 1e3 * outside / reading.counts["steps"]
