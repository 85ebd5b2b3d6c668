"""outside_rotation_ms.mux: device milliseconds a MUX call (a batch) of
every operation outside the blind-rotation layer in the traced window: the
two pre-adds and test vectors, the sum of the two accumulators, sample
extraction, the key switch. Moves bootstraps_per_s."""
from fhebench import trace


def read(reading):
    _, outside = trace.layer_s(reading.trace, "blind rotation")
    return 1e3 * outside / reading.counts["steps"]
