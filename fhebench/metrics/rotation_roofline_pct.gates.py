"""rotation_roofline_pct.gates: the blind rotation's least time on the card
(fhebench.roofline: the rows the traced steps rotated, at the int8 and
memory peaks) over the device time of the blind-rotation layer's kernels
in the traced window, in percent. Moves bootstraps_per_s."""
from fhebench import trace
from fhebench.roofline import rotation_least_s


def read(reading):
    least, _ = rotation_least_s(reading.params,
                                reading.counts["rotation_rows"])
    busy, _ = trace.layer_s(reading.trace, "blind rotation")
    return 100.0 * least / busy
