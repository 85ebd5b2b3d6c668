"""rotation_roofline_pct.mux: the blind rotation's least time on the card
(fhebench.roofline: the rows the traced MUX calls rotated, two a row a
call, at the int8 and memory peaks) over the device time of the
blind-rotation layer's kernels in the traced window, in percent. Moves
bootstraps_per_s.

The count is Karatsuba-2's 9/16 of the schoolbook MACs, the fewest of any
product the program has or plans. The cggi19 set's Bgbit of 7 allows one
level (kar_depth 1, 12/16 of the MACs), so its product at its own count
would read at most 75 % here."""
from fhebench import trace
from fhebench.roofline import rotation_least_s


def read(reading):
    least, _ = rotation_least_s(reading.params,
                                reading.counts["rotation_rows"])
    busy, _ = trace.layer_s(reading.trace, "blind rotation")
    return 100.0 * least / busy
