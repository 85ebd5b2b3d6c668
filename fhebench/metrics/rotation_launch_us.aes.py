"""rotation_launch_us.aes: host microseconds a kernel launch of the blind
rotation's C loop: the cufhe.blind_rotate spans' time in the traced
window over their number x 2 x n0 (each rotation launches the product
and the rotate-and-decompose kernel at each of n0 steps). Moves
aes_block_ms."""
from fhebench import spans


def read(reading):
    got = spans.span_s(reading.trace, "cufhe.blind_rotate")
    if got is None:
        return None
    seconds, rotations = got
    return 1e6 * seconds / (rotations * 2 * reading.params.n0)
