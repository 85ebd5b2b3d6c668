"""rotation_launch_idle_pct.aes: the share of the traced window, in
percent, in which the device was idle in gaps that opened while the host
was in a cufhe.blind_rotate span: the C loop that launches a rotation's
2 x n0 kernels. Moves aes_block_ms."""
from fhebench import spans


def read(reading):
    return spans.idle_pct(reading.trace, ("cufhe.blind_rotate",))
