"""device_idle_pct.mux: the share of the traced window in which no
operation runs on the device, 100 (1 - the union of their intervals / the
window), in percent. Moves bootstraps_per_s."""


def read(reading):
    return 100.0 * (1.0 - reading.trace.busy_s() / reading.trace.window_s)
