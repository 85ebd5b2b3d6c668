"""executor_idle_pct.aes: the share of the traced window, in percent, in
which the device was idle in gaps that opened while the host was in the
executor's own time (a cufhe.executor.run, .plan or .step span with no
gate program open inside it). Moves aes_block_ms."""
from fhebench import spans

NAMES = ("cufhe.executor.run", "cufhe.executor.plan", "cufhe.executor.step")


def read(reading):
    return spans.idle_pct(reading.trace, NAMES)
