"""executor_plan_ms.aes: host milliseconds a call of the traced window
(one AES-128 block) spent in the program's cufhe.executor.plan spans:
laying out the schedule for the call (slot map, step plan, index tensors
uploaded). Moves aes_block_ms."""
from fhebench import spans


def read(reading):
    got = spans.span_s(reading.trace, "cufhe.executor.plan")
    if got is None:
        return None
    return 1e3 * got[0] / reading.counts["steps"]
