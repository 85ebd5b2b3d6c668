"""fhebench/spans.py and the five metrics that read the program's cufhe.*
spans, on Traces built by hand: each idle gap goes to the innermost span
open when it opened (a parent's own time after its child closed is the
parent's), a window with no cufhe.* span reads nothing, and one that lacks
a span a metric names raises."""
import pytest

from fhebench import harness as H
from fhebench import spans, trace
from fhebench.reference import tfhe as R

CELL = "aes128_b1.tfhepp_128bit"
METRICS = ("executor_plan_ms.aes", "executor_idle_pct.aes",
           "gate_program_idle_pct.aes", "rotation_launch_idle_pct.aes",
           "rotation_launch_us.aes")

#: one call: run > plan, run > step > gate > {blind_rotate, key_switch};
#: the launches of the C loop and the benchmark's own span beside them
HOST = [("fhebench.step", 0.0, 100.0),
        ("cufhe.executor.run", 1.0, 99.0),
        ("cufhe.executor.plan", 2.0, 10.0),
        ("cufhe.executor.step", 12.0, 50.0),
        ("cufhe.gate", 13.0, 49.0),
        ("cufhe.blind_rotate", 15.0, 25.0),
        ("cudaLaunchKernel", 16.0, 16.5),
        ("cufhe.key_switch", 30.0, 35.0),
        ("cudaStreamSynchronize", 99.0, 100.0)]
#: device operations whose gaps open at 3 (in plan, 8 s), 16 (in
#: blind_rotate, 4 s), 31 (in key_switch, 2 s), 40 (in the gate's own time
#: after key_switch closed, 5 s), 50 (as step closes: in run, 10 s) and
#: 99.5 (after run closed: no layer's, 0.5 s)
DEVICE = [("k1", 0.0, 3.0), ("void rotdec_kernel<3, 1>", 11.0, 16.0),
          ("void extprod_kernel<4, 128>", 20.0, 31.0), ("k4", 33.0, 40.0),
          ("k5", 45.0, 50.0), ("k6", 60.0, 99.5)]


def _trace(host=HOST, device=DEVICE):
    return trace.Trace.from_events((0.0, 100.0), device, host)


def _read(tr, steps=1):
    cell = H.Cell.load(CELL)
    reading = H.Reading(tr, R.Params.from_config(cell.config),
                        {"steps": steps, "rotation_rows": 45760})
    return {n: m["value"] for n, m in H.read_per_layer(cell, reading).items()
            if n in METRICS}


def test_cell_reads_the_five_span_metrics():
    cell = H.Cell.load(CELL)
    assert set(METRICS) <= set(cell.per_layer)
    for name in METRICS:
        assert cell.per_layer[name]["moves"] == "aes_block_ms"


def test_gaps_go_to_the_innermost_open_span():
    idle = spans.Spans(_trace()).idle_s()
    assert idle == {"cufhe.executor.run": pytest.approx(10.0),
                    "cufhe.executor.plan": pytest.approx(8.0),
                    "cufhe.executor.step": 0.0,
                    "cufhe.gate": pytest.approx(5.0),
                    "cufhe.blind_rotate": pytest.approx(4.0),
                    "cufhe.key_switch": pytest.approx(2.0)}
    assert sum(_trace().idle_gaps().values()) == pytest.approx(29.5)


def test_a_gap_in_a_parents_own_time_is_the_parents():
    """The device runs dry at 26, after blind_rotate (15-25) closed inside
    its gate: the gate's, not the rotation's; at 12.5, inside step before
    its gate opens: the step's."""
    dev = [("k", 0.0, 12.5), ("k", 14.0, 26.0), ("k", 28.0, 100.0)]
    idle = spans.Spans(_trace(device=dev)).idle_s()
    assert idle["cufhe.executor.step"] == pytest.approx(1.5)
    assert idle["cufhe.gate"] == pytest.approx(2.0)
    assert idle["cufhe.blind_rotate"] == 0.0


def test_a_child_that_starts_with_its_parent_takes_the_gap():
    host = [("cufhe.gate", 10.0, 20.0), ("cufhe.blind_rotate", 10.0, 15.0)]
    dev = [("k", 0.0, 10.0), ("k", 12.0, 100.0)]
    idle = spans.Spans(_trace(host=host, device=dev)).idle_s()
    assert idle == {"cufhe.gate": 0.0,
                    "cufhe.blind_rotate": pytest.approx(2.0)}


def test_the_five_metrics():
    got = _read(_trace())
    n0 = R.Params.from_config(H.Cell.load(CELL).config).n0
    assert got == {"executor_plan_ms.aes": pytest.approx(8000.0),
                   "executor_idle_pct.aes": pytest.approx(18.0),
                   "gate_program_idle_pct.aes": pytest.approx(7.0),
                   "rotation_launch_idle_pct.aes": pytest.approx(4.0),
                   "rotation_launch_us.aes": pytest.approx(
                       1e6 * 10.0 / (2 * n0))}
    device_idle = 100.0 * (1 - _trace().busy_s() / 100.0)
    assert device_idle == pytest.approx(29.5)
    assert got["executor_idle_pct.aes"] + got["gate_program_idle_pct.aes"] \
        + got["rotation_launch_idle_pct.aes"] <= device_idle


def test_the_metrics_are_per_call_and_per_launch():
    """Two calls' spans: the plan's ms are per call, the launch's us per
    launch of every rotation."""
    host = HOST + [(n, s + 100.0, e + 100.0) for n, s, e in HOST
                   if n.startswith("cufhe.")]
    host.append(("cufhe.blind_rotate", 180.0, 200.0))
    tr = trace.Trace.from_events((0.0, 200.0), DEVICE, host)
    got = _read(tr, steps=2)
    n0 = R.Params.from_config(H.Cell.load(CELL).config).n0
    assert got["executor_plan_ms.aes"] == pytest.approx(8000.0)
    assert got["rotation_launch_us.aes"] == pytest.approx(
        1e6 * 40.0 / (3 * 2 * n0))


def test_a_program_without_spans_reads_nothing():
    """The window of a program that records no cufhe.* span: every metric
    returns None and the result line leaves it out."""
    host = [(n, s, e) for n, s, e in HOST if not n.startswith("cufhe.")]
    assert _read(_trace(host=host)) == {}


@pytest.mark.parametrize("missing, metric", [
    ("cufhe.executor.plan", "executor_plan_ms.aes"),
    ("cufhe.executor.plan", "executor_idle_pct.aes"),
    ("cufhe.key_switch", "gate_program_idle_pct.aes"),
    ("cufhe.blind_rotate", "rotation_launch_idle_pct.aes"),
    ("cufhe.blind_rotate", "rotation_launch_us.aes")])
def test_a_missing_span_raises(missing, metric):
    """A span renamed in the program must not read as 0."""
    host = [(n + "_renamed" if n == missing else n, s, e)
            for n, s, e in HOST]
    mod = H.load_module(f"{H.HERE}/metrics/{metric}.py",
                        "fhebench.metrics." + metric.replace(".", "_"))
    cell = H.Cell.load(CELL)
    reading = H.Reading(_trace(host=host), R.Params.from_config(cell.config),
                        {"steps": 1, "rotation_rows": 45760})
    with pytest.raises(RuntimeError, match=missing):
        mod.read(reading)
