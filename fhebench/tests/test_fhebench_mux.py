"""The MUX cell: a `mux_chain` run is correct on the CPU at tiny shapes,
and comes out not correct with its timed path broken underneath (a MUX
returning its selector, half of the batch left as it came, row 0's answer
negated) or run by the control; the cell's four per-layer metrics on
Traces built by hand, the MUX span's metric reading nothing where the
program records its MUX under cufhe.gate; and, marked `card`, the cell at
its own size."""
import time

import pytest
import torch

from fhebench import harness as H
from fhebench import trace
from fhebench.reference import tfhe as R

MUX = "mux_b4096.cggi19"
METRICS = ("rotation_roofline_pct.mux", "outside_rotation_ms.mux",
           "device_idle_pct.mux", "mux_program_idle_pct.mux")


def _cell(cfg, **mix):
    cell = H.Cell.load(MUX)
    cell.config = cfg
    cell.mix = dict(cell.mix, **mix)
    return cell


def _run(cell, backend="auto", device="cpu", seconds=1e-3, trace=False):
    return H.run_cell(cell, 2 ** 32 + 77, seconds, trace, device,
                      time.perf_counter(), backend)


def _returns_selector(real):
    return lambda c, x1, x0, *a: c.clone()


def _half(real):
    """The first half of the rows muxed, the rest left as they came."""
    def mux(c, x1, x0, *a):
        h = c.shape[0] // 2
        return torch.cat([real(c[:h], x1[:h], x0[:h], *a), c[h:]])
    return mux


def _row0_negated(real):
    """Row 0's answer negated where it is produced (the body's sign bit)."""
    def mux(*args):
        out = real(*args).clone()
        out[0, -1] ^= -(1 << 31)
        return out
    return mux


FAULTS = {"returns_selector": _returns_selector, "half": _half,
          "row0_negated": _row0_negated}


@pytest.mark.parametrize("fault", [None, *FAULTS])
def test_a_broken_mux_is_not_correct(tiny, monkeypatch, fault):
    from cufhe_tpu_torch.ops import bootstrap
    if fault is not None:
        monkeypatch.setattr(bootstrap, "mux_lvl0",
                            FAULTS[fault](bootstrap.mux_lvl0))
    cell = _cell(tiny, batch=48)
    res = _run(cell)
    assert res["correct"] is (fault is None), res["checks"]
    assert set(res["checks"]) == set(cell.limits)
    assert set(res["metrics"]) == {"bootstraps_per_s", "setup_s"}
    if fault is None:
        assert res["failed"] == 0 and res["attempted"] % 48 == 0


def test_mux_control_is_not_correct(pallas_tiny):
    """The program's three-limb key in place of the exact one."""
    res = _run(_cell(pallas_tiny, batch=48), backend="pallas3")
    assert not res["correct"]
    assert res["checks"]["mismatched_words"]["value"] > 0


def test_cell_resolves_to_the_mux_files():
    cell = H.Cell.load(MUX)
    assert cell.mix["kind"] == "mux_chain"
    assert set(cell.per_layer) == set(METRICS)
    assert set(cell.end_to_end) == {"bootstraps_per_s", "setup_s"}
    assert cell.limits == {"mismatched_words": 0, "wrong_bits": 0}
    p = R.Params.from_config(cell.config)
    assert (p.n0, p.N, p.k, p.l, p.Bgbit, p.t, p.basebit) == \
        (630, 1024, 1, 3, 7, 8, 2)
    from cufhe_tpu_torch import params as P
    from cufhe_tpu_torch.ops.blind_rotate import kar_depth
    port = H.port_params(cell.config)
    assert kar_depth(port) == 1
    assert (port.lvl0, port.lvl1, port.ks) == \
        (P.CGGI19.lvl0, P.CGGI19.lvl1, P.CGGI19.ks)


#: one MUX call: step > gate.mux > {blind_rotate x 2, key_switch}
HOST = [("fhebench.step", 0.0, 100.0),
        ("cufhe.gate.mux", 1.0, 90.0),
        ("cufhe.blind_rotate", 5.0, 20.0),
        ("cufhe.blind_rotate", 30.0, 45.0),
        ("cufhe.key_switch", 60.0, 70.0)]
#: gaps open at 4 (in gate.mux, 1 s), 48 (in gate.mux after the second
#: rotation, 2 s), 61 (in key_switch, 3 s) and 95 (no layer's, 5 s)
DEVICE = [("k0", 0.0, 4.0), ("void rotdec_kernel<3, 1, 1>", 5.0, 10.0),
          ("void extprod_kernel<4, 128, 1>", 10.0, 48.0),
          ("k3", 50.0, 61.0), ("k4", 64.0, 95.0)]


def _read(host, device=DEVICE, steps=1):
    cell = H.Cell.load(MUX)
    tr = trace.Trace.from_events((0.0, 100.0), device, host)
    reading = H.Reading(tr, R.Params.from_config(cell.config),
                        {"steps": steps, "rotation_rows": 2 * 4096 * steps})
    return {n: m["value"] for n, m in H.read_per_layer(cell, reading).items()}


def test_mux_metrics_on_a_trace_built_by_hand():
    from fhebench.roofline import rotation_least_s
    got = _read(HOST, steps=2)
    assert set(got) == set(METRICS)
    assert got["mux_program_idle_pct.mux"] == pytest.approx(6.0)
    assert got["device_idle_pct.mux"] == pytest.approx(11.0)
    # the rotation layer ran 5..48 (43 s); the rest 4 + 11 + 31 = 46 s
    assert got["outside_rotation_ms.mux"] == pytest.approx(1e3 * 46.0 / 2)
    cell = H.Cell.load(MUX)
    least, bound = rotation_least_s(R.Params.from_config(cell.config),
                                    2 * 4096 * 2)
    assert bound == "operations"
    assert got["rotation_roofline_pct.mux"] == pytest.approx(
        100.0 * least / 43.0)


def test_mux_span_metric_before_the_span_existed():
    """A program that records its MUX under cufhe.gate reads nothing; a
    window with cufhe.* spans but neither raises; one with no cufhe.* span
    at all reads nothing."""
    older = [(n.replace("cufhe.gate.mux", "cufhe.gate"), s, e)
             for n, s, e in HOST]
    assert "mux_program_idle_pct.mux" not in _read(older)
    assert set(_read(older)) == set(METRICS) - {"mux_program_idle_pct.mux"}
    renamed = [(n.replace("cufhe.gate.mux", "cufhe.mux"), s, e)
               for n, s, e in HOST]
    with pytest.raises(RuntimeError, match="cufhe.gate.mux"):
        _read(renamed)
    bare = [h for h in HOST if not h[0].startswith("cufhe.")]
    assert "mux_program_idle_pct.mux" not in _read(bare)


@pytest.mark.card
def test_mux_cell_on_the_card(cuda):
    """The cell at its own size: a sound run is correct, a traced run reads
    every per-layer metric, each share within (0, 100], and the control is
    not correct."""
    cell = H.Cell.load(MUX)
    res = _run(cell, device=cuda, seconds=1.0)
    assert res["correct"], res["checks"]
    traced = _run(cell, device=cuda, seconds=0.0, trace=True)
    assert traced["correct"], traced["checks"]
    assert set(traced["metrics"]) == set(cell.per_layer)
    for name, m in traced["metrics"].items():
        if m["unit"] == "%":
            assert 0.0 < m["value"] <= 100.0, (name, m)
    assert 0.0 < traced["device"]["busy_s"] <= traced["device"]["window_s"]
    control = _run(cell, backend="pallas3", device=cuda, seconds=1.0)
    assert not control["correct"], control["checks"]
