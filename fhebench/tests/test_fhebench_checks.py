"""The comparison that decides `correct`: a run of each kind of traffic
with the timed path broken underneath comes out not correct, and so does
the program's reduced-precision path (the control). On the CPU the runs
skip the look for a card and use tiny shapes; the tests marked `card` run
each cell of BENCHMARK.json at its own size."""
import time

import pytest
import torch

from fhebench import harness as H

NAND = "nand_b4096.tfhepp_128bit"
AES = "aes128_b1.tfhepp_128bit"


def _cell(workload, cfg, **mix):
    cell = H.Cell.load(workload)
    cell.config = cfg
    cell.mix = dict(cell.mix, **mix)
    return cell


def _run(cell, backend="auto", device="cpu", seconds=1e-3, trace=False):
    return H.run_cell(cell, 2 ** 32 + 99, seconds, trace, device,
                      time.perf_counter(), backend)


def _unchanged(real):
    return lambda c, x, y, *a: x.clone()


def _half(real):
    """The first half of the rows computed, the rest left as they came."""
    def gate(c, x, y, *a):
        h = x.shape[0] // 2
        if h == 0:
            return x.clone()
        c_h = c[:h] if isinstance(c, torch.Tensor) else c
        return torch.cat([real(c_h, x[:h], y[:h], *a), x[h:]])
    return gate


def _altered(real):
    """Row 0's answer negated where it is produced (the body's sign bit)."""
    def gate(*args):
        out = real(*args).clone()
        out[0, -1] ^= -(1 << 31)
        return out
    return gate


FAULTS = {"unchanged": _unchanged, "half": _half, "altered": _altered}


@pytest.mark.parametrize("fault", [None, *FAULTS])
@pytest.mark.parametrize("workload,mix", [(NAND, {"batch": 64}), (AES, {})])
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, workload,
                                            mix, fault):
    from cufhe_tpu_torch.ops import bootstrap
    if fault is not None:
        monkeypatch.setattr(bootstrap, "gate_lvl0",
                            FAULTS[fault](bootstrap.gate_lvl0))
    cell = _cell(workload, tiny, **mix)
    res = _run(cell)
    assert res["correct"] is (fault is None), res["checks"]
    assert set(res["checks"]) == set(cell.limits)


def test_control_is_not_correct(pallas_tiny):
    """The program's three-limb key in place of the exact one."""
    res = _run(_cell(NAND, pallas_tiny, batch=64), backend="pallas3")
    assert not res["correct"]
    assert res["checks"]["mismatched_words"]["value"] > 0


@pytest.mark.card
@pytest.mark.parametrize("workload", [NAND, "nand_b4096.concrete", AES])
def test_cell_on_the_card(cuda, workload):
    """Each cell at its own size: a sound run is correct, a traced run
    reads every per-layer metric within its bounds, the control is not
    correct."""
    cell = H.Cell.load(workload)
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
