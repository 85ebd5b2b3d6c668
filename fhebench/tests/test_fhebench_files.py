"""BENCHMARK.json and the files it names: every cell resolves, new files
are picked up by name, the roofline's count, the import rules, and the
run's refusal without a card."""
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from fhebench import harness as H
from fhebench import roofline, trace
from fhebench.reference import tfhe as R

BENCH = H._json(os.path.join(H.ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("workload", CELLS)
def test_cell_resolves(workload):
    cell = H.Cell.load(workload)
    assert os.path.exists(os.path.join(H.HERE, "traffic",
                                       cell.mix["kind"] + ".py"))
    for name in cell.per_layer:
        assert os.path.exists(os.path.join(H.HERE, "metrics", name + ".py"))
    assert "setup_s" in cell.end_to_end and len(cell.end_to_end) >= 2
    assert cell.per_layer
    assert cell.mix["metric"] in cell.end_to_end
    p = R.Params.from_config(cell.config)
    assert R.exact_product_bits(p) < 53
    assert H.port_params(cell.config).n0 == p.n0


def test_benchmark_names_and_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", CELLS)
    for c in BENCH["configs"]:
        cfg = H._json(os.path.join(H.ROOT, c["file"]))
        assert cfg["reduced"] == c["reduced"] == []
        assert len(cfg["source"]) <= 200 and len(c["source"]) <= 200
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_roofline_count_at_tfhepp_128bit():
    cfg = H._json(os.path.join(H.HERE, "configs", "tfhepp_128bit.json"))
    p = R.Params.from_config(cfg)
    least, bound = roofline.rotation_least_s(p, 4096)
    assert bound == "operations"
    assert least == pytest.approx(74.5e-3, abs=0.05e-3)
    schoolbook = roofline.rotation_ops(p, 4096) / roofline.KARATSUBA2
    assert schoolbook / roofline.INT8_OPS_PER_S == pytest.approx(
        132.5e-3, abs=0.05e-3)


def _trace(kernels, window=(0.0, 10.0)):
    return trace.Trace.from_events(window, kernels,
                                   [("host loop", 0.0, 10.0)])


def test_trace_busy_idle_and_layers():
    tr = _trace([("void extprod_kernel<4, 128>", 1.0, 3.0),
                 ("void rotdec_kernel<3, 1>", 2.5, 4.0),
                 ("elementwise", 6.0, 7.0)])
    assert tr.busy_s() == pytest.approx(4.0)
    inside, outside = trace.layer_s(tr, "blind rotation")
    assert (inside, outside) == (pytest.approx(3.5), pytest.approx(1.0))
    assert sum(tr.idle_gaps().values()) == pytest.approx(6.0)
    with pytest.raises(RuntimeError, match="no device operation"):
        trace.check_layers(_trace([("elementwise", 1.0, 2.0)]))


def test_new_metric_and_layer_files_are_picked_up(tmp_path, monkeypatch):
    """A metric or a layer added as a file is read with no edit."""
    for d in ("metrics", "layers", "traffic", "limits"):
        shutil.copytree(os.path.join(H.HERE, d), tmp_path / d)
    (tmp_path / "metrics" / "kernel_count.gates.py").write_text(
        "def read(reading):\n    return float(len(reading.trace.dev_names))\n")
    (tmp_path / "layers" / "key_switch.json").write_text(json.dumps(
        {"layer": "key switch", "patterns": ["gemm"]}))
    monkeypatch.setattr(H, "HERE", str(tmp_path))
    monkeypatch.setattr(trace, "LAYER_DIR", str(tmp_path / "layers"))
    cell = H.Cell.load(CELLS[0])
    cell.per_layer["kernel_count.gates"] = {"unit": "1"}
    tr = _trace([("void extprod_kernel<4, 128>", 1.0, 3.0),
                 ("cutlass_gemm", 4.0, 5.0)])
    trace.check_layers(tr)
    reading = H.Reading(tr, R.Params.from_config(cell.config),
                        {"steps": 1, "rotation_rows": 4096})
    got = H.read_per_layer(cell, reading)
    assert got["kernel_count.gates"]["value"] == 2.0
    assert trace.layer_s(tr, "key switch") == (1.0, 2.0)
    with pytest.raises(RuntimeError, match="key switch"):
        trace.check_layers(_trace([("void extprod_kernel<4, 128>", 1, 2)]))


def test_run_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(H.torch.cuda, "is_available", lambda: False)
    rc = H.main(["--workload", CELLS[0], "--seed", str(2 ** 33 + 1),
                 "--seconds", "1"], 0.0)
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "CUDA" in out.err


def _top_levels(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys\nprint(' '.join(sorted({m.split('.')[0] "
        "for m in sys.modules})))")], cwd=H.ROOT, capture_output=True,
        text=True, check=True).stdout.split()
    return set(out)


def test_imports():
    """What a run loads and what the reference loads, by whole top-level
    names: the program is cufhe_tpu_torch, never the JAX package."""
    run = _top_levels(
        "from fhebench import harness as H\n"
        "import os, glob\n"
        "for f in glob.glob(os.path.join(H.HERE, '*', '*.py')):\n"
        "    if '/tests/' not in f:\n"
        "        H.load_module(f, 'm_' + os.path.basename(f)[:-3]"
        ".replace('.', '_'))\n"
        "import cufhe_tpu_torch.models.api, cufhe_tpu_torch.runtime.bristol\n"
        "import cufhe_tpu_torch.runtime.executor, cufhe_tpu_torch.golden\n")
    assert "cufhe_tpu_torch" in run
    assert not run & {"jax", "jaxlib", "flax", "cufhe_tpu"}
    ref = _top_levels("import fhebench.reference.tfhe, "
                      "fhebench.reference.aes128, fhebench.reference.bristol")
    assert not ref & {"jax", "jaxlib", "flax", "cufhe_tpu", "cufhe_tpu_torch"}


def test_plain_gates_match_the_torus():
    a, b = np.array([0, 0, 1, 1]), np.array([0, 1, 0, 1])
    want = {"nand": [1, 1, 1, 0], "xor": [0, 1, 1, 0], "xnor": [1, 0, 0, 1],
            "andny": [0, 1, 0, 0], "oryn": [1, 0, 1, 1]}
    for name, bits in want.items():
        assert list(R.plain_gate(name, a, b)) == bits
