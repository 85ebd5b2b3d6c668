"""cufhe_tpu_torch never imports JAX or the JAX package cufhe_tpu, and
chip_smoke.py refuses to run without a CUDA device. conftest.py imports JAX
into this process, so the import checks run in their own interpreter."""
import ast
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "cufhe_tpu_torch"

_PROBE = """
import sys
import numpy as np
import cufhe_tpu_torch as T
from cufhe_tpu_torch import golden as G
sk = G.keygen(T.TINY, seed=3)
ek = G.make_eval_key(sk, seed=4)
rng = np.random.default_rng(5)
from cufhe_tpu_torch.parallel import data_mesh
ctx = T.Context(ek, device="cpu")
a = T.encrypt_bits([0, 1, 0, 1], sk, rng, device="cpu")
b = T.encrypt_bits([0, 0, 1, 1], sk, rng, device="cpu")
out = ctx.nand(a, b)
ntt_mesh = T.Context(ek, "ntt", mesh=data_mesh(["cpu"] * 2))
print(T.decrypt_bits(out, sk).tolist(),
      T.decrypt_bits(ntt_mesh.nand(a, b), sk).tolist(), "jax" in sys.modules,
      "cufhe_tpu" in sys.modules)
"""


def _clean_env():
    return {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}


def test_port_runs_a_gate_without_jax():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env=_clean_env())
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split("\n")[-2] == \
        "[1, 1, 1, 0] [1, 1, 1, 0] False False"


def test_no_jax_import_in_port_sources():
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for new in ("parallel/mesh.py", "parallel/__init__.py", "ops/ntt.py",
                "benchmarks/_common.py", "benchmarks/suite.py",
                "benchmarks/golden_check.py", "benchmarks/phase_breakdown.py",
                *(f"examples/{name}" for name in (
                    "01_gates.py", "02_adder_and_netlists.py",
                    "03_server_client_split.py", "04_encrypted_processor.py",
                    "05_encrypted_lookup.py", "06_encrypted_integers.py"))):
        assert PKG / new in files, new
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in ("jax", "cufhe_tpu"), \
                    f"{path}: imports {m}"


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "alone"])
def test_chip_smoke_fails_without_cuda(alone, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    script = REPO / "chip_smoke.py"
    if alone:
        script = pathlib.Path(shutil.copy(script, tmp_path / script.name))
    proc = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                          capture_output=True, text=True, timeout=300,
                          env=_clean_env())
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        assert "ok" not in rec and "kernels" not in rec


def test_version_is_the_jax_packages():
    """F12: the port names its version as the JAX package does."""
    import cufhe_tpu
    import cufhe_tpu_torch
    assert cufhe_tpu_torch.__version__ == cufhe_tpu.__version__ == "0.1.0"


def test_timing_block_returns_its_input(monkeypatch):
    """F12: utils.timing.block, the counterpart of cufhe_tpu's, returns
    what it is given, tensors nested in lists, tuples, dicts and Ctxt
    holders included, and synchronises no device for CPU tensors."""
    import cufhe_tpu.utils.timing as JT
    from cufhe_tpu_torch import Ctxt
    from cufhe_tpu_torch.utils import timing as TT

    def no_sync(*args):
        raise AssertionError("a CPU tensor needs no synchronise")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    x = torch.arange(4, dtype=torch.int32)
    tree = {"a": [x, (x + 1,)], "b": Ctxt(x.reshape(2, 2), 0)}
    assert TT.block(x) is x
    assert TT.block(tree) is tree
    assert TT.block(None) is None
    assert hasattr(JT, "block") and callable(TT.block)
