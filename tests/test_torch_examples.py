"""The port's examples (cufhe_tpu_torch/examples/), run as a user runs
them: each with --cpu prints its JAX twin's success line
(tests/test_examples.py); without --cpu each needs the card and stops
without one."""
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from test_examples import EXAMPLES

EXAMPLE_DIR = (pathlib.Path(__file__).resolve().parent.parent
               / "cufhe_tpu_torch" / "examples")


def _run(script, *args):
    # one intra-op thread a process: the suite runs several workers on the
    # same cores
    env = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
           "OMP_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, str(EXAMPLE_DIR / script), *args],
                          capture_output=True, text=True, timeout=600,
                          env=env, cwd=EXAMPLE_DIR)


def test_every_jax_example_has_a_port():
    assert sorted(p.name for p in EXAMPLE_DIR.glob("*.py")) == \
        sorted(script for script, _ in EXAMPLES)


@pytest.mark.parametrize("script,expect", EXAMPLES,
                         ids=[e[0] for e in EXAMPLES])
def test_example_runs_on_the_cpu(script, expect):
    proc = _run(script, "--cpu")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert expect in proc.stdout, proc.stdout[-2000:]


@pytest.mark.parametrize("script", [e[0] for e in EXAMPLES])
def test_example_needs_the_card_by_default(script):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the example would run on it")
    proc = _run(script)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr, proc.stderr[-2000:]
