"""Fixtures of the benchmark's tests: tiny parameter sets that the CPU
runs in milliseconds, and the card, decided inside a fixture.

Run them with `python -m pytest fhebench/tests -q` from the root of the
repository; tests that need the card (marked `card`) skip without one.
"""
import copy

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


def config(n0, N, k, l, Bgbit, t, basebit=2, alpha0=2 ** -20,
           alpha1=2 ** -30):
    return {"name": f"tiny-{n0}-{N}-{k}",
            "lvl0": {"n": n0, "k": 1, "alpha": alpha0, "mu": 1 << 29},
            "lvl1": {"N": N, "k": k, "l": l, "Bgbit": Bgbit, "alpha": alpha1,
                     "mu": 1 << 29},
            "keyswitch": {"t": t, "basebit": basebit}}


#: the shapes of the program's TINY, TINY_K2 and PALLAS_TINY sets (N = 128
#: is the least its reduced-precision path takes), with noise
TINY = config(16, 64, 1, 2, 6, 4)
TINY_K2 = config(12, 32, 2, 2, 6, 4)
PALLAS_TINY = config(8, 128, 1, 2, 6, 4)


@pytest.fixture
def tiny():
    return copy.deepcopy(TINY)


@pytest.fixture(params=["TINY", "TINY_K2"])
def tiny_set(request):
    """Each tiny shape: k = 1 and k = 2."""
    return copy.deepcopy({"TINY": TINY, "TINY_K2": TINY_K2}[request.param])


@pytest.fixture
def pallas_tiny():
    return copy.deepcopy(PALLAS_TINY)


@pytest.fixture
def cuda():
    """The card, or a skip: decided here and never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: this checks the card's run")
    return torch.device("cuda")
