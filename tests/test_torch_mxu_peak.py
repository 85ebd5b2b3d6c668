"""cufhe_tpu_torch.benchmarks.mxu_peak: the plain version of the probe's
kernel against the JAX probe's pallas_case (benchmarks/mxu_peak.py, its
Pallas kernel in interpret mode on the CPU) at the probe's small shape,
exact as int32."""
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cufhe_tpu_torch.benchmarks import mxu_peak as TM

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jax_probe():
    spec = importlib.util.spec_from_file_location(
        "jax_mxu_peak", REPO / "benchmarks" / "mxu_peak.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("variant", TM.VARIANTS)
def test_ref_matches_jax_pallas_case(variant, jax_probe, monkeypatch):
    monkeypatch.setattr(jax_probe, "SMALL", True)
    name, run, (A, X), macs = jax_probe.pallas_case(
        np.random.default_rng(7), variant)
    want = np.asarray(run(A, X))
    M, K, W, S, steps = TM.SMALL
    assert name == f"pallas-{variant}-w{W}"
    assert macs == float(M) * K * W * S * steps
    # the port's operands from the same generator are the JAX probe's
    tA, tX = TM.make_operands(np.random.default_rng(7), variant, M, K, W, S)
    assert np.array_equal(tA.float().numpy(),
                          np.asarray(A.astype(jnp.float32)))
    assert np.array_equal(tX.float().numpy(),
                          np.asarray(X.astype(jnp.float32)))
    got = TM.mxu_peak_ref(tA, tX, variant, steps)
    assert got.dtype == torch.int32 and tuple(got.shape) == (M, W)
    assert np.array_equal(got.numpy(), want)


def test_ref_semantics():
    """pure/write/bf16 are sum_s A_s X_s; place is steps * ((sum_{s<S-1}
    P_s) << 8 + P_{S-1}) mod 2^32, with the buffer starting at 0."""
    rng = np.random.default_rng(3)
    A, X = TM.make_operands(rng, "pure", 16, 32, 8, 3)
    P = [A[s].long() @ X[s].long() for s in range(3)]
    total = (P[0] + P[1] + P[2]).numpy()
    for v in ("pure", "write"):
        assert np.array_equal(TM.mxu_peak_ref(A, X, v, 2).numpy(), total)
    got = TM.mxu_peak_ref(A.to(torch.bfloat16), X.to(torch.bfloat16),
                          "bf16", 1)
    assert np.array_equal(got.numpy(), total)
    place = (5 * (((P[0] + P[1]) << 8) + P[2])) % (1 << 32)
    got = TM.mxu_peak_ref(A, X, "place", 5).numpy().view(np.uint32)
    assert np.array_equal(got.astype(np.int64), place.numpy())
    assert np.array_equal(TM.prepare_x(X).numpy(),
                          X.numpy().transpose(0, 2, 1))


def test_cuda_wrapper_rejects_cpu_tensors():
    A, X = TM.make_operands(np.random.default_rng(4), "pure", 128, 128, 64, 3)
    with pytest.raises(ValueError, match="CUDA device"):
        TM.mxu_peak_cuda(A, TM.prepare_x(X), "pure", 1)
    with pytest.raises(ValueError, match="variant"):
        TM.mxu_peak_ref(A, X, "nope", 1)
