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
    tA, tX = TM.make_operands(np.random.default_rng(7), variant, M, K, W, S,
                              device="cpu")
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
    A, X = TM.make_operands(rng, "pure", 16, 32, 8, 3, device="cpu")
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


@pytest.mark.parametrize("instruction", TM.INSTRUCTIONS)
def test_cuda_wrapper_rejects_cpu_tensors(instruction):
    A, X = TM.make_operands(np.random.default_rng(4), "pure", 128, 128, 128,
                            3, device="cpu")
    before = dict(TM.mxu_peak_cuda.by_instruction)
    with pytest.raises(ValueError, match="CUDA device"):
        TM.mxu_peak_cuda(A, TM.prepare_x(X), "pure", 1, instruction)
    with pytest.raises(ValueError, match="instruction"):
        TM.mxu_peak_cuda(A, TM.prepare_x(X), "pure", 1, "mma")
    with pytest.raises(ValueError, match="variant"):
        TM.mxu_peak_ref(A, X, "nope", 1)
    assert TM.mxu_peak_cuda.by_instruction == before


W1024 = (2048, 1536, 1024, 9, 32)
PLAN_SHAPES = {"small": TM.SMALL, "w512": TM.FULL, "w1024": W1024,
               "k1step": TM.K1_STEP}


@pytest.mark.parametrize("variant", TM.VARIANTS)
@pytest.mark.parametrize("shape", PLAN_SHAPES.values(), ids=PLAN_SHAPES)
def test_wgmma_plan_covers_every_slice_once(variant, shape):
    """Every output tile is summed over each (s, k-slice) pair of a step by
    exactly one block of its split, and the grid covers the output."""
    M, K, W, S, _ = shape
    plan = TM.wgmma_plan(variant, M, K, W, S)
    kb = K * (2 if variant == "bf16" else 1)
    KT = kb // 128
    assert plan["slices"] == S * KT
    ranges = TM.split_ranges(plan["slices"], plan["split"])
    pairs = [(j // KT, j % KT) for lo, hi in ranges for j in range(lo, hi)]
    assert sorted(pairs) == [(s, kt) for s in range(S) for kt in range(KT)]
    assert all(hi > lo for lo, hi in ranges)
    gx, gy, gz = plan["grid"]
    assert (gx * plan["bm"], gy * plan["bn"], gz) == (M, W, plan["split"])
    assert plan["bm"] >= 128 and plan["bn"] >= 128
    assert plan["bn"] == (128 if variant == "place" or W % 256 else 256)


@pytest.mark.parametrize("name", ["w512", "k1step", "w1024"])
def test_wgmma_plan_fills_the_card(name):
    """At least 128 blocks at the probe's main shapes, and no more than one
    wave where a split is needed to get there."""
    M, K, W, S, _ = PLAN_SHAPES[name]
    for v in TM.VARIANTS:
        plan = TM.wgmma_plan(v, M, K, W, S)
        blocks = plan["grid"][0] * plan["grid"][1] * plan["grid"][2]
        assert blocks >= 128, (v, plan)
        if plan["split"] > 1:
            assert blocks <= TM.SMS
    assert TM.wgmma_plan("pure", *TM.FULL[:4])["split"] == 4


def test_wgmma_moves_fewer_bytes_into_shared_memory():
    """The 128 x 256 tile halves the L2-to-shared-memory bytes of the
    128 x 64 one: 21.7 GB -> 10.9 GB per pure-w512 launch."""
    old = TM.smem_bytes("mma_sync", "pure", *TM.FULL)
    new = TM.smem_bytes("wgmma", "pure", *TM.FULL)
    assert old == 128 * 32 * 216 * 192 * 128
    assert round(old / 1e9, 1) == 21.7 and round(new / 1e9, 1) == 10.9
    assert 2 * TM.smem_bytes("wgmma", "pure", *TM.K1_STEP) == \
        TM.smem_bytes("mma_sync", "pure", *TM.K1_STEP)
