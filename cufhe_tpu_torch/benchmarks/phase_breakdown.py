"""Phase breakdown of one lvl0 NAND bootstrap at tfhepp_128bit, the
counterpart of benchmarks/phase_breakdown.py: the full gate, the blind
rotation alone (pre-add, mod switch and test vector, the CUDA kernel), and
sample extraction and key switch alone, each at the same batch as a median
of CUDA-event times (utils.timing.time_fn). null_ms times a call that returns its input:
the resolution floor.

    python -m cufhe_tpu_torch.benchmarks.phase_breakdown [batch] [backend]
                                                  # 4096, auto

Keys come from the bench key cache; the backend's key form is prepared
(pallas3: the three-limb key). Prints one JSON line with the card's
name and power limit; exits 2 without a CUDA device. The phase functions
compose to ops.bootstrap.gate_lvl0 (the tests hold them to it on the CPU).
"""
from __future__ import annotations

import json
import sys

import numpy as np

from ..golden import GATE_CONSTANTS
from ..ops.bootstrap import (_gate_coeffs, _pre_add, blind_rotate,
                             gate_lvl0)
from ..ops.keyswitch import key_switch
from ..ops.poly import sample_extract_for_ks
from ..torus import from_u32

#: CUDA-event timings per phase (the median is reported)
ITERS = 5


def null(a, b, keys, params):
    return a


def full_nand(a, b, keys, params, backend="auto"):
    return gate_lvl0(GATE_CONSTANTS["nand"], a, b, keys, params, backend)


def blind_rotate_only(a, b, keys, params, backend="auto"):
    """Pre-add, mod switch and test vector, blind rotation: the TRLWE
    accumulator [B, k+1, N]."""
    ca, cb, off = _gate_coeffs(GATE_CONSTANTS["nand"], params.lvl0.mu)
    aa, bb = _pre_add(a, b, ca, cb, off, params.lvl0.dim)
    return blind_rotate(aa, bb, params.lvl1.mu, keys, params, backend)


def extract_ks_only(acc, keys, params):
    """Sample extraction in key-switch form and the key switch to lvl0."""
    return key_switch(sample_extract_for_ks(acc, params.lvl1),
                      keys.ksk_tiles, params)


def random_inputs(params, batch: int, device, seed: int = 3):
    """Two batches of random lvl0 ciphertexts [batch, n0+1] int32."""
    rng = np.random.default_rng(seed)
    n0 = params.lvl0.dim
    return tuple(from_u32(rng.integers(0, 1 << 32, (batch, n0 + 1),
                                       dtype=np.uint64).astype(np.uint32),
                          device) for _ in range(2))


def breakdown(keys, params, batch: int, device="cuda",
              backend: str = "auto") -> dict:
    """The phase times in ms at `batch` rows, keys on `device` in the
    backend's form."""
    from ..utils.timing import time_fn
    a, b = random_inputs(params, batch, device)
    acc = blind_rotate_only(a, b, keys, params, backend)

    def ms(fn, *args):
        return time_fn(fn, *args, iters=ITERS, device=device) * 1e3

    return {
        "batch": batch,
        "null_ms": ms(null, a, b, keys, params),
        "full_nand_ms": ms(full_nand, a, b, keys, params, backend),
        "blind_rotate_ms": ms(blind_rotate_only, a, b, keys, params,
                              backend),
        "extract_ks_ms": ms(extract_ks_only, acc, keys, params),
    }


def main() -> int:
    from ..ops.bootstrap import resolve_backend
    from ..ops.keys import prepare_keys
    from ..params import TFHEPP_128
    from ._common import (device_record, load_or_make_bench_keys,
                          require_cuda)
    require_cuda()
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    backend = sys.argv[2] if len(sys.argv) > 2 else "auto"
    _, ek = load_or_make_bench_keys(TFHEPP_128.name)
    keys = prepare_keys(ek, "cuda", (resolve_backend(backend),))
    rec = breakdown(keys, TFHEPP_128, batch, backend=backend)
    print(json.dumps({**rec, "params": TFHEPP_128.name, "backend": backend,
                      "device": device_record()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
