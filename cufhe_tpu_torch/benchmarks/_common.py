"""Set-up shared by the circuit benches: keys from a seed and the card's
record (name and power limit, as nvidia-smi reports them)."""
from __future__ import annotations

import sys

import torch


def bench_keys(pname: str):
    """(params, sk, ek) of a preset, generated from fixed seeds (the
    client side; seconds at the 128-bit sets)."""
    from .. import golden as G
    from ..params import PRESETS
    params = PRESETS[pname]
    sk = G.keygen(params, seed=0)
    return params, sk, G.make_eval_key(sk, seed=1)


def require_cuda() -> None:
    if not torch.cuda.is_available():
        print("no CUDA device: the bench measures the GPU only",
              file=sys.stderr)
        raise SystemExit(2)


def device_record() -> dict:
    from ..bench import card
    return {"name": torch.cuda.get_device_name(0),
            "power_limit": card()["power_limit"]}
