"""Set-up shared by the benches: the bench key cache, the results file and
the card's record (name and power limit, as nvidia-smi reports them).
The counterpart of benchmarks/_keys.py; there is no compile cache."""
from __future__ import annotations

import json
import os
import sys

import torch

#: where the key cache lives: the repo root, as the JAX benches keep it, so
#: one cache serves both packages (utils.serialization writes their format)
KEY_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: one JSON record per line, appended by append_result
RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "results.jsonl")
#: the H100 SXM's dense int8 tensor-core rate (ops/s, a MAC is two) and its
#: device-memory rate (bytes/s), NVIDIA's data sheet: the bounds the benches
#: and chip_smoke.py hold kernel times against
INT8_OPS_PER_S = 1979e12
HBM_BYTES_PER_S = 3.35e12


def key_cache_paths(pname: str) -> tuple:
    """(eval key file, secret key file) of a preset in KEY_DIR: the JAX
    cache's names (.bench_keys_128.npz for tfhepp_128bit)."""
    tag = "128" if pname == "tfhepp_128bit" else pname
    return (os.path.join(KEY_DIR, f".bench_keys_{tag}.npz"),
            os.path.join(KEY_DIR, f".bench_sk_{tag}.npz"))


def load_or_make_bench_keys(pname: str):
    """(sk, ek) of a preset from the key cache; generated from seeds 0 and
    1 and saved when a file is missing or was written under other
    parameter values (its fingerprint differs)."""
    from .. import golden as G
    from ..params import PRESETS
    from ..utils import serialization as S
    cache, sk_cache = key_cache_paths(pname)
    if os.path.exists(cache) and os.path.exists(sk_cache):
        try:
            return S.load_secret_key(sk_cache), S.load_eval_key(cache)
        except ValueError as e:        # fingerprint mismatch: regenerate
            print(f"stale key cache ({e}); regenerating", file=sys.stderr)
    print(f"generating {pname} keys...", file=sys.stderr)
    sk = G.keygen(PRESETS[pname], seed=0)
    ek = G.make_eval_key(sk, seed=1)
    S.save_eval_key(cache, ek)
    S.save_secret_key(sk_cache, sk)
    return sk, ek


def append_result(rec: dict) -> None:
    """Append one record to RESULTS as a JSON line."""
    with open(RESULTS, "a") as f:
        f.write(json.dumps(rec) + "\n")


def require_cuda() -> None:
    if not torch.cuda.is_available():
        print("no CUDA device: the bench measures the GPU only",
              file=sys.stderr)
        raise SystemExit(2)


def device_record() -> dict:
    from ..bench import card
    return {"name": torch.cuda.get_device_name(0),
            "power_limit": card()["power_limit"]}
