"""Quickstart: encrypt bits, evaluate gates homomorphically, decrypt.

The counterpart of examples/01_gates.py on PyTorch. The flow is the
reference's (keygen -> Initialize(ek) -> gates -> decrypt, cuFHE README.md
"Usage"): ciphertexts are batches (the batch axis is the parallelism), and
they stay on the card between gates.

Run:  python cufhe_tpu_torch/examples/01_gates.py          # TINY, the card
      python cufhe_tpu_torch/examples/01_gates.py --full   # tfhepp_128bit
      python cufhe_tpu_torch/examples/01_gates.py --cpu    # on the CPU
"""
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from cufhe_tpu_torch import TFHEPP_128, TINY, golden as G  # noqa: E402
from cufhe_tpu_torch import Context, decrypt_bits, encrypt_bits  # noqa: E402

DEVICE = "cpu" if "--cpu" in sys.argv else "cuda"
if DEVICE == "cuda" and not torch.cuda.is_available():
    sys.exit("no CUDA device: run on the card, or pass --cpu")
params = TFHEPP_128 if "--full" in sys.argv else TINY
rng = np.random.default_rng(42)

# --- client side: secret key + evaluation key -----------------------------
t0 = time.time()
sk = G.keygen(params, seed=1)          # secret key (client keeps this)
ek = G.make_eval_key(sk, seed=2)       # evaluation key (server gets this)
print(f"keygen: {time.time() - t0:.1f}s ({params.name})")

# --- server side: one-time context setup (Initialize(ek) analogue) --------
ctx = Context(ek, device=DEVICE)       # keys converted and moved once

# --- encrypt a batch of bits ----------------------------------------------
batch = 64
bits_a = rng.integers(0, 2, batch)
bits_b = rng.integers(0, 2, batch)
ct_a = encrypt_bits(bits_a, sk, rng, device=DEVICE)
ct_b = encrypt_bits(bits_b, sk, rng, device=DEVICE)

# --- homomorphic evaluation (server never sees plaintext) -----------------
t0 = time.time()
ct_nand = ctx.nand(ct_a, ct_b)
ct_xor = ctx.gate("xor", ct_a, ct_b)
ct_chain = ctx.nand(ct_nand, ct_xor)      # gates chain on the device
if DEVICE == "cuda":
    torch.cuda.synchronize()
print(f"3 batched gates ({3 * batch} bootstraps) on {DEVICE}: "
      f"{time.time() - t0:.1f}s")

# --- decrypt and verify ----------------------------------------------------
want_nand = 1 - (bits_a & bits_b)
want_xor = bits_a ^ bits_b
want_chain = 1 - (want_nand & want_xor)
assert np.array_equal(decrypt_bits(ct_nand, sk), want_nand)
assert np.array_equal(decrypt_bits(ct_xor, sk), want_xor)
assert np.array_equal(decrypt_bits(ct_chain, sk), want_chain)
print(f"all {3 * batch} decryptions correct")
