"""Encrypted arithmetic two ways: composed gate circuits and compiled
Bristol netlists through the native scheduler.

The counterpart of examples/02_adder_and_netlists.py on PyTorch.

Way 1: `models.circuits`, host-side composition of batched gate calls (the
reference's intended kvsp use, chaining gates on streams).

Way 2: `runtime`, a netlist levelized by the C++ scheduler and executed a
level at a time: all ten two-input gate types of a level run as one
batched call through per-row gate constants.

Run:  python cufhe_tpu_torch/examples/02_adder_and_netlists.py   # the card
      python cufhe_tpu_torch/examples/02_adder_and_netlists.py --cpu
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from cufhe_tpu_torch import TINY, golden as G  # noqa: E402
from cufhe_tpu_torch.models import (Context, circuits, decrypt_bits,  # noqa: E402
                                    encrypt_bits)

DEVICE = "cpu" if "--cpu" in sys.argv else "cuda"
if DEVICE == "cuda" and not torch.cuda.is_available():
    sys.exit("no CUDA device: run on the card, or pass --cpu")
rng = np.random.default_rng(7)
sk = G.keygen(TINY, seed=1)
ek = G.make_eval_key(sk, seed=2)
ctx = Context(ek, device=DEVICE)

# --- Way 1: 8-bit ripple-carry adder over a batch of words ----------------
batch, nbits = 16, 8
a_vals = rng.integers(0, 256, batch)
b_vals = rng.integers(0, 256, batch)


def bit(v, i):
    return (v >> i) & 1


def enc_word(v):
    return [encrypt_bits(bit(v, i), sk, rng, device=DEVICE)
            for i in range(nbits)]


a_word, b_word = enc_word(a_vals), enc_word(b_vals)
zero = encrypt_bits(np.zeros(batch, dtype=int), sk, rng, device=DEVICE)

sum_bits, carry = circuits.ripple_carry_add(ctx, a_word, b_word, zero)
got = sum(decrypt_bits(s, sk).astype(int) << i
          for i, s in enumerate(sum_bits))
got += decrypt_bits(carry, sk).astype(int) << nbits
assert np.array_equal(got, a_vals + b_vals), (got, a_vals + b_vals)
print(f"circuits.ripple_carry_add: {batch} encrypted 8-bit additions OK")

# --- Way 2: the same adder as a netlist through the native scheduler ------
# (any circuit imports the same way from Bristol Fashion text through
#  runtime.load_bristol/compile_bristol; benchmarks/aes.py runs a full
#  AES-128 through this path)
from cufhe_tpu_torch.runtime import build_ripple_adder, run_schedule  # noqa: E402

cb, wires = build_ripple_adder(nbits)       # C++ graph builder
sched = cb.compile()                        # levelize + DCE + schedule
ins = [*a_word, *b_word, zero]              # a bits, b bits, carry-in
outs = run_schedule(ctx, sched, ins)        # one batched call per level
got2 = sum(decrypt_bits(s, sk).astype(int) << i for i, s in enumerate(outs))
assert np.array_equal(got2, a_vals + b_vals)
print(f"runtime scheduler netlist: {batch} additions OK "
      f"({sched.num_levels} levels)")

# --- Way 2b: a real workload netlist (SHA-256), plaintext-simulated -------
# The same importer and scheduler run the generated AES-128 and SHA-256;
# the encrypted runs are benchmarks/aes.py and benchmarks/sha256.py. Here
# the scheduled SHA-256 circuit runs on plaintext bits (the executor's
# oracle mode), which shows the netlist tooling end to end in seconds.
import hashlib  # noqa: E402

from cufhe_tpu_torch.runtime import netlists as NL  # noqa: E402
from cufhe_tpu_torch.runtime.bristol import compile_bristol  # noqa: E402
from cufhe_tpu_torch.runtime.executor import simulate_schedule  # noqa: E402

sha_sched, _ = compile_bristol(NL.sha256_block_bristol())
msg = b"hello, homomorphic world"
in_bits = [np.array([b]) for b in NL.bits_of(NL.sha256_pad(msg))]
digest = NL.bytes_of(np.concatenate(simulate_schedule(sha_sched, in_bits)))
assert digest == hashlib.sha256(msg).digest()
print(f"sha256 netlist: {sha_sched.num_gates} gates, digest matches hashlib")
