"""Encrypted table lookup: reading memory the server cannot see.

The counterpart of examples/05_encrypted_lookup.py on PyTorch. Vertical
packing is how the Virtual Secure Platform reads ROM and RAM: data lives in
TRLWE words (N bits per ciphertext), the address bits are TRGSW
ciphertexts, and a CMUX tree plus an in-word rotation selects the
addressed bit without the server learning the address, the data or the
result. The reference ships the per-node CMUX kernel
(bootstrap_gpu.cu:197-285); this is the complete read path built on it.

Run:  python cufhe_tpu_torch/examples/05_encrypted_lookup.py   # the card
      python cufhe_tpu_torch/examples/05_encrypted_lookup.py --cpu
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from cufhe_tpu_torch import TINY, golden as G  # noqa: E402
from cufhe_tpu_torch.models import circuits  # noqa: E402
from cufhe_tpu_torch.models.api import (Context, TrlweCtxt,  # noqa: E402
                                        decrypt_bits)
from cufhe_tpu_torch.torus import from_u32  # noqa: E402

DEVICE = "cpu" if "--cpu" in sys.argv else "cuda"
if DEVICE == "cuda" and not torch.cuda.is_available():
    sys.exit("no CUDA device: run on the card, or pass --cpu")
rng = np.random.default_rng(19)
sk = G.keygen(TINY, seed=1)
ek = G.make_eval_key(sk, seed=2)
ctx = Context(ek, device=DEVICE)
lp = sk.params.lvl1

# --- client: encrypt a 4-word table (each word packs N bits) --------------
TREE_BITS, WORD_BITS = 2, 3           # 4 words x 8 addressable slots
words = rng.integers(0, 2, size=(1 << TREE_BITS, lp.n))
leaves = TrlweCtxt(from_u32(np.stack(
    [G.trlwe_encrypt_bits(w, lp, sk.lvl1, rng) for w in words]), DEVICE))
print(f"table: {1 << TREE_BITS} encrypted words x {1 << WORD_BITS} "
      "addressed slots")

# --- server: look up three addresses it cannot read -----------------------
ok = 0
for addr in (0b00000, 0b01101, 0b11111):
    wi, slot = addr >> WORD_BITS, addr & ((1 << WORD_BITS) - 1)
    sels = [ctx.prepare_trgsw(
        G.trgsw_encrypt((addr >> i) & 1, lp, sk.lvl1, rng))
        for i in range(TREE_BITS + WORD_BITS)]
    bit = circuits.vertical_packing_lookup(ctx, sels, leaves, WORD_BITS)
    got = decrypt_bits(bit, sk)[0]
    want = words[wi][slot]
    print(f"addr {addr:05b}: read {got}, expected {want} "
          f"{'ok' if got == want else 'FAIL'}")
    ok += got == want
assert ok == 3
print("all encrypted lookups correct")
