"""Encrypted integers: arithmetic beyond single gates.

The counterpart of examples/06_encrypted_integers.py on PyTorch. The
reference evaluates one Boolean gate per bootstrap, so arithmetic means
netlists (an 8-bit add is ~40 gate bootstraps). The integer layer encodes
radix digits in the torus and uses the multi-output programmable bootstrap
(PBSmanyLUT): the sum digit and the carry come out of one blind rotation,
so an adder costs one bootstrap per bit, one batched kernel launch per
digit of the ripple.

Run:  python cufhe_tpu_torch/examples/06_encrypted_integers.py   # the card
      python cufhe_tpu_torch/examples/06_encrypted_integers.py --cpu
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from cufhe_tpu_torch import TINY, golden as G  # noqa: E402
from cufhe_tpu_torch.models import (Context, IntContext,  # noqa: E402
                                    decrypt_bits, decrypt_uint,
                                    encrypt_uint)

DEVICE = "cpu" if "--cpu" in sys.argv else "cuda"
if DEVICE == "cuda" and not torch.cuda.is_available():
    sys.exit("no CUDA device: run on the card, or pass --cpu")
rng = np.random.default_rng(23)
sk = G.keygen(TINY, seed=1)
ek = G.make_eval_key(sk, seed=2)
ictx = IntContext(Context(ek, device=DEVICE))


def enc(values, bits):
    return encrypt_uint(values, bits, sk, rng=rng, device=DEVICE)


# --- client: encrypt two batches of 8-bit integers ------------------------
xs, ys = [200, 13, 77, 255], [100, 29, 77, 1]
x, y = enc(xs, 8), enc(ys, 8)
print(f"x = {xs}, y = {ys}  (each digit a TLWE ciphertext)")

# --- server: arithmetic without decrypting --------------------------------
ok = 0
s = ictx.add(x, y)                      # 1 bootstrap a bit
d = ictx.sub(x, y)
ge = ictx.ge(x, y)
eq = ictx.eq(x, y)

got_s = decrypt_uint(s, sk)
got_d = decrypt_uint(d, sk)
got_ge = decrypt_bits(ge, sk).tolist()
got_eq = decrypt_bits(eq, sk).tolist()
want_s = [(a + b) % 256 for a, b in zip(xs, ys)]
want_d = [(a - b) % 256 for a, b in zip(xs, ys)]
want_ge = [int(a >= b) for a, b in zip(xs, ys)]
want_eq = [int(a == b) for a, b in zip(xs, ys)]

for name, got, want in (("x+y", got_s, want_s), ("x-y", got_d, want_d),
                        ("x>=y", got_ge, want_ge), ("x==y", got_eq,
                                                    want_eq)):
    match = got == want
    ok += match
    print(f"{name}: {got}  expected {want}  {'OK' if match else 'WRONG'}")

assert ok == 4

# --- division: restoring divmod -------------------------------------------
xs4, ys4 = [13, 9], [3, 4]
q, r = ictx.divmod_(enc(xs4, 4), enc(ys4, 4))
got_q, got_r = decrypt_uint(q, sk), decrypt_uint(r, sk)
print(f"divmod({xs4}, {ys4}) = {got_q} rem {got_r}")
assert got_q == [a // b for a, b in zip(xs4, ys4)]
assert got_r == [a % b for a, b in zip(xs4, ys4)]

# --- encrypted-amount barrel shift -----------------------------------------
vals, amts = [0b0110, 0b1001], [1, 2]
sh = ictx.shift_left(enc(vals, 4), enc(amts, 2))
got_sh = decrypt_uint(sh, sk)
print(f"{vals} << {amts} (amounts encrypted) = {got_sh}")
assert got_sh == [(v << s) & 0xF for v, s in zip(vals, amts)]

print("all encrypted integer results correct")
