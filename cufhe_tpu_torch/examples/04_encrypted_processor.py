"""TOY8: running programs the server cannot see.

The counterpart of examples/04_encrypted_processor.py on PyTorch. The
reference library was built for the Virtual Secure Platform, a CPU whose
program, data and every intermediate value are TFHE ciphertexts (reference
README.md:2-7). Here the client encrypts small programs and the server
steps the processor's cycle circuit homomorphically: every cycle evaluates
all paths and muxes under encryption, so the server cannot tell a jump from
an add, or which branch was taken.

The batch axis runs B different encrypted programs per evaluation, one a
lane.

Run:  python cufhe_tpu_torch/examples/04_encrypted_processor.py   # the card
      python cufhe_tpu_torch/examples/04_encrypted_processor.py --cpu
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from cufhe_tpu_torch import TINY, golden as G  # noqa: E402
from cufhe_tpu_torch.models import Context, processor as TOY  # noqa: E402

DEVICE = "cpu" if "--cpu" in sys.argv else "cuda"
if DEVICE == "cuda" and not torch.cuda.is_available():
    sys.exit("no CUDA device: run on the card, or pass --cpu")
rng = np.random.default_rng(11)
sk = G.keygen(TINY, seed=1)
ek = G.make_eval_key(sk, seed=2)

# --- client side: write + encrypt three different programs ----------------
programs = [
    # sum 1..4 by looping:           ACC ends at 10
    [("ldi", 0), ("add", 1), ("add", 2), ("add", 3), ("add", 4)],
    # countdown 3,2,1,0 then escape: ACC ends at 0x99
    [("ldi", 3), ("add", 0xFF), ("jz", 5), ("jmp", 1), ("nop", 0),
     ("ldi", 0x99)],
    # bit fiddling:                  ((0xF0 ^ 0xFF) | 0x80) & 0x8F = 0x8F
    [("ldi", 0xF0), ("xor", 0xFF), ("or", 0x80), ("and", 0x8F)],
]
CYCLES = 10
inputs = TOY.encrypt_state(programs, sk, rng, device=DEVICE)
print(f"encrypted {len(programs)} programs "
      f"({TOY.PROG_SLOTS}x{TOY.INSTR_BITS} ROM bits each)")

# --- server side: compile the cycle circuit once, step it blind -----------
ctx = Context(ek, device=DEVICE)
cb, _ = TOY.build_cycle()
sched = cb.compile()
print(f"cycle circuit: {sched.num_gates} gates in {len(sched.levels)} "
      f"levels; running {CYCLES} cycles on {DEVICE}...")
state = TOY.run_cycles(ctx, sched, inputs, cycles=CYCLES)

# --- client side: decrypt final machine state ------------------------------
acc, pc = TOY.decrypt_state(state, sk)
for lane, prog in enumerate(programs):
    want_acc, want_pc = TOY.interpret(prog, CYCLES)
    status = "ok" if (acc[lane], pc[lane]) == (want_acc, want_pc) else "FAIL"
    print(f"lane {lane}: ACC=0x{acc[lane]:02X} PC={pc[lane]:2d} "
          f"(expected 0x{want_acc:02X}/{want_pc}) {status}")
    assert status == "ok"
print("all encrypted program runs match the plaintext interpreter")
