"""A closed loop of batched lvl0 MUX gates, each call's selector the
previous call's output: out = mux(out, x1, x0), the ciphertexts staying on
the device.

This is a gate server that batches many clients' MUX gates (conditional
selects, comparisons and lookups in compiled circuits) into one call; the
window drives Context.mux. A MUX is two bootstraps (two blind rotations
summed, then one key switch), so the end-to-end metric counts two a row.
Mix parameters: "batch" (ciphertexts a call), "metric" (the end-to-end
metric it reports: bootstraps completed a second), "trace_steps" (calls a
traced run profiles).

The loop, the warm-up and the draw of the checked window call are
nand_chain's, with the selector as the chained input. What decides
`correct`:
- mismatched_words: the uint32 words in which the program's output of a
  checked call differs from the reference MUX (fhebench.reference.mux) on
  the same inputs. Checked are the first call, whose selector the
  benchmark encrypted, one call of the window drawn from the seed, and the
  window's last call, all rows of each; the selectors of the later two are
  the program's own outputs of the call before.
- wrong_bits: the last output, decrypted, against the plaintext chain.
"""
from __future__ import annotations

import os

import torch

from fhebench.harness import load_module
from fhebench.reference import mux as M
from fhebench.reference import tfhe as R

_nand_chain = load_module(os.path.join(os.path.dirname(
    os.path.abspath(__file__)), "nand_chain.py"), "fhebench.traffic.nand_chain")

#: bootstraps a MUX makes (bristol_circuit.ROTATIONS counts it so too)
ROTATIONS = 2


class Driver(_nand_chain.Driver):
    def __init__(self, session, mix: dict):
        from cufhe_tpu_torch.models.api import Ctxt
        self.session, self.mix = session, mix
        self.Ctxt = Ctxt
        self.batch = mix["batch"]
        g = session.generator(2)
        self.bits_c, self.bits1, self.bits0 = (
            torch.randint(0, 2, (self.batch,), generator=g, device=g.device)
            for _ in range(3))
        p, sk = session.p, session.sk
        # x: the first call's selector, which the chain then replaces
        self.x = R.encrypt_bits(p, sk, self.bits_c, g)
        self.x1 = R.encrypt_bits(p, sk, self.bits1, g)
        self.x0 = R.encrypt_bits(p, sk, self.bits0, g)
        self.in1 = Ctxt(session.to_port(self.x1), 0)
        self.in0 = Ctxt(session.to_port(self.x0), 0)
        self.kept = []                   # (selector, output) of checked calls
        self.calls = 0                   # calls made, warm-up included
        self.window_calls = 0
        self.pick = None

    def _call(self, sel):
        return self.session.ctx.mux(sel, self.in1, self.in0)

    def end_to_end(self, steps: int, seconds: float) -> dict:
        return {self.mix["metric"]: steps * ROTATIONS * self.batch / seconds}

    def counts(self, steps: int) -> dict:
        """Of `steps` window calls: two rotations a row a call, whatever
        implements the MUX."""
        return {"steps": steps,
                "rotation_rows": steps * ROTATIONS * self.batch}

    def check(self, ek: R.EvalKey):
        """(checks, attempted, failed) once the window has closed."""
        s, p = self.session, self.session.p
        if self.last[1] is not self.kept[-1][1]:
            self.kept.append(self.last)
        x1, x0 = self.x1.to(s.device), self.x0.to(s.device)
        mismatched, bad_rows = 0, 0
        for sel, out in self.kept:
            ref = M.mux(p, ek, s.from_port(sel), x1, x0)
            diff = s.from_port(out) != ref
            mismatched += int(diff.sum())
            bad_rows += int(diff.any(dim=1).sum())
        want = self.bits_c
        for _ in range(self.calls):
            want = M.plain_mux(want, self.bits1, self.bits0)
        got = R.decrypt_bits(s.sk, s.from_port(self.out.data))
        wrong = int((got != want).sum())
        return ({"mismatched_words": mismatched, "wrong_bits": wrong},
                self.window_calls * self.batch, bad_rows + wrong)
