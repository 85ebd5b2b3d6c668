"""A closed loop of batched lvl0 gates, each call on the previous call's
outputs: out = gate(out, y), the ciphertexts staying on the device.

This is a gate server that batches many clients' gates into one call
(cuFHE's test_api_gpu pattern); the window drives Context.gate. Mix
parameters: "gate" (one of the ten two-input gates), "batch" (ciphertexts
a call), "metric" (the end-to-end metric it reports: bootstrapped gates
completed a second), "trace_steps" (calls a traced run profiles).

What decides `correct`:
- mismatched_words: the uint32 words in which the program's output of a
  checked call differs from the reference's gate on the same inputs.
  Checked are the first call, whose inputs the benchmark encrypted, one
  call of the window drawn from the seed, and the window's last call, all
  rows of each; the inputs of the later two are the program's own outputs
  of the call before.
- wrong_bits: the last output, decrypted, against the plaintext chain.
"""
from __future__ import annotations

import time

import torch

from fhebench.reference import tfhe as R


class Driver:
    def __init__(self, session, mix: dict):
        from cufhe_tpu_torch.models.api import Ctxt
        self.session, self.mix = session, mix
        self.Ctxt = Ctxt
        self.name, self.batch = mix["gate"], mix["batch"]
        g = session.generator(2)
        self.bits0 = torch.randint(0, 2, (self.batch,), generator=g,
                                   device=g.device)
        self.bits1 = torch.randint(0, 2, (self.batch,), generator=g,
                                   device=g.device)
        self.x = R.encrypt_bits(session.p, session.sk, self.bits0, g)
        self.y = R.encrypt_bits(session.p, session.sk, self.bits1, g)
        self.b = Ctxt(session.to_port(self.y), 0)
        self.kept = []                   # (input, output) of checked calls
        self.calls = 0                   # calls made, warm-up included
        self.window_calls = 0
        self.pick = None

    def _call(self, a):
        return self.session.ctx.gate(self.name, a, self.b)

    def warm_up(self) -> float:
        """Two calls: the first builds and loads every kernel, the second
        times one call. Returns its seconds."""
        first = self._call(self.Ctxt(self.session.to_port(self.x), 0))
        self.kept.append((self.session.to_port(self.x), first.data))
        self.session.sync()
        t0 = time.perf_counter()
        self.out = self._call(first)
        self.session.sync()
        self.calls = 2
        return time.perf_counter() - t0

    def plan(self, seconds: float, per_step: float) -> None:
        """Draw from the seed the window call to check, among those the
        window will surely reach."""
        reach = max(1, int(0.8 * seconds / max(per_step, 1e-9)))
        g = self.session.generator(3)
        self.pick = int(torch.randint(0, reach, (1,), generator=g,
                                      device=g.device))

    def step(self) -> None:
        prev = self.out
        self.out = self._call(prev)
        if self.window_calls == self.pick:
            self.kept.append((prev.data, self.out.data))
        self.last = (prev.data, self.out.data)
        self.window_calls += 1
        self.calls += 1

    def end_to_end(self, steps: int, seconds: float) -> dict:
        return {self.mix["metric"]: steps * self.batch / seconds}

    def counts(self, steps: int) -> dict:
        """Of `steps` window calls: one rotation a row a call."""
        return {"steps": steps, "rotation_rows": steps * self.batch}

    def check(self, ek: R.EvalKey):
        """(checks, attempted, failed) once the window has closed."""
        s, p = self.session, self.session.p
        if self.last[1] is not self.kept[-1][1]:
            self.kept.append(self.last)
        y = self.y.to(s.device)
        mismatched, bad_rows = 0, 0
        for inp, out in self.kept:
            ref = R.gate(p, ek, self.name, s.from_port(inp), y)
            diff = s.from_port(out) != ref
            mismatched += int(diff.sum())
            bad_rows += int(diff.any(dim=1).sum())
        want = self.bits0
        for _ in range(self.calls):
            want = R.plain_gate(self.name, want, self.bits1)
        got = R.decrypt_bits(s.sk, s.from_port(self.out.data))
        wrong = int((got != want).sum())
        return ({"mismatched_words": mismatched, "wrong_bits": wrong},
                self.window_calls * self.batch, bad_rows + wrong)
