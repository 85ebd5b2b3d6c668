"""A Bristol Fashion circuit evaluated block after block: each block's
inputs are fresh random bits from the seed, encrypted at lvl0, and the
client waits for each block's outputs before sending the next (a closed
loop of one client).

The program schedules the netlist once in set-up (runtime.bristol.
compile_bristol) and evaluates each block with runtime.executor.
run_schedule. Mix parameters: "netlist" (traffic/netlist_<name>.py, whose
bristol() gives the text), "reference" (reference/<name>.py, whose
outputs(text, input_bits) gives the bits the circuit must give), "batch"
(blocks evaluated together in one run_schedule call), "metric" (the
end-to-end metric: milliseconds of the window per block completed),
"trace_steps" (calls a traced run profiles).

What decides `correct`, over the outputs of every block (the warm-up's
and every block of the window):
- wrong_bits: output bits, decrypted, that differ from the reference's
  outputs for the same input bits;
- noise_var: the mean square of each output's phase error, the distance
  of b - <a, s> from the +-mu the reference's bit calls for, in units of
  2^24 (of the torus' 2^32). The exact gate leaves fresh bootstrapping
  noise on every output whatever came before it; a product computed in
  lower precision leaves more, though its bits may all still decrypt
  right.
"""
from __future__ import annotations

import importlib
import math
import os
import time

import torch

from fhebench.reference import tfhe as R

#: bootstrapped rotations of one gate of the netlist, by Bristol op;
#: INV, NOT, EQW and EQ are free
ROTATIONS = {"XOR": 1, "AND": 1, "OR": 1, "NAND": 1, "NOR": 1, "XNOR": 1,
             "ANDYN": 1, "ANDNY": 1, "ORYN": 1, "ORNY": 1, "MUX": 2}


def netlist_text(name: str) -> str:
    from fhebench.harness import load_module
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f"netlist_{name}.py")
    return load_module(path, f"fhebench.traffic.netlist_{name}").bristol()


def widths(text: str) -> tuple:
    """(input bits, output bits, rotations a block) of a netlist."""
    lines = text.strip().splitlines()
    ins = lines[1].split()
    outs = lines[2].split()
    rot = sum(ROTATIONS.get(ln.split()[-1].upper(), 0) for ln in lines[3:])
    return (sum(map(int, ins[1:1 + int(ins[0])])),
            sum(map(int, outs[1:1 + int(outs[0])])), rot)


class Driver:
    def __init__(self, session, mix: dict):
        from cufhe_tpu_torch.models.api import Ctxt
        from cufhe_tpu_torch.runtime.bristol import compile_bristol
        self.session, self.mix, self.Ctxt = session, mix, Ctxt
        self.batch = mix["batch"]
        self.text = netlist_text(mix["netlist"])
        self.reference = importlib.import_module(
            "fhebench.reference." + mix["reference"])
        self.n_in, self.n_out, self.rotations = widths(self.text)
        self.sched, _ = compile_bristol(self.text)
        self.inputs = []     # per block: input bits [batch, n_in]
        self.outputs = []    # per block: output words [n_out, batch, n0+1]
        self.encrypted = []  # per block still to run: its Ctxts

    def _encrypt(self, blocks: int) -> None:
        """Draw and encrypt the inputs of blocks up to `blocks` (block i
        from its own stream of the seed, so a block's inputs do not depend
        on how many were drawn)."""
        s = self.session
        for i in range(len(self.inputs), blocks):
            g = s.generator(1000 + i)
            bits = torch.randint(0, 2, (self.batch, self.n_in), generator=g,
                                 device=g.device)
            ct = R.encrypt_bits(s.p, s.sk, bits.T.reshape(-1), g)
            ct = s.to_port(ct.reshape(self.n_in, self.batch, -1))
            self.inputs.append(bits)
            self.encrypted.append([self.Ctxt(ct[w], 0)
                                   for w in range(self.n_in)])

    def _block(self) -> None:
        from cufhe_tpu_torch.runtime.executor import run_schedule
        cts = self.encrypted[len(self.outputs)]
        outs = run_schedule(self.session.ctx, self.sched, cts)
        self.outputs.append(torch.stack([o.data for o in outs]))
        self.encrypted[len(self.outputs) - 1] = None
        self.session.sync()              # the client waits for its block

    def warm_up(self) -> float:
        """One block, which runs every step shape of the schedule. Returns
        its seconds."""
        self._encrypt(1)
        t0 = time.perf_counter()
        self._block()
        return time.perf_counter() - t0

    def plan(self, seconds: float, per_step: float) -> None:
        """Encrypt, before the window, three times the blocks the warm-up's
        pace would complete in it."""
        self._encrypt(len(self.outputs)
                      + 3 * math.ceil(seconds / max(per_step, 1e-3)) + 4)

    def step(self) -> None:
        if len(self.outputs) >= len(self.encrypted):
            raise RuntimeError("the window outran the encrypted blocks")
        self._block()

    def end_to_end(self, steps: int, seconds: float) -> dict:
        return {self.mix["metric"]: seconds * 1e3 / steps}

    def counts(self, steps: int) -> dict:
        return {"steps": steps,
                "rotation_rows": steps * self.rotations * self.batch}

    def check(self, ek: R.EvalKey):
        """(numbers compared, attempted, failed) once the window has
        closed."""
        s = self.session
        wrong = bad_blocks = 0
        err2 = []
        for bits, words in zip(self.inputs, self.outputs):
            ph = R.phase(s.sk, s.from_port(words.reshape(-1, words.shape[-1])))
            want = torch.as_tensor(self.reference.outputs(
                self.text, bits.cpu().numpy()), device=ph.device)
            want = want.T.reshape(-1)            # [n_out * batch], as ph
            bad = (ph > 0).to(torch.int64) != want
            wrong += int(bad.sum())
            bad_blocks += int(bad.reshape(self.n_out, -1).any(dim=0).sum())
            err = R._signed((ph - torch.where(want == 1, s.p.mu0, -s.p.mu0))
                            & R.MASK)
            err2.append((err.to(torch.float64) / (1 << 24)) ** 2)
        return ({"wrong_bits": wrong,
                 "noise_var": float(torch.cat(err2).mean())},
                (len(self.outputs) - 1) * self.batch, bad_blocks)
