"""The plain reference against the program on the CPU at tiny sizes, and
the AES-128 netlist against FIPS-197."""
import numpy as np
import pytest
import torch

from fhebench import harness as H
from fhebench.reference import aes128, bristol
from fhebench.reference import tfhe as R
from fhebench.traffic import bristol_circuit, netlist_aes128


def _port_context(cfg, p, sk_seed):
    from cufhe_tpu_torch import golden
    from cufhe_tpu_torch.models.api import Context
    sk = R.keygen(p, sk_seed, "cpu")
    ek = R.make_eval_key(p, sk, sk_seed)
    host = golden.EvalKey(H.port_params(cfg), ek.bk.numpy().astype(np.uint32),
                          ek.ksk.numpy().astype(np.uint32))
    return sk, ek, Context(host, device="cpu")


@pytest.mark.parametrize("gate", ["nand", "xor", "andyn"])
def test_reference_gate_is_the_programs_word_for_word(tiny_set, gate):
    from cufhe_tpu_torch.models.api import Ctxt
    p = R.Params.from_config(tiny_set)
    sk, ek, ctx = _port_context(tiny_set, p, 2 ** 33 + 5)
    g = R.generator(9, 2, "cpu")
    a, b = (torch.randint(0, 2, (37,), generator=g) for _ in range(2))
    x, y = R.encrypt_bits(p, sk, a, g), R.encrypt_bits(p, sk, b, g)
    out = ctx.gate(gate, Ctxt(H.Session.to_port(x), 0),
                   Ctxt(H.Session.to_port(y), 0))
    ref = R.gate(p, ek, gate, x, y)
    assert torch.equal(H.Session.from_port(out.data), ref)
    assert torch.equal(R.decrypt_bits(sk, ref), R.plain_gate(gate, a, b))


def test_reference_decrypts_what_it_encrypts(tiny):
    p = R.Params.from_config(tiny)
    sk = R.keygen(p, 3, "cpu")
    g = R.generator(3, 2, "cpu")
    bits = torch.randint(0, 2, (500,), generator=g)
    assert torch.equal(R.decrypt_bits(sk, R.encrypt_bits(p, sk, bits, g)),
                       bits)


FIPS = [("3243f6a8885a308d313198a2e0370734",
         "2b7e151628aed2a6abf7158809cf4f3c",
         "3925841d02dc09fbdc118597196a0b32"),
        ("00112233445566778899aabbccddeeff",
         "000102030405060708090a0b0c0d0e0f",
         "69c4e0d86a7b0430d8cdb78070b4c55a")]


def _bits(data: bytes):
    return [(b >> i) & 1 for b in data for i in range(8)]


@pytest.mark.parametrize("pt,key,ct", FIPS)
def test_aes_reference_and_netlist_match_fips197(pt, key, ct):
    pt, key, ct = (bytes.fromhex(h) for h in (pt, key, ct))
    assert aes128.encrypt_block(pt, key) == ct
    text = netlist_aes128.bristol()
    inputs = np.array([_bits(pt) + _bits(key)])
    assert list(bristol.outputs(text, inputs)[0]) == _bits(ct)
    assert list(aes128.outputs(text, inputs)[0]) == _bits(ct)


def test_aes_netlist_counts():
    text = netlist_aes128.bristol()
    assert bristol_circuit.widths(text) == (256, 128, 45760)
    rng = np.random.default_rng(4)
    inputs = rng.integers(0, 2, (4, 256))
    assert np.array_equal(bristol.outputs(text, inputs),
                          aes128.outputs(text, inputs))


def test_small_bristol_circuit_on_the_program(tiny):
    """One AES S-box through the program's scheduler and executor against
    the plain evaluation of the same netlist."""
    from cufhe_tpu_torch.models.api import Ctxt
    from cufhe_tpu_torch.runtime.bristol import compile_bristol
    from cufhe_tpu_torch.runtime.executor import run_schedule
    w = netlist_aes128.BristolWriter()
    text = w.finalize(netlist_aes128.sbox_circuit(w, w.inputs(8)))
    p = R.Params.from_config(tiny)
    sk, _, ctx = _port_context(tiny, p, 17)
    g = R.generator(17, 2, "cpu")
    bits = torch.randint(0, 2, (3, 8), generator=g)
    cts = R.encrypt_bits(p, sk, bits.T.reshape(-1), g).reshape(8, 3, -1)
    sched, _ = compile_bristol(text)
    outs = run_schedule(ctx, sched, [Ctxt(H.Session.to_port(c), 0)
                                     for c in cts])
    got = torch.stack([R.decrypt_bits(sk, H.Session.from_port(o.data))
                       for o in outs], dim=1)
    want = bristol.outputs(text, bits.numpy())
    assert np.array_equal(got.numpy(), want)
    S = aes128.sbox()
    for row, out in zip(bits.tolist(), want):
        x = sum(b << i for i, b in enumerate(row))
        assert sum(int(b) << i for i, b in enumerate(out)) == S[x]
