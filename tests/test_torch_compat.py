"""cufhe_tpu_torch.compat, the v1 API surface (SetSeed / KeyGen /
Initialize / Encrypt / Decrypt / gates / Synchronize / CleanUp), on the
CPU: the cases of tests/test_compat.py, with the keys and ciphertexts on
the CPU and a CPU Stream, and the port's backend rule."""
import numpy as np
import pytest
import torch

import cufhe_tpu.compat as jcf
import cufhe_tpu_torch.compat as cf
from cufhe_tpu_torch import TINY
from cufhe_tpu_torch.torus import to_u32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Intra-op threads off while this module runs: the suite runs several
    worker processes on the same cores, where torch's thread pool spends
    its time waiting for its own threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def keys():
    cf.SetSeed(42)
    pri = cf.PriKey(TINY)
    pub = cf.PubKey(TINY)
    cf.KeyGen(pub, pri)
    cf.Initialize(pub, device="cpu")
    yield pri, pub
    cf.CleanUp()
    cf.SetSeed()


def test_encrypt_decrypt_roundtrip(keys):
    pri, _ = keys
    for bit in (0, 1):
        pt, pt2, ct = cf.Ptxt(bit), cf.Ptxt(), cf.Ctxt()
        cf.Encrypt(ct, pt, pri)
        assert ct._c.data.device.type == "cpu" and ct._c.batch == 1
        cf.Decrypt(pt2, ct, pri)
        assert pt2.message_ == bit


def test_gates_truth_tables(keys):
    pri, _ = keys
    cases = {
        cf.Nand: lambda a, b: 1 - (a & b),
        cf.And: lambda a, b: a & b,
        cf.Or: lambda a, b: a | b,
        cf.Xor: lambda a, b: a ^ b,
        cf.AndYN: lambda a, b: a & (1 - b),
        cf.OrNY: lambda a, b: (1 - a) | b,
    }
    st = cf.Stream(device="cpu")
    for gate, oracle in cases.items():
        for a in (0, 1):
            for b in (0, 1):
                c0, c1, out = cf.Ctxt(), cf.Ctxt(), cf.Ctxt()
                cf.Encrypt(c0, cf.Ptxt(a), pri)
                cf.Encrypt(c1, cf.Ptxt(b), pri)
                gate(out, c0, c1, st)
                cf.Synchronize()
                pt = cf.Ptxt()
                cf.Decrypt(pt, out, pri)
                assert pt.message_ == oracle(a, b), (gate.__name__, a, b)


def test_mux_not_copy(keys):
    pri, _ = keys
    for s, a, b in [(0, 1, 0), (1, 1, 0), (0, 0, 1), (1, 0, 1)]:
        cs, ca, cb, out, nout = (cf.Ctxt() for _ in range(5))
        cf.Encrypt(cs, cf.Ptxt(s), pri)
        cf.Encrypt(ca, cf.Ptxt(a), pri)
        cf.Encrypt(cb, cf.Ptxt(b), pri)
        cf.Mux(out, cs, ca, cb)
        cf.NMux(nout, cs, ca, cb)
        for ct, want in ((out, a if s else b), (nout, 1 - (a if s else b))):
            pt = cf.Ptxt()
            cf.Decrypt(pt, ct, pri)
            assert pt.message_ == want
    n, c, cp = cf.Ctxt(), cf.Ctxt(), cf.Ctxt()
    cf.Encrypt(c, cf.Ptxt(1), pri)
    cf.Not(n, c)
    cf.Copy(cp, c)
    for ct, want in ((n, 0), (cp, 1)):
        pt = cf.Ptxt()
        cf.Decrypt(pt, ct, pri)
        assert pt.message_ == want


def test_keys_and_gate_equal_original(keys):
    """The same seed gives the JAX surface's keys, and a gate on the same
    ciphertexts gives its output, as uint32."""
    pri, pub = keys
    jcf.SetSeed(42)
    jpri, jpub = jcf.PriKey(TINY), jcf.PubKey(TINY)
    try:
        jcf.KeyGen(jpub, jpri)
        assert np.array_equal(pri.sk.lvl0, jpri.sk.lvl0)
        assert np.array_equal(pub.ek.bk, jpub.ek.bk)
        a, b, out = cf.Ctxt(), cf.Ctxt(), cf.Ctxt()
        cf.Encrypt(a, cf.Ptxt(1), pri)
        cf.Encrypt(b, cf.Ptxt(0), pri)
        cf.Xor(out, a, b)
        jcf.Initialize(jpub)
        ja, jb, jout = jcf.Ctxt(), jcf.Ctxt(), jcf.Ctxt()
        from cufhe_tpu.models.api import Ctxt as JCtxt
        ja._c = JCtxt(to_u32(a._c.data), 0)
        jb._c = JCtxt(to_u32(b._c.data), 0)
        jcf.Xor(jout, ja, jb)
        assert np.array_equal(to_u32(out._c.data), np.asarray(jout._c.data))
    finally:
        jcf.CleanUp()
        jcf.SetSeed()


def test_backend_names():
    """Initialize takes the JAX package's backend names, ntt among them:
    a gate then runs the ntt path and decrypts right; pallas3 is left
    out, unknown names are refused."""
    cf.SetSeed(7)
    pri, pub = cf.PriKey(TINY), cf.PubKey(TINY)
    cf.KeyGen(pub, pri)
    saved = cf._ctx
    try:
        cf.Initialize(pub, backend="conv", device="cpu")
        assert cf._ctx.backend == "conv"
        cf.Initialize(pub, "ntt", device="cpu")
        assert cf._ctx.backend == "ntt" and cf._ctx.keys.bk_ext.numel() == 0
        a, b, out, pt = cf.Ctxt(), cf.Ctxt(), cf.Ctxt(), cf.Ptxt()
        cf.Encrypt(a, cf.Ptxt(1), pri)
        cf.Encrypt(b, cf.Ptxt(1), pri)
        cf.Nand(out, a, b)
        cf.Decrypt(pt, out, pri)
        assert pt.message_ == 0
        with pytest.raises(NotImplementedError, match="pallas3"):
            cf.Initialize(pub, backend="pallas3", device="cpu")
        with pytest.raises(ValueError, match="unknown backend"):
            cf.Initialize(pub, backend="cuda", device="cpu")
    finally:
        cf._ctx = saved
        cf.SetSeed(42)
