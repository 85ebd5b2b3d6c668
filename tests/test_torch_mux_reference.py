"""The port's lvl0 MUX (Context.mux, Context.nmux) against the benchmark's
plain reference MUX (fhebench/reference/mux.py) on the CPU, word for word,
at a tiny Karatsuba depth-0 set and a tiny depth-1 set; the reference's
cleartext MUX against the decrypted outputs; the MUX's own span and
counters; and the reference's imports."""
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cufhe_tpu_torch import golden
from cufhe_tpu_torch.models.api import Context, Ctxt
from cufhe_tpu_torch.ops import blind_rotate as BR
from cufhe_tpu_torch.utils import spans
from fhebench import harness as H
from fhebench.reference import mux as M
from fhebench.reference import tfhe as R


def _config(n0, N, l, Bgbit, t):
    return {"name": f"tiny-mux-{N}-{Bgbit}",
            "lvl0": {"n": n0, "k": 1, "alpha": 2 ** -20, "mu": 1 << 29},
            "lvl1": {"N": N, "k": 1, "l": l, "Bgbit": Bgbit,
                     "alpha": 2 ** -30, "mu": 1 << 29},
            "keyswitch": {"t": t, "basebit": 2}}


#: (configuration, the Karatsuba depth of the port's product there): the
#: TINY shape, and N = 256 at cggi19's l = 3, Bgbit = 7, which takes depth 1
SETS = {"depth0": (_config(16, 64, 2, 6, 4), 0),
        "depth1": (_config(12, 256, 3, 7, 5), 1)}
ROWS = 9


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Intra-op threads off while a test runs: the suite runs several
    worker processes on the same cores, where torch's thread pool spends
    its time waiting for its own threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(name, seed=2 ** 33 + 7):
    """The reference's keys from a seed and the port's Context over them,
    built as fhebench.harness.Session builds them; three encrypted input
    vectors of ROWS bits."""
    cfg, depth = SETS[name]
    p = R.Params.from_config(cfg)
    sk = R.keygen(p, seed, "cpu")
    ek = R.make_eval_key(p, sk, seed)
    port = H.port_params(cfg)
    assert BR.kar_depth(port) == depth
    host = golden.EvalKey(port, ek.bk.numpy().astype(np.uint32),
                          ek.ksk.numpy().astype(np.uint32))
    ctx = Context(host, device="cpu")
    g = R.generator(seed, 2, "cpu")
    bits = [torch.randint(0, 2, (ROWS,), generator=g) for _ in range(3)]
    cts = [R.encrypt_bits(p, sk, b, g) for b in bits]
    return p, sk, ek, ctx, bits, cts


def _port(ct):
    return Ctxt(H.Session.to_port(ct), 0)


@pytest.mark.parametrize("negate", [False, True], ids=["mux", "nmux"])
@pytest.mark.parametrize("name", sorted(SETS))
def test_port_mux_is_the_reference_word_for_word(name, negate):
    p, sk, ek, ctx, bits, (c, x1, x0) = _setup(name)
    call = ctx.nmux if negate else ctx.mux
    out = call(_port(c), _port(x1), _port(x0))
    ref = M.mux(p, ek, c, x1, x0, negate=negate)
    assert torch.equal(H.Session.from_port(out.data), ref)
    # and once more on the port's own output as the selector, as the
    # benchmark's chain does
    again = call(out, _port(x1), _port(x0))
    ref2 = M.mux(p, ek, ref, x1, x0, negate=negate)
    assert torch.equal(H.Session.from_port(again.data), ref2)


@pytest.mark.parametrize("name", sorted(SETS))
def test_plain_mux_is_what_the_outputs_decrypt_to(name):
    p, sk, ek, _, (bc, b1, b0), (c, x1, x0) = _setup(name, seed=41)
    for negate in (False, True):
        got = R.decrypt_bits(sk, M.mux(p, ek, c, x1, x0, negate=negate))
        assert torch.equal(got, M.plain_mux(bc, b1, b0, negate=negate))
    c, x1, x0 = (np.array(v) for v in ([0, 0, 0, 0, 1, 1, 1, 1],
                                       [0, 0, 1, 1, 0, 0, 1, 1],
                                       [0, 1, 0, 1, 0, 1, 0, 1]))
    assert list(M.plain_mux(c, x1, x0)) == [0, 1, 0, 1, 0, 0, 1, 1]
    assert list(M.plain_mux(c, x1, x0, negate=True)) == \
        [1, 0, 1, 0, 1, 1, 0, 0]


def test_mux_records_its_own_span_and_counts():
    """A MUX opens cufhe.gate.mux with its two rotations and one key switch
    inside, and counts one `mux` and its rows; a NAND keeps cufhe.gate and
    counts no mux."""
    _, _, _, ctx, _, (c, x1, x0) = _setup("depth0")
    before = spans.counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ctx.mux(_port(c), _port(x1), _port(x0))
        ctx.nmux(_port(c), _port(x1), _port(x0))
    got = spans.counts() - before
    assert got["mux"] == 2 and got["mux.rows"] == 2 * ROWS
    parents = {}
    for ev in prof.events():
        if ev.name.startswith("cufhe."):
            up = ev.cpu_parent
            while up is not None and not up.name.startswith("cufhe."):
                up = up.cpu_parent
            parents.setdefault(ev.name, []).append(
                up.name if up is not None else None)
    assert parents == {"cufhe.gate.mux": [None, None],
                       "cufhe.blind_rotate": ["cufhe.gate.mux"] * 4,
                       "cufhe.key_switch": ["cufhe.gate.mux"] * 2}

    before = spans.counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ctx.nand(_port(c), _port(x1))
    assert (spans.counts() - before)["mux"] == 0
    names = [ev.name for ev in prof.events() if ev.name.startswith("cufhe.")]
    assert sorted(names) == ["cufhe.blind_rotate", "cufhe.gate",
                             "cufhe.key_switch"]


def test_reference_mux_loads_neither_package():
    code = ("import fhebench.reference.mux, sys\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    loaded = set(subprocess.run([sys.executable, "-c", code],
                                cwd=H.ROOT, capture_output=True, text=True,
                                check=True).stdout.split())
    assert "torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "cufhe_tpu",
                         "cufhe_tpu_torch"}
