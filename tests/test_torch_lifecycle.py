"""The key lifecycle of cufhe_tpu_torch.Context (release_keys,
prepare_backend, reinitialize; the counterpart of tests/test_lifecycle.py),
key and ciphertext files (utils.serialization, a copy of the JAX
package's, interchangeable with it) and the timing helpers, on the CPU at
the tiny presets."""
import numpy as np
import pytest
import torch

from cufhe_tpu import golden as JG
from cufhe_tpu import params as JP
from cufhe_tpu.utils import serialization as JS
from cufhe_tpu_torch import Context, decrypt_bits, encrypt_bits
from cufhe_tpu_torch import golden as G
from cufhe_tpu_torch import params as P
from cufhe_tpu_torch.runtime import build_ripple_adder, run_schedule
from cufhe_tpu_torch.torus import from_u32, to_u32
from cufhe_tpu_torch.utils import serialization as S
from cufhe_tpu_torch.utils import timing


@pytest.fixture(scope="module")
def keyed_bits(tiny_key):
    sk, ek = tiny_key
    rng = np.random.default_rng(5)
    bits0 = rng.integers(0, 2, 16)
    bits1 = rng.integers(0, 2, 16)
    a = encrypt_bits(bits0, sk, np.random.default_rng(6), device="cpu")
    b = encrypt_bits(bits1, sk, np.random.default_rng(7), device="cpu")
    return sk, ek, bits0, bits1, a, b


def _nand_ref(bits0, bits1):
    return 1 - (bits0 & bits1)


@pytest.mark.parametrize("backend", ["pallas", "auto"])
def test_release_and_reprepare_roundtrip(keyed_bits, backend):
    sk, ek, bits0, bits1, a, b = keyed_bits
    ctx = Context(ek, device="cpu")
    before = ctx.nand(a, b)
    assert np.array_equal(decrypt_bits(before, sk), _nand_ref(bits0, bits1))
    ctx.release_keys(("pallas",))
    assert ctx.keys.bk_ext.numel() == 0
    assert ctx.keys.bk_ext.dtype == torch.int8
    assert ctx.keys.ksk_limbs_sei.numel() > 0     # the KSK survives
    ctx.prepare_backend(ek, backend)
    assert torch.equal(ctx.nand(a, b).data, before.data)   # bit-identical


def test_full_release_frees_everything(keyed_bits):
    sk, ek, bits0, bits1, a, b = keyed_bits
    ctx = Context(ek, device="cpu")
    before = ctx.nand(a, b)
    ctx.release_keys()
    for name in ("bk_ext", "ksk_limbs_sei", "sei_perm"):
        assert getattr(ctx.keys, name).numel() == 0, name
    ctx.prepare_backend(ek)             # restores the KSK alongside
    assert ctx.keys.ksk_limbs_sei.numel() > 0 and ctx.keys.sei_perm.numel()
    assert torch.equal(ctx.nand(a, b).data, before.data)
    ctx.release_keys(("ksk",))
    assert ctx.keys.bk_ext.numel() > 0
    ctx.prepare_backend(ek, "ksk")
    assert torch.equal(ctx.nand(a, b).data, before.data)


def test_released_keys_raise_not_fault(keyed_bits):
    """Every key-reading path raises ValueError naming release_keys."""
    sk, ek, bits0, bits1, a, b = keyed_bits
    ctx = Context(ek, device="cpu")
    s = build_ripple_adder(1)[0].compile()
    ctx.release_keys(("pallas",))
    for call in (lambda: ctx.nand(a, b),
                 lambda: ctx.gate("xor", a, b, stream=None),
                 lambda: ctx.mux(a, b, a),
                 lambda: ctx.gate_chain("nand", a, b, depth=2),
                 lambda: ctx.gate_rows(np.zeros((1, 3), np.uint32), a, b),
                 lambda: ctx.bootstrap_tlwe2trlwe(a),
                 lambda: ctx.programmable_bootstrap(
                     a, np.zeros(ek.params.lvl1.n, np.uint32)),
                 lambda: run_schedule(ctx, s, [a, b, a])):
        with pytest.raises(ValueError, match="release_keys"):
            call()
    # the linear gates read no key
    assert torch.equal(ctx.not_(a).data, -a.data)


def test_unknown_and_unported_backends(keyed_bits):
    """The key lifecycle takes the names Context takes: the exact backends
    ("conv" and "toeplitz" name the blind rotation's one key form) and
    ntt, whose key form is released, prepared and reinitialized on its
    own; an unknown name is refused."""
    sk, ek, bits0, bits1, a, b = keyed_bits
    ctx = Context(ek, device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        ctx.release_keys(("definitely-not-a-backend",))
    with pytest.raises(ValueError, match="unknown backend"):
        ctx.prepare_backend(ek, "definitely-not-a-backend")
    ctx.release_keys(("ntt",))               # never built: nothing to free
    assert ctx.keys.bk_ext.numel() > 0 and ctx.keys.bk_ntt.numel() == 0
    ctx.prepare_backend(ek, "ntt")           # builds it and switches to it
    assert ctx.backend == "ntt" and ctx.keys.bk_ntt.numel() > 0
    via_ntt = ctx.nand(a, b)
    assert np.array_equal(decrypt_bits(via_ntt, sk), _nand_ref(bits0, bits1))
    ctx.release_keys(("ntt",))
    with pytest.raises(ValueError, match="bk_ntt was released"):
        ctx.nand(a, b)                       # no silent exact path
    ctx.reinitialize(ek, "ntt")
    assert ctx.keys.bk_ext.numel() == 0 and ctx.keys.bk_ntt.numel() > 0
    assert torch.equal(ctx.nand(a, b).data, via_ntt.data)
    ctx.reinitialize(ek)
    assert ctx.keys.bk_ext.numel() > 0       # the exact path again
    ctx.release_keys(("conv",))
    assert ctx.keys.bk_ext.numel() == 0 and ctx.keys.sei_perm.numel() > 0
    ctx.prepare_backend(ek, "toeplitz")
    assert ctx.keys.bk_ext.numel() > 0 and ctx.backend == "toeplitz"
    sk2 = JG.keygen(JP.TINY_K2, seed=2)
    with pytest.raises(ValueError, match="reinitialize"):
        ctx.prepare_backend(JG.make_eval_key(sk2, seed=3))


def test_reinitialize_preset_swap(keyed_bits, tiny_k2_key):
    sk, ek, bits0, bits1, a, b = keyed_bits
    ctx = Context(ek, device="cpu")
    before = ctx.nand(a, b)
    sk2, ek2 = tiny_k2_key
    ctx.reinitialize(ek2)
    assert ctx.params is ek2.params and ctx.device.type == "cpu"
    rng = np.random.default_rng(8)
    b0, b1 = rng.integers(0, 2, 8), rng.integers(0, 2, 8)
    x = encrypt_bits(b0, sk2, np.random.default_rng(9), device="cpu")
    y = encrypt_bits(b1, sk2, np.random.default_rng(10), device="cpu")
    out = ctx.nand(x, y)
    assert np.array_equal(decrypt_bits(out, sk2), _nand_ref(b0, b1))
    assert np.array_equal(to_u32(out.data), np.stack(
        [JG.gate_lvl0("nand", u, v, ek2)
         for u, v in zip(to_u32(x.data), to_u32(y.data))]))
    ctx.reinitialize(ek, backend="pallas")   # and back
    assert torch.equal(ctx.nand(a, b).data, before.data)


# -- key and ciphertext files ---------------------------------------------

def test_params_fingerprints_equal_original():
    """Key files name their preset and fingerprint it; the port's copy
    stamps the same fingerprint as the JAX package for every preset."""
    assert sorted(P.PRESETS) == sorted(JP.PRESETS)
    for name, p in P.PRESETS.items():
        assert S.params_fingerprint(p) == JS.params_fingerprint(
            JP.PRESETS[name]), name


def test_key_files_roundtrip_and_interchange(tmp_path, tiny_key):
    sk, ek = tiny_key
    for save, load in ((S.save_eval_key, S.load_eval_key),
                       (S.save_eval_key, JS.load_eval_key),
                       (JS.save_eval_key, S.load_eval_key)):
        path = str(tmp_path / "ek.npz")
        save(path, ek)
        ek2 = load(path)
        assert ek2.params.name == ek.params.name
        assert np.array_equal(ek2.bk, ek.bk)
        assert np.array_equal(ek2.ksk, ek.ksk)
    path = str(tmp_path / "sk.npz")
    S.save_secret_key(path, sk)
    sk2 = S.load_secret_key(path)
    assert sk2.params == P.PRESETS[sk.params.name]
    assert np.array_equal(sk2.lvl0, sk.lvl0)
    assert np.array_equal(sk2.lvl1, sk.lvl1)


def test_fingerprint_mismatch_rejected(tmp_path, tiny_key):
    _, ek = tiny_key
    path = str(tmp_path / "ek.npz")
    np.savez_compressed(path, kind="eval", params=ek.params.name,
                        fingerprint="0" * 16, bk=ek.bk, ksk=ek.ksk)
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        S.load_eval_key(path)


def test_server_without_secret_key(tmp_path, tiny_key):
    """A server process that only sees the eval-key file evaluates gates on
    ciphertexts the client serialized, and the client decrypts them."""
    sk, ek = tiny_key
    ekp, ctp = str(tmp_path / "ek.npz"), str(tmp_path / "ct.npz")
    S.save_eval_key(ekp, ek)
    bits = np.array([0, 1, 1, 0])
    rng = np.random.default_rng(11)
    S.save_ciphertexts(ctp, to_u32(encrypt_bits(bits, sk, rng,
                                                device="cpu").data), 0)
    data, level = S.load_ciphertexts(ctp)
    assert level == 0
    ctx = Context(S.load_eval_key(ekp), device="cpu")
    from cufhe_tpu_torch.models.api import Ctxt
    ct = Ctxt(from_u32(data, "cpu"), level)
    out = ctx.nand(ct, ct)
    assert np.array_equal(G.decrypt_bit_batch(to_u32(out.data), sk),
                          1 - bits)


def test_time_fn_and_trace_on_the_cpu(tmp_path):
    x = torch.arange(1000)
    t = timing.time_fn(lambda v: v * 2, x, iters=3, device="cpu")
    assert 0 <= t < 1
    path = tmp_path / "trace.json"
    with timing.trace(str(path), cuda=False):
        (x * 3).sum()
    assert path.stat().st_size > 0
