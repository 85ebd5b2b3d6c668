"""The port's bench surface on the CPU against the JAX package: the bench
key cache (files shared with cufhe_tpu.utils.serialization both ways, a
stale fingerprint regenerated), golden_check.golden_diff (no mismatch on an
intact key, the JAX check's word count, a mismatch on a flipped key bit),
every suite section at TINY (0 errors, the JAX suite's record keys), and
phase_breakdown's phase functions bit for bit against the JAX ops they
replace, composing to gate_lvl0. The entry points need CUDA: without it
they exit 2."""
import ast
import importlib.util
import json
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cufhe_tpu import golden as JG
from cufhe_tpu import params as JP
from cufhe_tpu.models import api as JA
from cufhe_tpu.ops import bootstrap as JB
from cufhe_tpu.ops import keys as JK
from cufhe_tpu.ops import keyswitch as JKS
from cufhe_tpu.utils import serialization as JS
from cufhe_tpu_torch import Context
from cufhe_tpu_torch.benchmarks import _common as C
from cufhe_tpu_torch.benchmarks import golden_check as GC
from cufhe_tpu_torch.benchmarks import phase_breakdown as PB
from cufhe_tpu_torch.benchmarks import suite as SU
from cufhe_tpu_torch.golden import GATE_CONSTANTS
from cufhe_tpu_torch.ops import bootstrap as TB
from cufhe_tpu_torch.ops import keys as TK
from cufhe_tpu_torch.torus import to_u32

REPO = pathlib.Path(__file__).resolve().parent.parent


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
def tiny():
    sk = JG.keygen(JP.TINY, seed=60)
    ek = JG.make_eval_key(sk, seed=61)
    return sk, ek, Context(ek, device="cpu")


@pytest.fixture
def key_dir(tmp_path, monkeypatch):
    """The key cache and the results file in tmp_path, not the tree."""
    monkeypatch.setattr(C, "KEY_DIR", str(tmp_path))
    monkeypatch.setattr(C, "RESULTS", str(tmp_path / "results.jsonl"))
    return tmp_path


def _same_keys(sk, ek, sk2, ek2):
    # the two packages' GateParams are distinct classes of equal fields
    assert repr(sk.params) == repr(sk2.params) == repr(ek.params) \
        == repr(ek2.params)
    for x, y in ((sk.lvl0, sk2.lvl0), (sk.lvl1, sk2.lvl1), (ek.bk, ek2.bk),
                 (ek.ksk, ek2.ksk)):
        assert np.array_equal(x, y)


# -- the key cache -------------------------------------------------------------

def test_key_cache_names_are_the_jax_caches(key_dir):
    assert C.key_cache_paths("tfhepp_128bit") == (
        str(key_dir / ".bench_keys_128.npz"),
        str(key_dir / ".bench_sk_128.npz"))
    assert C.key_cache_paths("cggi19") == (
        str(key_dir / ".bench_keys_cggi19.npz"),
        str(key_dir / ".bench_sk_cggi19.npz"))


def test_key_cache_files_are_read_by_the_jax_package(key_dir):
    """A miss generates from seeds 0 and 1 and saves; the JAX loader reads
    the files, and a second call reads them back."""
    name = JP.TINY.name
    sk, ek = C.load_or_make_bench_keys(name)
    jsk = JG.keygen(JP.TINY, seed=0)
    _same_keys(sk, ek, jsk, JG.make_eval_key(jsk, seed=1))
    cache, sk_cache = C.key_cache_paths(name)
    _same_keys(sk, ek, JS.load_secret_key(sk_cache), JS.load_eval_key(cache))
    _same_keys(sk, ek, *C.load_or_make_bench_keys(name))


def test_key_cache_reads_files_the_jax_package_wrote(key_dir):
    """Files the JAX serializer wrote (from other seeds) are used as they
    are, not regenerated."""
    name = JP.TINY_K2.name
    jsk = JG.keygen(JP.TINY_K2, seed=5)
    jek = JG.make_eval_key(jsk, seed=6)
    cache, sk_cache = C.key_cache_paths(name)
    JS.save_eval_key(cache, jek)
    JS.save_secret_key(sk_cache, jsk)
    _same_keys(*C.load_or_make_bench_keys(name), jsk, jek)


def test_key_cache_regenerates_a_stale_fingerprint(key_dir, capsys):
    name = JP.TINY.name
    cache, sk_cache = C.key_cache_paths(name)
    jsk = JG.keygen(JP.TINY, seed=5)
    JS.save_secret_key(sk_cache, jsk)
    JS.save_eval_key(cache, JG.make_eval_key(jsk, seed=6))
    z = dict(np.load(cache))
    z["fingerprint"] = np.array("0" * 16)      # as if other gadget values
    np.savez_compressed(cache, **z)
    sk, ek = C.load_or_make_bench_keys(name)
    assert "stale key cache" in capsys.readouterr().err
    want = JG.keygen(JP.TINY, seed=0)
    _same_keys(sk, ek, want, JG.make_eval_key(want, seed=1))
    _same_keys(sk, ek, JS.load_secret_key(sk_cache), JS.load_eval_key(cache))


def test_append_result_writes_json_lines(key_dir):
    C.append_result({"a": 1})
    C.append_result({"b": [2.5]})
    lines = (key_dir / "results.jsonl").read_text().splitlines()
    assert [json.loads(s) for s in lines] == [{"a": 1}, {"b": [2.5]}]


# -- golden_check --------------------------------------------------------------

def _jax_bench(name):
    """A module of the JAX package's benchmarks/ by file, under its own
    name."""
    spec = importlib.util.spec_from_file_location(
        f"jax_bench_{name}", REPO / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_golden_diff_matches_and_counts_as_the_jax_check(tiny):
    sk, ek, ctx = tiny
    mism, total = GC.golden_diff(ctx, sk, ek, np.random.default_rng(23),
                                 nb=3)
    jmism, jtotal = _jax_bench("golden_check").golden_diff(
        JA.Context(ek, backend="conv"), sk, ek, np.random.default_rng(23),
        nb=3)
    assert (mism, total) == (0, jtotal) and jmism == 0
    assert total == 3 * (JP.TINY.lvl0.dim + 1) * (len(GC.GATES) + 1)


def test_golden_diff_sees_one_flipped_key_bit(tiny):
    sk, ek, _ = tiny
    ctx = Context(ek, device="cpu")
    # bit 26 of one coefficient of bk itself (top limb, second half of the
    # generator) on step 1's body row, which every gate's product reads
    ctx.keys.bk_ext[1, -1, 0, 3, JP.TINY.lvl1.n + 3] ^= 4
    mism, total = GC.golden_diff(ctx, sk, ek, np.random.default_rng(23),
                                 nb=3)
    assert 0 < mism <= total


# -- the suite -------------------------------------------------------------------

def _jax_report_keys():
    """The record keys of the JAX suite's report(), read from its source."""
    tree = ast.parse((REPO / "benchmarks" / "suite.py").read_text())
    report = next(n for n in ast.walk(tree)
                  if isinstance(n, ast.FunctionDef) and n.name == "report")
    keys = set()
    for node in ast.walk(report):
        if isinstance(node, ast.Dict):
            keys |= {k.value for k in node.keys}
        elif (isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Store)
              and isinstance(node.value, ast.Name) and node.value.id == "rec"):
            keys.add(node.slice.value)
    return keys


@pytest.mark.parametrize("section", SU.SECTIONS)
def test_suite_section_on_the_cpu(tiny, section):
    sk, ek, ctx = tiny
    run = SU.Run(ctx, sk, ek, batch=16, iters=1, device="cpu")
    assert SU.run_sections(run, [section]) == 0
    assert run.results and not run.margin_fail
    jax_keys = _jax_report_keys()
    for rec in run.results:
        assert rec["section"] == section and rec["device"] == "cpu"
        if section == "noise":
            assert "margin_floor_sigmas" in rec
            assert rec.get("xor_of_bootstrapped_errors", 0) == 0
            continue
        assert rec["errors"] == 0, rec
        assert set(rec) == jax_keys - ({"level"} if "level" not in rec
                                       else set()), rec


def test_suite_refuses_unknown_sections(tiny):
    sk, ek, ctx = tiny
    with pytest.raises(ValueError, match="unknown sections"):
        SU.run_sections(SU.Run(ctx, sk, ek, 8, 1, "cpu"), ["gates", "nope"])


# -- phase_breakdown ----------------------------------------------------------

@pytest.mark.parametrize("params", [JP.TINY, JP.TINY_K2],
                         ids=lambda p: p.name)
def test_phase_functions_match_the_jax_phases(params):
    sk = JG.keygen(params, seed=70)
    ek = JG.make_eval_key(sk, seed=71)
    keys = TK.prepare_keys(ek, "cpu")
    jkeys = JK.prepare_keys(ek, backends=("conv",))
    a, b = PB.random_inputs(params, 6, "cpu")
    ja, jb = jnp.asarray(to_u32(a)), jnp.asarray(to_u32(b))

    ca, cb, off = JB._gate_coeffs(GATE_CONSTANTS["nand"], params.lvl0.mu)
    aa, bb = JB._pre_add(ja, jb, ca, cb, off, params.lvl0.dim)
    jacc = JB.blind_rotate(aa, bb, params.lvl1.mu, jkeys, params, "conv")
    jt1 = JB.sample_extract_for_ks(jacc, params.lvl1)
    jks = JKS.key_switch(jt1, jkeys.ksk_limbs_sei, params)

    acc = PB.blind_rotate_only(a, b, keys, params)
    assert np.array_equal(to_u32(acc), np.asarray(jacc))
    out = PB.extract_ks_only(acc, keys, params)
    assert np.array_equal(to_u32(out), np.asarray(jks))
    # the phases compose to the gate
    assert torch.equal(PB.full_nand(a, b, keys, params), out)
    assert torch.equal(TB.gate_lvl0(GATE_CONSTANTS["nand"], a, b, keys,
                                    params), out)
    assert PB.null(a, b, keys, params) is a


def test_breakdown_record_on_the_cpu():
    sk = JG.keygen(JP.TINY, seed=72)
    keys = TK.prepare_keys(JG.make_eval_key(sk, seed=73), "cpu")
    rec = PB.breakdown(keys, JP.TINY, 8, device="cpu")
    assert set(rec) == {"batch", "null_ms", "full_nand_ms",
                        "blind_rotate_ms", "extract_ks_ms"}
    assert rec["batch"] == 8 and all(v >= 0 for v in rec.values())


# -- the entry points need the card -------------------------------------------

@pytest.mark.parametrize("mod", [SU, GC, PB], ids=["suite", "golden_check",
                                                   "phase_breakdown"])
def test_entry_points_exit_2_without_cuda(mod, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", [mod.__name__])
    with pytest.raises(SystemExit) as exc:
        mod.main()
    assert exc.value.code == 2
