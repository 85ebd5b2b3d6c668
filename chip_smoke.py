#!/usr/bin/env python3
"""Smoke test of the PyTorch port (cufhe_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure:
  1. the card's name and power limit (nvidia-smi);
  2. build of the CUDA kernels from csrc/ (nvcc, sm_90a, one process per
     source), timed, with ptxas's registers and spills per kernel (a spill,
     a missing kernel or instance, ptxas's C7508 warning, setmaxnreg
     ignored, or its note that it serialised wgmma fails the phase);
  3. the blind-rotation kernels against their plain PyTorch version, bit
     for bit, on random accumulators (1, 8, 65 and 129 rows: 1 and 65
     split the product's contraction across blocks) at ten parameter
     sets, every published preset among them: the whole rotation, and the
     rotate-and-decompose kernel alone (rotdec_cuda against rotdec_ref,
     rotations 0, N-1, N and 2N-1 among the rows);
  4. Context(ek).nand (keys on the card) on the four input pairs at
     tfhepp_128bit
     against the port's NumPy gate oracle golden.gate_lvl0, as uint32;
  5. the main path: encrypt -> a chain of lvl0 NANDs on device-resident
     outputs at batch 4096, tfhepp_128bit -> decrypt, with 0 decrypt
     errors, one rotation launch, n0 rotate-and-decompose launches and
     one key switch launch per gate; gates/s;
  6. one blind rotation at the main path's shape through the kernels and
     through the plain version: equal, and both timed with CUDA events;
     the kernels' int8 TMAC/s, their bound on the card, and one
     torch._int_mm at the product's step shape times n0 as a yardstick
     (the port never calls it); the rotate-and-decompose kernel alone at
     the main path's shape and at batch 1 (benchmarks.rotdec.measure: the
     median of ROTDEC_LAUNCHES launches, warm and after an L2 flush), its
     GB/s and its bytes bound, and its plain version's time; the key
     switch kernel on the context's KSK at the main path's 4096 rows and
     an AES step's 160, bit for bit against its plain version
     (key_switch_ref), then alone at both row counts
     (benchmarks.keyswitch.measure: held against key_switch_ref on a
     random KSK, then the median of KS_LAUNCHES launches, warm and after
     an L2 flush) beside its bound and its plain version;
  7. both tensor-core probe kernels, wgmma (csrc/mxu_peak_wgmma.cu) and
     mma.sync (csrc/mxu_peak.cu), against their plain version, bit for
     bit: all four variants at the small shape, pure and place at the full
     S = 18 shape; then the probe's path (benchmarks.mxu_peak.run_probe:
     library rows, wgmma rows and two mma.sync rows, each beside its plain
     version, CUDA events), counted per kernel;
  8. the bootstrapping paths at tiny presets on the card, equal as uint32
     to golden: lvl1 gates, mux/nmux at both levels, gate_rows,
     gate_chain, cmux, refresh, programmable_bootstrap, pbs_many;
  9. the same paths at full width (tfhepp_128bit, batch 4096, ciphertexts
     on the device): 0 decrypt errors, equality with golden on 2 rows
     (computed in worker processes while the card runs), one kernel
     launch per blind rotation; gates/s of the lvl1 NAND and the mux;
 10. one lvl0 NAND at batch 4096 under torch.profiler: device time and
     launches of the product kernel, rotdec_kernel and the key switch (one
     keyswitch_kernel launch, no library GEMM), and the device's idle
     share, with rotdec_kernel's time a launch against its bound;
 11. every other published preset (tfhepp_128bit_bg8, tfhepp_80bit,
     cggi19, concrete, radix4_2048; phase 3 holds the kernel against its
     plain version there): a lvl0 NAND at batch 4096 with 0 decrypt
     errors, golden equality on one row (worker processes), one launch;
     gates/s;
 12. circuits at tfhepp_128bit through runtime.run_schedule: an 8-bit
     ripple adder equal as uint32 to the same gates called one by one on
     the Context, and AES-128 at batch 8 with every block checked against
     the plaintext cipher, launches equal to the plan; blocks/s, effective
     bootstraps/s, peak device memory;
 13. streams: dependent NAND chains interleaved on two runtime.Streams and
     the default stream with no explicit synchronise, equal as uint32 to
     the same chain on the default stream alone; per-gate latency at
     batch 1 over a 20-deep chain, and one such gate under torch.profiler;
 14. the key lifecycle: release_keys frees the key bytes (memory_allocated),
     a gate then raises ValueError, prepare_backend restores them and the
     gate is bit-exact again, reinitialize to concrete runs a correct NAND
     (run last: it swaps the context's preset);
 15. encrypted integers (models.integers.IntContext, msg_bits 1) on phase
     4's context: a 32-bit add at batch 4096 with 0 word errors and one
     launch per digit (adds/s, rotations/s); at batch 256 a 16-bit
     sub_full, eq and select(ge(x, y), x, y), an 8-bit mul and divmod_,
     each checked against plain integers with launches equal to the count
     worked out from the code; row 0 of an 8-bit add equal as uint32 to a
     ripple of 8 golden.pbs_many calls (phase 9's worker pool, while the
     card works);
 16. the TOY8 processor (models.processor): 64 lanes of random programs
     for 2 cycles through run_cycles in the loop and the scan mode, equal
     to each other as uint32, 0 lane errors against interpret, launches
     equal to the plan times the cycles; lane-cycles/s, bootstraps/s;
 17. the ntt backend (Context(ek, "ntt"), torch ops, no K1 launch): a NAND
     on the card equal as uint32 to the CPU at TINY, TINY_K2, PALLAS_BG10
     and tfhepp_128bit; at batch 4096 on phase 5's inputs, 0 decrypt
     errors, gates/s, peak memory and the phase distance to the exact
     path; its key lifecycle;
 18. the mesh on one card: phase 5's chain on data_mesh() and on two
     shards of cuda:0, equal as uint32, one launch per shard per gate; on
     two shards the ripple adder, an 8-bit IntContext.add and a
     run_schedule_loop circuit equal to the plain context; no second key
     set; the meshes' gates/s as a share of phase 5's (17 and 18 run
     before 14);
 19. the bench surface (benchmarks.golden_check, suite, phase_breakdown)
     and the examples, on phase 4's context (run after 15, while phase
     9's worker pool is up): golden_diff at tfhepp_128bit with 0
     mismatched words (the oracle in the pool), every other suite section
     at batch 256 with 0 errors and every margin above its floor, the
     phase breakdown at batch 4096, and each of the six examples at TINY
     plus 01_gates.py --full run in this process, each printing its
     success line; the kernel's launches of the phase are counted;
 20. the reduced-precision pallas3 path (run after 18): the three-limb
     instance of the product kernel against the plain version bit for
     bit at PALLAS_TINY, PALLAS_TINY_K2, PALLAS_BG10 (N = 128) and
     PALLAS_KAR, PALLAS_BG10_KAR (N = 512), 8 and 129 rows, and at
     tfhepp_128bit and tfhepp_80bit (129 and 4096 rows); each instance's
     warpgroup MMAs (IGMMA) and warp-level MMAs (IMMA) in the SASS
     (cuobjdump, which must run: no IMMA anywhere, and three limbs issue
     3/4 of four's IGMMA a stage); both key
     precisions timed in turns at the main path's shape
     (benchmarks/rotation.py); phase 5's chain on Context(ek, "pallas3") with 0 decrypt errors, the
     three-limb instance launched once a gate and the exact one never;
     one pallas3 NAND under torch.profiler (one keyswitch_kernel launch,
     no library GEMM); the noise std and margins at
     batch 2048 (benchmarks/noise.py) beside the JAX record;
 21. the persistent rotation (one cooperative launch of
     persistent_extprod_kernel a rotation, where ops.blind_rotate.
     rotation_plan takes it: the batches too small to fill the card) at
     every published preset and 1, 48, 160 and 480 rows, equal as uint32
     to the plain version and to the loop of 2 n0 launches on 20 fresh
     inputs each, with one persistent launch of one row-tile group a
     64-row tile and no rotdec launch a rotation; one AES-128 block at
     batch 1 (the aes128_b1 cell's shape) right, all 257 rotations
     persistent, 833 row-tile groups; the loop and the persistent kernel
     timed a step at tfhepp_128bit from 1 to 2048 rows
     (benchmarks.rotation.measure_paths). Phase 5's NAND chain at batch
     4096 takes the loop: no persistent launch, no group;
 22. the MUX at cggi19 (Karatsuba depth 1, the mux_b4096.cggi19 cell's
     path and width): Context.mux and nmux at batch 4096 on keys and inputs
     that fhebench/reference made from a seed, equal as uint32 to
     fhebench/reference/mux.py and decrypting to the cleartext MUX; two
     depth-1 rotations on the loop and one key switch a MUX, one `mux`
     count of 4096 rows.

Prints the card line, a {"kernels": [...]} line (blind_rotate, rotdec,
key_switch, mxu_peak, mxu_peak_wgmma, blind_rotate_pallas3,
blind_rotate_persistent), and as the last
line {"ok": true, "device": {...}}. Exits non-zero without a CUDA device.
The client side (keygen, encrypt, decrypt) and the oracle are the port's
NumPy module cufhe_tpu_torch.golden; neither JAX nor the JAX package is
imported.
"""
import json
import multiprocessing
import os
import statistics
import sys
import time
from concurrent.futures import ProcessPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
BATCH = 4096
ITERS = 4
REPS = 2
SOURCE = "cufhe_tpu_torch/csrc/blind_rotate.cu"
REPLACES = "cufhe_tpu/ops/pallas_br.py:762"
#: the Pallas kernel's rotate-and-decompose closure
ROTDEC_REPLACES = "cufhe_tpu/ops/pallas_br.py:428"
#: launches of rotdec_kernel timed alone (the median is reported)
ROTDEC_LAUNCHES = 25
KS_SOURCE = "cufhe_tpu_torch/csrc/keyswitch.cu"
#: the JAX package's key switch, which XLA compiles (no TPU kernel)
KS_REPLACES = "cufhe_tpu/ops/keyswitch.py:50"
#: launches of keyswitch_kernel timed alone, and the rows of a median AES
#: step beside the main path's BATCH
KS_LAUNCHES = 25
KS_AES_ROWS = 160
#: the product kernel's instances, extprod_kernel<NL, SEG, D>: four limbs
#: at N >= 128, 64 and 32; three limbs at N >= 128; four limbs at
#: Karatsuba depths 1 and 2 (leaves of >= 128 coefficients)
EXTPROD_INSTANCES = ("extprod_kernel<4, 128, 0>", "extprod_kernel<4, 64, 0>",
                     "extprod_kernel<4, 32, 0>", "extprod_kernel<3, 128, 0>",
                     "extprod_kernel<4, 128, 1>", "extprod_kernel<4, 128, 2>")
#: the persistent rotation's instances, persistent_extprod_kernel<NL, SEG,
#: D, L, ND>: each product instance with rotdec's generic digit loops, and
#: the two published sets' own (l, nd) unrolled
PERSISTENT_INSTANCES = tuple(
    f"persistent_{name[:-1]}, 0, 0>" for name in EXTPROD_INSTANCES) + (
    "persistent_extprod_kernel<4, 128, 2, 3, 1>",
    "persistent_extprod_kernel<4, 128, 0, 2, 1>")
#: phase 21: the rows held at every published preset, fresh inputs a case,
#: the levels of an AES-128 block and the rows timed a step
PERSIST_ROWS = (1, 48, 160, 480)
PERSIST_REPS = 20
AES_LEVELS = 257
#: the 64-row tiles of those levels at batch 1: the persistent kernel's
#: row-tile groups an AES block
AES_TILES = 833
PATHS_ROWS = (1, 48, 160, 480, 2048)
PROBE_SOURCE = "cufhe_tpu_torch/csrc/mxu_peak.cu"
WGMMA_SOURCE = "cufhe_tpu_torch/csrc/mxu_peak_wgmma.cu"
PROBE_REPLACES = "benchmarks/mxu_peak.py:116"
#: rows of each full-width result held against golden (seconds each)
GOLDEN_ROWS = (0, BATCH - 1)
WORKERS = 6
#: the device of phases 8, 9, 15, 16 and 20
DEV = "cuda"
#: phase 20's sets and rows held to the plain version at three limbs
PALLAS3_SETS = (("pallas-tiny-insecure-test", (8, 129)),
                ("pallas-tiny-k2-insecure-test", (8, 129)),
                ("pallas-bg10-insecure-test", (8, 129)),
                ("pallas-kar-insecure-test", (8, 129)),
                ("pallas-bg10-kar-insecure-test", (8, 129)),
                ("tfhepp_128bit", (129, BATCH)),
                ("tfhepp_80bit", (129, BATCH)))
MIXED = ("nand", "xor", "andyn", "orny")
#: phase 11's presets (phase 3 also holds the kernel to its plain version
#: at each)
FULL_PRESETS = ("tfhepp_128bit_bg8", "tfhepp_80bit", "cggi19", "concrete",
                "radix4_2048")
#: phase 12's AES batch and phase 13's stream chains
AES_BATCH = 8
STREAM_BATCH = 256
STREAM_DEPTH = 6
LATENCY_DEPTH = 20
#: phase 15's full-width word size and its narrow batch; phase 16's lanes
#: and cycles
INT_BITS = 32
INT_BATCH = 256
TOY8_LANES = 64
TOY8_CYCLES = 2
#: phase 19: golden samples, the suite's batch, and each example with the
#: success line of its JAX twin (tests/test_examples.py)
SURFACE_SAMPLES = 2
SURFACE_BATCH = 256
EXAMPLES = (
    ("01_gates.py", (), "all 192 decryptions correct"),
    ("01_gates.py", ("--full",), "all 192 decryptions correct"),
    ("02_adder_and_netlists.py", (), "additions OK"),
    ("03_server_client_split.py", (), "all decryptions correct"),
    ("04_encrypted_processor.py", (),
     "all encrypted program runs match the plaintext interpreter"),
    ("05_encrypted_lookup.py", (), "all encrypted lookups correct"),
    ("06_encrypted_integers.py", (), "all encrypted integer results correct"),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def u32_max_abs_err(x, y) -> int:
    import numpy as np
    from cufhe_tpu_torch.torus import to_u32
    d = to_u32(x).astype(np.int64) - to_u32(y).astype(np.int64)
    return int(np.abs(d).max()) if d.size else 0


def cuda_ms(fn, n: int = 1):
    """Run fn n times between two CUDA events; (last result, ms per run)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / n


def ptxas_report(log_text: str):
    """(kernel, registers, spill line) for each entry function in nvcc's
    build log (-Xptxas -v)."""
    import re
    out, name, spills = [], None, ""
    for line in log_text.splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            k = re.search(r"([a-z_]+_kernel)(I((?:Li\d+E)+)E)?", m.group(1))
            args = ", ".join(re.findall(r"Li(\d+)E", k.group(3) or "")
                             ) if k else ""
            name = (f"{k.group(1)}<{args}>" if args
                    else k.group(1) if k else m.group(1))
            spills = ""
        elif name and "spill" in line:
            spills = line.split(",", 1)[1].strip()
        elif name and "registers" in line:
            out.append((name, int(re.search(r"Used (\d+) registers",
                                             line).group(1)), spills))
            name = None
    return out


def ptxas_warnings(log_text: str) -> list:
    """ptxas's warning lines in nvcc's build log, and its notes that it
    serialised wgmma (C7510/C7511, printed as info)."""
    return [line.strip() for line in log_text.splitlines()
            if line.lstrip().startswith("ptxas")
            and ("warning" in line or "Performance Loss" in line)]


# -- golden jobs for worker processes (phase 9) ------------------------------
_EK = None


def _pool_init(ek) -> None:
    global _EK
    _EK = ek
    # phase 19's golden_diff reads the key of golden_check's own jobs
    from cufhe_tpu_torch.benchmarks import golden_check
    golden_check.pool_init(ek)


def _g_gate(level: int, name: str, x, y):
    from cufhe_tpu_torch import golden as G
    fn = G.gate_lvl0 if level == 0 else G.gate_lvl1
    return fn(name, x, y, _EK)


def _g_chain(names, x, y):
    from cufhe_tpu_torch import golden as G
    for nm in names:
        x = G.gate_lvl0(nm, x, y, _EK)
    return x


def _g_mux(c, x, y):
    from cufhe_tpu_torch import golden as G
    return G.mux_lvl0(c, x, y, _EK)


def _g_pbs_many(ct, tv, J: int, theta: int):
    from cufhe_tpu_torch import golden as G
    return G.pbs_many(ct, tv, J, _EK, theta=theta)


def _g_b2t_refresh(ct):
    """bootstrap_tlwe2trlwe -> refresh -> sei_and_ks of one lvl0 row."""
    from cufhe_tpu_torch import golden as G
    tr = G.bootstrap_tlwe2trlwe(ct, _EK.params.lvl1.mu, _EK)
    rf = G.refresh(tr, _EK)
    return tr, rf, G.sei_and_ks(rf, _EK)


def _g_add_ripple(xd, yd, tv):
    """An 8-bit encrypted add of one row through golden.pbs_many: per
    digit, one rotation of x_d + y_d + carry gives (sum digit, carry).
    Returns the sum digits [D, n0+1] uint32 (phase 15)."""
    import numpy as np
    from cufhe_tpu_torch import golden as G
    c = np.zeros(xd.shape[1], dtype=np.uint32)
    sums = []
    for a, b in zip(xd, yd):
        sc = G.pbs_many(a + b + c, tv, 2, _EK, theta=1)
        sums.append(sc[0])
        c = sc[1]
    return np.stack(sums)


def _g_nand_with(ek, x, y):
    """One lvl0 NAND row under an eval key of its own (phase 11)."""
    from cufhe_tpu_torch import golden as G
    return G.gate_lvl0("nand", x, y, ek)


def timed(what: str, rotations: int, fn):
    """fn() with the blind-rotation launch count zeroed just before and
    read just after, on the host clock to a synchronise; raises unless
    the kernel was launched `rotations` times. Returns (out, seconds)."""
    import torch
    from cufhe_tpu_torch.utils.spans import counts
    torch.cuda.synchronize()
    before = counts()["blind_rotate"]
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launched = counts()["blind_rotate"] - before
    if launched != rotations:
        raise AssertionError(f"{what}: {launched} kernel launches, want "
                             f"{rotations}")
    return out, dt


def phase_presets(eks: dict, tag: str) -> dict:
    """11. A lvl0 NAND at batch 4096 at each of FULL_PRESETS: 0 decrypt
    errors, row 0 equal to golden (worker processes, while the card
    works), one launch per gate; gates/s over two reps. Each context's
    keys are released before the next preset's are prepared."""
    import numpy as np
    import torch
    import cufhe_tpu_torch as T
    from cufhe_tpu_torch import golden as G
    from cufhe_tpu_torch.torus import from_u32, to_u32
    from cufhe_tpu_torch.benchmarks.rotation import bound, rotation_work

    rng = np.random.default_rng(14)
    inputs, gold, row0, rates = {}, {}, {}, {}
    spawn = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(len(FULL_PRESETS), mp_context=spawn) as pool:
        for name in FULL_PRESETS:
            sk, ek = eks[name]
            bits = [rng.integers(0, 2, BATCH) for _ in range(2)]
            host = [G.encrypt_bit_batch(b, sk, rng) for b in bits]
            inputs[name] = (bits, host)
            gold[name] = pool.submit(_g_nand_with, ek, host[0][0],
                                     host[1][0])
        for name in FULL_PRESETS:
            sk, ek = eks[name]
            (bits0, bits1), (h0, h1) = inputs[name]
            ctx = T.Context(ek)
            a, b = (T.Ctxt(from_u32(h, DEV), 0) for h in (h0, h1))
            torch.cuda.reset_peak_memory_stats()
            out, dt = timed(f"nand at {name}", 1, lambda: ctx.nand(a, b))
            _, dt2 = timed(f"nand at {name}", 1, lambda: ctx.nand(a, b))
            errors = int(np.sum(T.decrypt_bits(out, sk)
                                != 1 - (bits0 & bits1)))
            rates[name] = BATCH / statistics.median((dt, dt2))
            macs, nbytes = rotation_work(ek.params, BATCH)
            bound_ms, bound_by = bound(2 * macs, nbytes)
            gate_ms = 1e3 * BATCH / rates[name]
            log(f"preset {name}: lvl0 nand at batch {BATCH}, decrypt errors "
                f"{errors}, 1 kernel launch per gate; {rates[name]:.2f} "
                f"gates/s (reps {dt * 1e3:.1f}, {dt2 * 1e3:.1f} ms per batch;"
                f" {macs / gate_ms / 1e9:.1f} int8 TMAC/s over the gate, "
                f"rotation bound {bound_ms:.1f} ms ({bound_by}), "
                f"{100 * bound_ms / gate_ms:.1f} % of it), peak memory "
                f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB {tag}")
            if errors:
                raise AssertionError(f"nand at {name}: {errors} decrypt "
                                     f"errors")
            row0[name] = to_u32(out.data[:1])[0]
            ctx.release_keys()
            del ctx, a, b, out
        t0 = time.perf_counter()
        for name in FULL_PRESETS:
            if not np.array_equal(row0[name], gold[name].result()):
                raise AssertionError(f"nand at {name}: row 0 disagrees with "
                                     f"golden")
    log(f"presets {', '.join(FULL_PRESETS)}: row 0 of each nand equal to "
        f"golden.gate_lvl0 as uint32 (waited {time.perf_counter() - t0:.1f}"
        f" s for the workers)")
    return rates


def phase_circuits(ctx, sk, gate_rate: float, tag: str) -> None:
    """12. runtime.run_schedule at tfhepp_128bit: an 8-bit ripple adder
    equal as uint32 to its gates called one by one on the Context, then
    AES-128 at AES_BATCH with every block checked; launches equal to the
    plan's rotations. Returns the adder's (schedule, inputs, outputs)."""
    import numpy as np
    import torch
    import cufhe_tpu_torch as T
    from cufhe_tpu_torch.benchmarks import aes
    from cufhe_tpu_torch.runtime import build_ripple_adder, run_schedule
    from cufhe_tpu_torch.runtime import executor as EX

    nbits, batch = 8, STREAM_BATCH
    sched = build_ripple_adder(nbits)[0].compile()
    rng = np.random.default_rng(15)
    x, y = (rng.integers(0, 1 << nbits, batch) for _ in range(2))
    cin = rng.integers(0, 2, batch)
    bits = ([(x >> i) & 1 for i in range(nbits)]
            + [(y >> i) & 1 for i in range(nbits)] + [cin])
    cts = [T.encrypt_bits(b, sk, rng) for b in bits]
    planned = EX.plan_rotations(EX.schedule_steps(ctx, sched, batch))
    torch.cuda.reset_peak_memory_stats()
    outs, dt = timed("ripple adder", planned,
                     lambda: run_schedule(ctx, sched, cts))
    vals = dict(zip(sched.inputs, cts))
    for groups in sched.levels:
        for op, quads in groups:
            for q in quads:
                vals[q[0]] = ctx.gate(op, vals[q[1]], vals[q[2]])
    for w, o in zip(sched.outputs, outs):
        if not torch.equal(o.data, vals[w].data):
            raise AssertionError("run_schedule differs from the gates "
                                 "called one by one")
    got = sum(T.decrypt_bits(o, sk).astype(np.int64) << i
              for i, o in enumerate(outs))
    errors = int(np.sum(got != x + y + cin))
    adder = (sched, cts, outs)
    log(f"{nbits}-bit ripple adder through run_schedule at batch {batch}: "
        f"{sched.num_gates} gates, {sched.num_levels} levels, {planned} "
        f"kernel launches, {dt * 1e3:.1f} ms, equal as uint32 to the "
        f"{sched.num_gates} gates called one by one, sum errors {errors}, "
        f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB {tag}")
    if errors:
        raise AssertionError(f"ripple adder: {errors} wrong sums")

    rec = aes.run(ctx, sk, AES_BATCH)
    log(f"AES-128 through run_schedule at batch {AES_BATCH}, "
        f"{ctx.params.name}: {rec['gates']} gates, {rec['levels']} levels, "
        f"{rec['steps']} steps, block errors {rec['block_errors']}, "
        f"{rec['rotation_launches']} kernel launches (plan "
        f"{rec['planned_rotations']}); {rec['seconds']:.2f} s, "
        f"{rec['blocks_per_sec']:.4f} blocks/s, "
        f"{rec['bootstraps_per_sec']:.2f} effective bootstraps/s "
        f"({100 * rec['bootstraps_per_sec'] / gate_rate:.1f} % of phase 5's "
        f"gate rate), peak memory {rec['peak_memory_gb']:.2f} GB, schedule "
        f"built in {rec['schedule_seconds']:.2f} s {tag}")
    if rec["block_errors"] or \
            rec["rotation_launches"] != rec["planned_rotations"]:
        raise AssertionError("AES-128 failed its checks")
    return adder


def phase_streams(ctx, sk, tag: str) -> None:
    """13. Dependent NAND chains interleaved on two Streams, one chain's
    outputs feeding the other stream and then the default stream, with no
    explicit synchronise: equal as uint32 to the same gates on the default
    stream alone; then the per-gate latency at batch 1."""
    import numpy as np
    import torch
    import cufhe_tpu_torch as T
    from cufhe_tpu_torch.runtime import Stream, synchronize
    from cufhe_tpu_torch.utils.spans import counts

    rng = np.random.default_rng(16)
    bits = [rng.integers(0, 2, STREAM_BATCH) for _ in range(3)]
    a, b, c = (T.encrypt_bits(x, sk, rng) for x in bits)
    s1, s2 = Stream(), Stream()

    def chains(st1, st2):
        x, y = a, c
        outs = []
        for _ in range(STREAM_DEPTH):
            x = ctx.nand(x, b, stream=st1)
            y = ctx.nand(y, x, stream=st2)       # reads st1's output
            z = ctx.nand(y, x)                   # default stream
            outs += [x, y, z]
        return outs

    gates = 3 * STREAM_DEPTH
    torch.cuda.synchronize()
    before = counts()["blind_rotate"]
    t0 = time.perf_counter()
    streamed = chains(s1, s2)
    polls = 0
    while not (s1.query() and s2.query()
               and torch.cuda.current_stream().query()):
        polls += 1
        if time.perf_counter() - t0 > 120:
            raise AssertionError("Stream.query() never turned true")
    dt = time.perf_counter() - t0
    launched = counts()["blind_rotate"] - before
    if launched != gates:
        raise AssertionError(f"stream chains: {launched} kernel launches, "
                             f"want {gates}")
    plain, dt0 = timed("default-stream chains", gates,
                       lambda: chains(None, None))
    for got, want in zip(streamed, plain):
        if not torch.equal(got.data, want.data):
            raise AssertionError("cross-stream chain differs from the "
                                 "default stream")
    x, y = bits[0], bits[2]
    for _ in range(STREAM_DEPTH):
        x = 1 - (x & bits[1])
        y = 1 - (y & x)
    z = 1 - (y & x)
    if not np.array_equal(T.decrypt_bits(streamed[-1], sk), z):
        raise AssertionError("cross-stream chain decrypts wrong")
    log(f"streams: {STREAM_DEPTH} rounds of nand on two Streams and the "
        f"default stream at batch {STREAM_BATCH} ({gates} gates, {launched} "
        f"kernel launches), no explicit synchronise: query() turned true "
        f"after {polls} polls, {dt * 1e3:.1f} ms (default stream alone "
        f"{dt0 * 1e3:.1f} ms); equal as uint32 to the default stream alone "
        f"{tag}")

    one = [T.encrypt_bits(rng.integers(0, 2, 1), sk, rng) for _ in range(2)]
    st = Stream()

    def chain():
        out = one[0]
        for _ in range(LATENCY_DEPTH):
            out = ctx.nand(out, one[1], stream=st)
        synchronize(st)
        return out

    chain()
    _, dt = timed("latency chain", LATENCY_DEPTH, chain)
    log(f"latency: {LATENCY_DEPTH}-deep dependent nand chain at batch 1 on a "
        f"Stream, {ctx.params.name}: {dt / LATENCY_DEPTH * 1e3:.2f} ms per "
        f"gate (host clock, one synchronise) {tag}")
    per, busy, wall = profile_kernels(lambda: ctx.nand(*one))
    prod = sum(ms for name, (ms, _) in per.items() if "extprod" in name)
    rot = sum(ms for name, (ms, _) in per.items() if "rotdec" in name)
    log(f"  one nand at batch 1 under torch.profiler: host {wall:.2f} ms, "
        f"device busy {busy:.2f} ms (idle {100 * (1 - busy / wall):.2f} %): "
        f"extprod_kernel {prod:.2f} ms, rotdec_kernel {rot:.2f} ms, "
        f"{sum(n for _, n in per.values())} kernels {tag}")


def phase_lifecycle(ctx, sk, ek, concrete, tag: str) -> None:
    """14. release_keys frees the key bytes, a gate then raises ValueError,
    prepare_backend restores them bit-exactly, reinitialize swaps to
    concrete."""
    import numpy as np
    import torch
    import cufhe_tpu_torch as T

    rng = np.random.default_rng(17)
    bits0, bits1 = (rng.integers(0, 2, 64) for _ in range(2))
    a, b = (T.encrypt_bits(x, sk, rng) for x in (bits0, bits1))
    before, _ = timed("nand before release", 1, lambda: ctx.nand(a, b))
    sizes = {f: t.numel() * t.element_size()
             for f, t in vars(ctx.keys).items() if t.numel()}
    key_bytes = sum(sizes.values())
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    ctx.release_keys()
    freed = held - torch.cuda.memory_allocated()
    try:
        ctx.nand(a, b)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("a gate on released keys did not raise")
    if "release_keys" not in refused:
        raise AssertionError(f"the refusal does not name release_keys: "
                             f"{refused}")
    low = torch.cuda.memory_allocated()
    ctx.prepare_backend(ek)
    torch.cuda.synchronize()
    restored = torch.cuda.memory_allocated() - low
    after, _ = timed("nand after prepare_backend", 1, lambda: ctx.nand(a, b))
    log(f"lifecycle at {ctx.params.name}: release_keys freed "
        f"{freed / 1e6:.1f} MB of device memory (keys "
        f"{', '.join(f'{k} {v / 1e6:.1f} MB' for k, v in sizes.items())}), "
        f"prepare_backend took back {restored / 1e6:.1f} MB; a gate between "
        f"raised ValueError naming release_keys {tag}")
    if freed < key_bytes or restored < key_bytes:
        raise AssertionError("release_keys/prepare_backend did not free and "
                             "restore the key memory")
    if not torch.equal(after.data, before.data):
        raise AssertionError("the gate after prepare_backend differs")
    csk, cek = concrete
    ctx.reinitialize(cek)
    x, y = (T.encrypt_bits(v, csk, rng) for v in (bits0, bits1))
    out, _ = timed("nand after reinitialize", 1, lambda: ctx.nand(x, y))
    errors = int(np.sum(T.decrypt_bits(out, csk) != 1 - (bits0 & bits1)))
    log(f"reinitialize to {ctx.params.name}: nand at batch 64, decrypt "
        f"errors {errors}; the gate after prepare_backend is bit-exact to "
        f"the one before release_keys")
    if errors:
        raise AssertionError("nand after reinitialize decrypts wrong")


def int_launches(op: str, D: int) -> int:
    """Blind-rotation launches of an IntContext operation at msg_bits 1 on
    D-digit words, as models/integers.py makes them: one pbs_many call per
    digit of a ripple, one per digit set batched into a call."""
    return {"add": D, "sub_full": D,
            # the indicators in one call, then one call per OR-tree round
            "eq": 1 + (D - 1).bit_length(),
            # ge's ripple, the bool bridge, the one select call
            "select_ge": D + 2,
            # per row: the AND row, then a ripple over 2D digits
            "mul": D * (2 * D + 1),
            # per quotient bit: a ripple over D+1 digits, then a select
            "divmod_": D * (D + 2)}[op]


def phase_integers(ictx, sk, gate_rate: float, add8, gold_add8,
                   tag: str) -> int:
    """15. Encrypted integers at msg_bits 1: a 32-bit add at batch 4096,
    then at INT_BATCH a 16-bit sub_full, eq and select(ge(x, y), x, y) and
    an 8-bit mul and divmod_, each decrypt-checked with launches equal to
    int_launches; the 8-bit add of `add8`, its row 0 equal to the golden
    ripple. Returns the kernel launches of the phase."""
    import numpy as np
    import cufhe_tpu_torch as T
    from cufhe_tpu_torch.models.integers import decrypt_uint, encrypt_uint
    from cufhe_tpu_torch.torus import to_u32

    rng = np.random.default_rng(18)
    total = 0

    def words(bits, n):
        return [int(v) for v in rng.integers(0, 1 << bits, n,
                                             dtype=np.uint64)]

    def run(what, op, D, fn, batch):
        nonlocal total
        want = int_launches(op, D)
        out, dt = timed(what, want, fn)
        total += want
        log(f"{what} at batch {batch}: {dt * 1e3:.1f} ms (host clock), "
            f"{want} kernel launches = the count from the code, "
            f"{batch / dt:.2f} words/s {tag}")
        return out

    def check(what, got, want):
        errors = sum(int(g != w) for g, w in zip(got, want))
        log(f"  {what}: word errors {errors} of {len(want)}")
        if errors:
            raise AssertionError(f"{what}: {errors} wrong words")

    # the full-width row: one 32-bit add at batch 4096
    D = INT_BITS
    xs, ys = words(D, BATCH), words(D, BATCH)
    x = encrypt_uint(xs, D, sk, rng=rng, device=DEV)
    y = encrypt_uint(ys, D, sk, rng=rng, device=DEV)
    s, dt = timed(f"{D}-bit add", D, lambda: ictx.add(x, y))
    total += D
    adds = BATCH / dt
    log(f"{D}-bit add at batch {BATCH}, {ictx.ctx.params.name}: "
        f"{dt * 1e3:.1f} ms (host clock), {D} kernel launches; "
        f"{adds:.2f} adds/s, {adds * D:.2f} rotations/s "
        f"({100 * adds * D / gate_rate:.1f} % of phase 5's gate rate) "
        f"{tag}")
    check(f"{D}-bit add", decrypt_uint(s, sk),
          [(a + b) % (1 << D) for a, b in zip(xs, ys)])
    del x, y, s

    # the narrow ops at INT_BATCH
    B16 = INT_BATCH
    xs, ys = words(16, B16), words(16, B16)
    ys[::4] = xs[::4]                       # equal words for eq and ge
    x = encrypt_uint(xs, 16, sk, rng=rng, device=DEV)
    y = encrypt_uint(ys, 16, sk, rng=rng, device=DEV)
    d, ge = run("16-bit sub_full", "sub_full", 16,
                lambda: ictx.sub_full(x, y), B16)
    check("16-bit sub_full difference", decrypt_uint(d, sk),
          [(a - b) % (1 << 16) for a, b in zip(xs, ys)])
    check("16-bit sub_full ge digit",
          T.decrypt_bits(ictx.digit_to_bool(ge), sk),
          [int(a >= b) for a, b in zip(xs, ys)])
    eq = run("16-bit eq", "eq", 16, lambda: ictx.eq(x, y), B16)
    check("16-bit eq", T.decrypt_bits(eq, sk),
          [int(a == b) for a, b in zip(xs, ys)])
    mx = run("16-bit select(ge(x, y), x, y)", "select_ge", 16,
             lambda: ictx.select(ictx.ge(x, y), x, y), B16)
    check("16-bit max by select", decrypt_uint(mx, sk),
          [max(a, b) for a, b in zip(xs, ys)])
    xs, ys = words(8, B16), words(8, B16)
    x = encrypt_uint(xs, 8, sk, rng=rng, device=DEV)
    y = encrypt_uint(ys, 8, sk, rng=rng, device=DEV)
    p = run("8-bit mul", "mul", 8, lambda: ictx.mul(x, y), B16)
    check("8-bit mul", decrypt_uint(p, sk),
          [a * b for a, b in zip(xs, ys)])
    ys[0] = 0                               # the div-by-zero convention
    y = encrypt_uint(ys, 8, sk, rng=rng, device=DEV)
    q, r = run("8-bit divmod_", "divmod_", 8, lambda: ictx.divmod_(x, y),
               B16)
    check("8-bit divmod_ quotient", decrypt_uint(q, sk),
          [a // b if b else 255 for a, b in zip(xs, ys)])
    check("8-bit divmod_ remainder", decrypt_uint(r, sk),
          [a % b if b else a for a, b in zip(xs, ys)])

    # the 8-bit add held against the golden ripple on row 0
    (x8, y8), (xs, ys) = add8
    s8 = run("8-bit add", "add", 8, lambda: ictx.add(x8, y8), x8.batch)
    check("8-bit add", decrypt_uint(s8, sk),
          [(a + b) % 256 for a, b in zip(xs, ys)])
    t0 = time.perf_counter()
    if not np.array_equal(to_u32(s8.digits[0]), gold_add8.result()):
        raise AssertionError("8-bit add row 0 disagrees with the golden "
                             "ripple")
    log(f"8-bit add row 0 equal as uint32 to 8 dependent golden.pbs_many "
        f"(waited {time.perf_counter() - t0:.1f} s for the worker)")
    return total


def phase_toy8(ctx, sk, gate_rate: float, tag: str) -> int:
    """16. TOY8: TOY8_LANES random programs for TOY8_CYCLES cycles through
    run_cycles in the loop and the scan mode; both equal as uint32, 0 lane
    errors, launches equal to the plan. Returns the launches of the
    phase."""
    import numpy as np
    import torch
    from cufhe_tpu_torch.benchmarks import processor as PB
    from cufhe_tpu_torch.models import processor as TOY

    sched = TOY.build_cycle()[0].compile()
    progs = PB.random_programs(np.random.default_rng(19), TOY8_LANES)
    states, total = {}, 0
    for scan in (False, True):
        states[scan], rec = PB.run(ctx, sk, sched, progs, TOY8_CYCLES, scan)
        total += rec["rotation_launches"]
        log(f"TOY8 {rec['mode']} mode, {TOY8_LANES} lanes x {TOY8_CYCLES} "
            f"cycles ({sched.num_gates} gates, {sched.num_levels} levels, "
            f"{PB.bootstraps_per_cycle(sched)} bootstraps a lane-cycle): "
            f"{rec['seconds']:.3f} s, {rec['lane_cycles_per_sec']:.2f} "
            f"lane-cycles/s, {rec['bootstraps_per_sec']:.2f} effective "
            f"bootstraps/s ({100 * rec['bootstraps_per_sec'] / gate_rate:.1f}"
            f" % of phase 5's gate rate), {rec['rotation_launches']} kernel "
            f"launches (plan {rec['planned_rotations']}), lane errors "
            f"{rec['lane_errors']}, peak memory {rec['peak_memory_gb']:.2f} "
            f"GB {tag}")
        if rec["lane_errors"] or \
                rec["rotation_launches"] != rec["planned_rotations"]:
            raise AssertionError(f"TOY8 {rec['mode']} mode failed its checks")
    for a, b in zip(states[False], states[True]):
        if not torch.equal(a.data, b.data):
            raise AssertionError("TOY8 scan mode differs from the loop")
    log("TOY8: the scan mode's state equals the loop's as uint32")
    return total


def phase_ntt(ctx, sk, ek, p5, tag: str) -> int:
    """17. The ntt backend on the card: a NAND equal as uint32 to the same
    call on the CPU at TINY, TINY_K2, PALLAS_BG10 (8 rows) and
    tfhepp_128bit (2 rows); at tfhepp_128bit, batch 4096, one NAND on
    phase 5's inputs with 0 decrypt errors and no K1 launch, its rate,
    peak memory and phase distance to the exact path; an ntt context holds
    no bk_ext, and release/prepare_backend restore its bk_ntt. Returns
    the K1 launches of the phase's ntt calls (0)."""
    import dataclasses
    import numpy as np
    import torch
    import cufhe_tpu_torch as T
    from cufhe_tpu_torch import golden as G
    from cufhe_tpu_torch.benchmarks.noise import centered_phases
    from cufhe_tpu_torch.ops import bootstrap as B
    from cufhe_tpu_torch.torus import from_u32, to_u32
    from cufhe_tpu_torch.utils.spans import counts

    nand = G.GATE_CONSTANTS["nand"]
    launched = 0

    def run(what, fn):
        """timed(what, 0, fn): no K1 launch allowed; the count it read is
        kept."""
        nonlocal launched
        before = counts()["blind_rotate"]
        out = timed(what, 0, fn)
        launched += counts()["blind_rotate"] - before
        return out
    bits0, bits1 = [0, 1, 0, 1, 1, 0, 1, 1], [0, 0, 1, 1, 1, 1, 0, 1]
    for i, params in enumerate((T.TINY, T.TINY_K2, T.PALLAS_BG10)):
        tsk = G.keygen(params, seed=600 + i)
        tek = G.make_eval_key(tsk, seed=610 + i)
        rng = np.random.default_rng(620 + i)
        h0, h1 = (G.encrypt_bit_batch(x, tsk, rng) for x in (bits0, bits1))
        card, _ = run(f"ntt nand at {params.name}", lambda: T.Context(
            tek, "ntt").nand(T.Ctxt(from_u32(h0, DEV), 0),
                             T.Ctxt(from_u32(h1, DEV), 0)))
        cpu = T.Context(tek, "ntt", device="cpu").nand(
            T.Ctxt(from_u32(h0), 0), T.Ctxt(from_u32(h1), 0))
        if not np.array_equal(to_u32(card.data), to_u32(cpu.data)):
            raise AssertionError(f"ntt nand at {params.name}: the card "
                                 f"differs from the CPU")
        if params is T.TINY and T.decrypt_bits(card, tsk).tolist() != \
                [1 - (x & y) for x, y in zip(bits0, bits1)]:
            raise AssertionError("ntt nand at TINY decrypts wrong")
        log(f"ntt nand at {params.name}, 8 rows: card equal to the CPU as "
            f"uint32, 0 kernel launches")

    bits0, bits1, a, b, exact, _, gate_rate = p5
    t0 = time.perf_counter()
    nctx = T.Context(ek, "ntt")
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    if nctx.keys.bk_ext.numel():
        raise AssertionError("an ntt context holds bk_ext")
    cpu_keys = dataclasses.replace(nctx.keys, **{
        f.name: getattr(nctx.keys, f.name).cpu()
        for f in dataclasses.fields(nctx.keys)})
    two, _ = run("ntt nand, 2 rows", lambda: B.gate_lvl0(
        nand, a.data[:2], b.data[:2], nctx.keys, ek.params, "ntt"))
    t0 = time.perf_counter()
    two_cpu = B.gate_lvl0(nand, a.data[:2].cpu(), b.data[:2].cpu(), cpu_keys,
                          ek.params, "ntt")
    if not np.array_equal(to_u32(two), to_u32(two_cpu)):
        raise AssertionError("ntt nand at tfhepp_128bit: the card differs "
                             "from the CPU")
    log(f"ntt nand at {ek.params.name}, 2 rows: card equal to the CPU as "
        f"uint32 (CPU {time.perf_counter() - t0:.1f} s; key preparation "
        f"{prep_s:.1f} s)")

    torch.cuda.reset_peak_memory_stats()
    out, dt = run("ntt nand at batch 4096", lambda: nctx.nand(a, b))
    errors = int(np.sum(T.decrypt_bits(out, sk) != 1 - (bits0 & bits1)))
    diff = centered_phases(out, sk) - centered_phases(exact, sk)
    diff = (diff + (1 << 31)) % (1 << 32) - (1 << 31)
    log(f"ntt nand at batch {BATCH}, {ek.params.name}, phase 5's inputs: "
        f"decrypt errors {errors}, 0 kernel launches; {BATCH / dt:.2f} "
        f"gates/s ({dt * 1e3:.1f} ms per batch, "
        f"{100 * BATCH / dt / gate_rate:.2f} % of phase 5), peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB {tag}")
    log(f"  phase distance to the exact path's output: max "
        f"2^{np.log2(max(np.abs(diff).max(), 1)):.2f}, std "
        f"2^{np.log2(max(diff.std(), 1)):.2f}, beside mu = 2^29")
    if errors:
        raise AssertionError(f"ntt nand: {errors} decrypt errors")

    few = (T.Ctxt(a.data[:4], 0), T.Ctxt(b.data[:4], 0))
    before, _ = run("ntt nand, 4 rows", lambda: nctx.nand(*few))
    nctx.release_keys(("ntt",))
    if nctx.keys.bk_ntt.numel():
        raise AssertionError("release_keys kept bk_ntt")
    try:
        nctx.nand(*few)
    except ValueError:
        pass
    else:
        raise AssertionError("an ntt gate on a released bk_ntt ran")
    nctx.prepare_backend(ek, "ntt")
    after, _ = run("ntt nand after prepare_backend",
                   lambda: nctx.nand(*few))
    if not torch.equal(after.data, before.data) or nctx.keys.bk_ext.numel():
        raise AssertionError("prepare_backend(ek, 'ntt') did not restore "
                             "the ntt key alone")
    log(f"ntt key lifecycle: no bk_ext; release_keys(('ntt',)) makes a gate "
        f"raise ValueError, prepare_backend(ek, 'ntt') restores bk_ntt "
        f"({nctx.keys.bk_ntt.numel() * 8 / 1e6:.1f} MB with its Shoup "
        f"companion), the gate bit-exact again")
    return launched


def phase_mesh(ctx, sk, ek, p5, adder, tag: str) -> int:
    """18. The mesh on one card: phase 5's chain on data_mesh() (one shard)
    and on two shards of cuda:0, equal to phase 5 as uint32 with one
    launch per shard per gate; on two shards the ripple adder
    (run_schedule), an 8-bit IntContext.add at INT_BATCH and a feedback
    circuit through run_schedule_loop, each equal to the plain context;
    no second key set. Returns the K1 launches of the mesh runs."""
    import numpy as np
    import torch
    import cufhe_tpu_torch as T
    from cufhe_tpu_torch.bench import time_nand_chain
    from cufhe_tpu_torch.models.integers import IntContext, encrypt_uint
    from cufhe_tpu_torch.parallel import data_mesh
    from cufhe_tpu_torch.runtime import (CircuitBuilder, run_schedule,
                                         run_schedule_loop)
    from cufhe_tpu_torch.runtime import executor as EX

    bits0, bits1, a, b, _, chain_out, gate_rate = p5
    mesh1 = data_mesh()
    if mesh1.size != 1 or torch.cuda.device_count() != 1:
        raise AssertionError(f"data_mesh() has {mesh1.size} devices")
    key_bytes = sum(t.numel() * t.element_size()
                    for t in vars(ctx.keys).values())
    launched, rates, ctxs = 0, {}, {}
    for name, mesh in (("mesh-1", mesh1),
                       ("mesh-2", data_mesh(["cuda:0", "cuda:0"]))):
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        mctx = ctxs[name] = T.Context(ek, mesh=mesh)
        torch.cuda.synchronize()
        grew = torch.cuda.memory_allocated() - held
        if mctx._dev_keys or grew > 1.5 * key_bytes:
            raise AssertionError(f"{name}: a second key set ({grew} bytes "
                                 f"for keys of {key_bytes})")
        gates = 1 + ITERS * REPS

        def chain():
            return time_nand_chain(mctx, mctx.nand(a, b), b, ITERS, REPS)
        (out, times), _ = timed(f"{name} chain", mesh.size * gates, chain)
        launched += mesh.size * gates
        if not torch.equal(out.data, chain_out.data):
            raise AssertionError(f"{name}: the chain differs from phase 5")
        rates[name] = BATCH / statistics.median(times)
        log(f"{name} ({mesh.size} shard(s) on cuda:0): phase 5's chain of "
            f"{gates} NANDs at batch {BATCH} equal as uint32, "
            f"{mesh.size * gates} kernel launches ({mesh.size} a gate); "
            f"{rates[name]:.2f} gates/s, {100 * rates[name] / gate_rate:.2f}"
            f" % of phase 5 (reps {[round(t * 1e3, 1) for t in times]} ms); "
            f"context memory {grew / 1e6:.1f} MB for {key_bytes / 1e6:.1f} "
            f"MB of keys {tag}")
    m2 = ctxs["mesh-2"]

    sched, cts, plain_outs = adder
    planned = EX.plan_rotations(EX.schedule_steps(ctx, sched, cts[0].batch))
    outs, _ = timed("mesh-2 ripple adder", 2 * planned,
                    lambda: run_schedule(m2, sched, cts))
    launched += 2 * planned
    if not all(torch.equal(o.data, w.data) for o, w in zip(outs,
                                                            plain_outs)):
        raise AssertionError("mesh-2 ripple adder differs from phase 12")
    rng = np.random.default_rng(21)
    x, y = (encrypt_uint([int(v) for v in rng.integers(0, 256, INT_BATCH)],
                         8, sk, rng=rng) for _ in range(2))
    got, _ = timed("mesh-2 8-bit add", 16, lambda: IntContext(m2).add(x, y))
    launched += 16
    if not torch.equal(got.digits, IntContext(ctx).add(x, y).digits):
        raise AssertionError("mesh-2 8-bit add differs from the plain one")
    cb = CircuitBuilder()
    sel, xin = cb.input(), cb.input()
    one = cb.const(1)
    cb.output(cb.gate("mux", sel, cb.gate("nand", xin, one), one))
    loop = cb.compile()
    ins = [T.encrypt_bits(rng.integers(0, 2, INT_BATCH), sk, rng)
           for _ in range(2)]
    per_cycle = EX.plan_rotations(EX.schedule_steps(ctx, loop, INT_BATCH))
    got, _ = timed("mesh-2 run_schedule_loop", 2 * 3 * per_cycle,
                   lambda: run_schedule_loop(m2, loop, ins, 3, [(0, 1)]))
    launched += 2 * 3 * per_cycle
    want = run_schedule_loop(ctx, loop, ins, 3, [(0, 1)])
    if not torch.equal(got[0].data, want[0].data):
        raise AssertionError("mesh-2 run_schedule_loop differs from the "
                             "plain loop")
    log(f"mesh-2: the {len(sched.inputs) // 2}-bit ripple adder through "
        f"run_schedule (phase 12's inputs), an 8-bit IntContext.add at "
        f"batch {INT_BATCH} and a nand/mux feedback circuit through "
        f"run_schedule_loop ({INT_BATCH} rows, 3 cycles) equal as uint32 to "
        f"the plain context, 2 launches a rotation")
    share = {k: 100 * v / gate_rate for k, v in rates.items()}
    log(f"mesh layer on one card: mesh-1 {share['mesh-1']:.2f} %, mesh-2 "
        f"{share['mesh-2']:.2f} % of phase 5's gates/s; scaling across cards is not measured (this machine "
        f"has {torch.cuda.device_count()} card) {tag}")
    return launched


def phase_surface(ctx, sk, ek, pool, info: dict, tag: str) -> int:
    """19. The bench surface and the examples on the card, with the
    kernel's launch count zeroed just before and read just after. Returns
    the launches of the phase."""
    import contextlib
    import io
    import math
    import runpy
    import numpy as np
    import torch
    from cufhe_tpu_torch.benchmarks import golden_check as GC
    from cufhe_tpu_torch.benchmarks import phase_breakdown as PB
    from cufhe_tpu_torch.benchmarks import suite as SU
    from cufhe_tpu_torch.utils.spans import counts

    torch.cuda.synchronize()
    before = counts()["blind_rotate"]
    t0 = time.perf_counter()
    mism, total = GC.golden_diff(ctx, sk, ek, np.random.default_rng(23),
                                 nb=SURFACE_SAMPLES, pool=pool)
    log(f"golden_check.golden_diff at {ctx.params.name}, {SURFACE_SAMPLES} "
        f"samples of {', '.join(GC.GATES)} and mux: {mism} of {total} words "
        f"mismatched ({time.perf_counter() - t0:.1f} s)")
    if mism:
        raise AssertionError("the card's gates differ from golden")

    card = {"name": info["name"], "power_limit": info["power_limit"]}
    run = SU.Run(ctx, sk, ek, SURFACE_BATCH, 1, card)
    sections = [name for name in SU.SECTIONS if name != "golden"]
    t0 = time.perf_counter()
    if SU.run_sections(run, sections):
        raise AssertionError("a suite section failed its checks")
    log(f"suite sections {', '.join(sections)} at batch {SURFACE_BATCH}: "
        f"{len(run.results)} records, 0 errors, margins above their floors "
        f"({time.perf_counter() - t0:.1f} s) {tag}")

    rec = PB.breakdown(ctx.keys, ctx.params, BATCH, ctx.device)
    log(f"phase breakdown at batch {BATCH}, {ctx.params.name} (ms, CUDA "
        f"events): {json.dumps(rec)} {tag}")
    if not all(math.isfinite(v) and v >= 0 for k, v in rec.items()
               if k.endswith("_ms")):
        raise AssertionError("phase breakdown: a time is not a time")

    for script, args, expect in EXAMPLES:
        path = os.path.join(REPO, "cufhe_tpu_torch", "examples", script)
        argv, sys.argv = sys.argv, [path, *args]
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(io.StringIO()) as out:
                runpy.run_path(path, run_name="__main__")
        finally:
            sys.argv = argv
        if expect not in out.getvalue():
            raise AssertionError(f"{script} {' '.join(args)}: no success "
                                 f"line in {out.getvalue()[-500:]!r}")
        log(f"example {script} {' '.join(args)}: {expect!r} "
            f"({time.perf_counter() - t0:.1f} s)")
    torch.cuda.synchronize()
    launches = counts()["blind_rotate"] - before
    if launches == 0:
        raise AssertionError("phase 19 launched no blind rotation")
    log(f"phase 19: {launches} kernel launches")
    return launches


def phase_probe(info: dict, tag: str) -> dict:
    """7. Both probe kernels against their plain version, then the probe's
    path with the launch counts zeroed just before it. Returns the kernels
    line's entries of the two kernels, by instruction."""
    import numpy as np
    import torch
    from cufhe_tpu_torch.benchmarks import mxu_peak as MP
    from cufhe_tpu_torch.benchmarks.rotation import bound

    dev = torch.device("cuda")
    rng = np.random.default_rng(9)
    max_err = dict.fromkeys(MP.INSTRUCTIONS, 0)
    M, K, W, S, _ = MP.FULL
    for shape, variants in ((MP.SMALL, MP.VARIANTS),
                            ((M, K, W, S, 1), ("pure", "place"))):
        for v in variants:
            A, X = MP.make_operands(rng, v, *shape[:4], dev)
            want = MP.mxu_peak_ref(A, X, v, shape[4])
            for instr in MP.INSTRUCTIONS:
                got = MP.mxu_peak_cuda(A, MP.prepare_x(X), v, shape[4],
                                       instr)
                torch.cuda.synchronize()
                err = int((got.long() - want.long()).abs().max())
                log(f"mxu_peak {instr} kernel vs plain, {v}, (M, K, W, S, "
                    f"steps) = {shape}: max_abs_err {err}")
                if err != 0:
                    raise AssertionError(f"mxu_peak {instr} {v} disagrees "
                                         f"at {shape}")
    MP.mxu_peak_cuda.launches = 0
    for instr in MP.INSTRUCTIONS:
        MP.mxu_peak_cuda.by_instruction[instr] = 0
    rows = MP.run_probe(info, emit=lambda line: log("  probe " + line))
    launches = dict(MP.mxu_peak_cuda.by_instruction)
    for r in rows:
        line = f"  {r['case']}: {r['tmacs_per_sec']:.2f} TMAC/s"
        if r["path"] == "kernel":
            line += (f" ({r['instruction']}, {r['ms']:.3f} ms, "
                     f"{r['smem_gb']:.2f} GB into shared memory) vs plain "
                     f"{r['plain_tmacs_per_sec']:.2f} TMAC/s "
                     f"({r['plain_ms']:.3f} ms), max_abs_err "
                     f"{r['max_abs_err']}")
            instr = ("wgmma" if r["instruction"].startswith("wgmma")
                     else "mma_sync")
            max_err[instr] = max(max_err[instr], r["max_abs_err"])
        log(line + f" {tag}")
    if any(max_err.values()) or not all(launches.values()):
        raise AssertionError(f"probe failed: max_abs_err {max_err}, "
                             f"kernel launches {launches}")
    # the main rows' function, pure = sum_s A_s X_s, is one library product
    # of the operands laid side by side, once per step
    M, K, W, S, steps = MP.FULL
    A, X = MP.make_operands(rng, "pure", M, K, W, S, dev)
    a_cat = A.permute(1, 0, 2).reshape(M, S * K).contiguous()
    x_cat = X.reshape(S * K, W)
    torch._int_mm(a_cat, x_cat)
    _, lib_ms = cuda_ms(lambda: torch._int_mm(a_cat, x_cat), 5)
    lib_ms *= steps
    macs = float(M) * K * W * S * steps
    bound_ms, bound_by = bound(2 * macs, A.numel() + X.numel() + 4 * M * W)
    log(f"  pure-w512: bound {bound_ms:.3f} ms ({bound_by}); library, "
        f"torch._int_mm [{M}, {S * K}] @ [{S * K}, {W}] x {steps} steps: "
        f"{lib_ms:.3f} ms {tag}")
    M, K, W, S, steps = MP.K1_STEP
    k1_ms, k1_by = bound(2.0 * M * K * W * S * steps,
                         S * (M * K + K * W) + 4 * M * W)
    log(f"  pure-k1step: bound {k1_ms:.3f} ms ({k1_by}) {tag}")
    out = {}
    for instr, case in (("wgmma", "pallas-pure-w512"),
                        ("mma_sync", "mma_sync-pure-w512")):
        row = next(r for r in rows if r["case"] == case)
        out[instr] = {"launches": launches[instr],
                      "max_abs_err": max_err[instr], "ms": row["ms"],
                      "plain_ms": row["plain_ms"], "bound_ms": bound_ms,
                      "bound_by": bound_by, "library_ms": lib_ms}
    return out


def phase_tiny_paths() -> None:
    """8. Every new path at tiny presets on the card, as uint32 equal to
    golden."""
    import numpy as np
    import cufhe_tpu_torch as T
    from cufhe_tpu_torch import golden as G
    from cufhe_tpu_torch.models.gates import TWO_INPUT
    from cufhe_tpu_torch.ops import bootstrap as B
    from cufhe_tpu_torch.torus import from_u32, to_u32

    bits0, bits1, bitsc = [0, 1, 0, 1], [0, 0, 1, 1], [0, 1, 1, 0]
    for i, params in enumerate((T.TINY, T.TINY_K2, T.PALLAS_BG10)):
        sk = G.keygen(params, seed=500 + i)
        ek = G.make_eval_key(sk, seed=510 + i)
        ctx = T.Context(ek, device=DEV)
        rng = np.random.default_rng(520 + i)
        lp = params.lvl1
        checks = []

        def same(what, got, want):
            if not np.array_equal(to_u32(got), np.asarray(want)):
                raise AssertionError(f"{what} at {params.name} disagrees "
                                     f"with golden")
            checks.append(what)

        def rows(fn, *cols):
            return np.stack([fn(*r) for r in zip(*cols)])

        for level in (0, 1):
            a, b, c = (T.encrypt_bits(bits, sk, rng, device=DEV,
                                      level=level)
                       for bits in (bits0, bits1, bitsc))
            ha, hb, hc = (to_u32(x.data) for x in (a, b, c))
            gate = G.gate_lvl0 if level == 0 else G.gate_lvl1
            mux = G.mux_lvl0 if level == 0 else G.mux_lvl1
            if level == 1:
                for name in TWO_INPUT:
                    same(f"lvl1 {name}", ctx.gate(name, a, b).data,
                         rows(lambda x, y: gate(name, x, y, ek), ha, hb))
            for negate in (False, True):
                same(f"lvl{level} {'nmux' if negate else 'mux'}",
                     ctx.mux(c, a, b, negate=negate).data,
                     rows(lambda x, y, z: mux(x, y, z, ek, negate=negate),
                          hc, ha, hb))
            mu = lp.mu if level else params.lvl0.mu
            consts = B.encode_gate_consts_rows(["xor", "andyn"], mu, DEV)
            same(f"lvl{level} gate_rows", ctx.gate_rows(consts, a, b).data,
                 rows(lambda nm, x, y: gate(nm, x, y, ek),
                      ["xor", "xor", "andyn", "andyn"], ha, hb))
            want = ha
            for nm in MIXED:
                want = rows(lambda x, y: gate(nm, x, y, ek), want, hb)
            same(f"lvl{level} gate_chain",
                 ctx.gate_chain(MIXED, a, b).data, want)
        tg = G.trgsw_encrypt(1, lp, sk.lvl1, rng)
        c1, c0, tr = (np.stack([G.trlwe_encrypt_zero(lp, sk.lvl1, rng)
                                for _ in range(2)]) for _ in range(3))
        same("cmux", ctx.cmux(ctx.prepare_trgsw(tg),
                              T.TrlweCtxt(from_u32(c1, DEV)),
                              T.TrlweCtxt(from_u32(c0, DEV))).data,
             rows(lambda x, y: G.cmux(tg, x, y, lp), c1, c0))
        same("refresh", ctx.refresh(T.TrlweCtxt(from_u32(tr, DEV))).data,
             rows(lambda x: G.refresh(x, ek), tr))
        a = T.encrypt_bits(bits0, sk, rng, device=DEV)
        ha = to_u32(a.data)
        tv = rng.integers(0, 1 << 32, lp.n, dtype=np.uint64).astype(np.uint32)
        same("programmable_bootstrap", ctx.programmable_bootstrap(a, tv).data,
             rows(lambda x: G.programmable_bootstrap(x, tv, ek), ha))
        for theta in (0, 1, 2):
            J = 1 << theta
            same(f"pbs_many theta={theta}",
                 B.pbs_many(a.data, from_u32(tv, DEV), J, ctx.keys, params,
                            theta=theta),
                 np.stack([G.pbs_many(x, tv, J, ek, theta=theta)
                           for x in ha], axis=1))
        log(f"paths at {params.name} on the card: {len(checks)} results "
            f"equal to golden as uint32 ({', '.join(checks)})")


def phase_full_width(ctx, sk, ek, pool, tag: str) -> None:
    """9. The new paths at tfhepp_128bit, batch 4096, device-resident:
    decrypt, golden on GOLDEN_ROWS (`pool`'s worker processes,
    concurrently with the card), one kernel launch per blind rotation."""
    import numpy as np
    import torch
    import cufhe_tpu_torch as T
    from cufhe_tpu_torch import golden as G
    from cufhe_tpu_torch.models.gates import TWO_INPUT
    from cufhe_tpu_torch.ops import bootstrap as B
    from cufhe_tpu_torch.ops.keyswitch import key_switch
    from cufhe_tpu_torch.torus import from_u32, to_u32

    p = ek.params
    lp = p.lvl1
    rng = np.random.default_rng(11)
    bits0, bits1, bitsc = (rng.integers(0, 2, BATCH) for _ in range(3))
    a1, b1 = (T.encrypt_bits(x, sk, rng, device=DEV, level=1)
              for x in (bits0, bits1))
    a0, b0, c0 = (T.encrypt_bits(x, sk, rng, device=DEV)
                  for x in (bits0, bits1, bitsc))
    ha1, hb1, ha0, hb0, hc0 = (to_u32(x.data) for x in (a1, b1, a0, b0, c0))
    names16 = list(TWO_INPUT) + list(TWO_INPUT[:6])    # 16 divides 4096
    per_row = [names16[r // (BATCH // 16)] for r in range(BATCH)]
    # LUT 0 = the bit, LUT 1 = its negation: tv[w] = mu, tv[w + 1] = -mu
    tv = np.where(np.arange(lp.n) % 2 == 0, lp.mu,
                  (1 << 32) - lp.mu).astype(np.uint32)

    def run(what, rotations, fn):
        out, dt = timed(what, rotations, fn)
        log(f"{what} at batch {BATCH}: {dt * 1e3:.1f} ms (host clock), "
            f"{rotations} blind-rotation launches {tag}")
        return out, dt

    def decrypt_errors(what, ct, want) -> None:
        errors = int(np.sum(T.decrypt_bits(ct, sk) != np.asarray(want)))
        log(f"{what} at batch {BATCH}: decrypt errors {errors}")
        if errors:
            raise AssertionError(f"{what}: {errors} decrypt errors")

    gold = {
        "lvl1 nand": [pool.submit(_g_gate, 1, "nand", ha1[r], hb1[r])
                      for r in GOLDEN_ROWS],
        "mux_lvl0": [pool.submit(_g_mux, hc0[r], ha0[r], hb0[r])
                     for r in GOLDEN_ROWS],
        "gate_chain": [pool.submit(_g_chain, MIXED, ha0[r], hb0[r])
                       for r in GOLDEN_ROWS],
        "gate_rows": [pool.submit(_g_gate, 0, per_row[r], ha0[r],
                                  hb0[r]) for r in GOLDEN_ROWS],
        "pbs_many": [pool.submit(_g_pbs_many, ha0[r], tv, 2, 1)
                     for r in GOLDEN_ROWS],
        "b2t_refresh": [pool.submit(_g_b2t_refresh, ha0[r])
                        for r in GOLDEN_ROWS],
    }
    # the lvl1 key switch reads the one (sample-extract order) KSK
    # through a column gather: its cost, against no gather
    ksk, perm = ctx.keys.ksk_tiles, ctx.keys.sei_perm
    _, ks_ms = cuda_ms(lambda: key_switch(a1.data, ksk, p, perm=perm), 5)
    _, plain_ms = cuda_ms(lambda: key_switch(a1.data, ksk, p), 5)
    log(f"lvl1 key switch at batch {BATCH}: {ks_ms:.3f} ms with the "
        f"sei_perm gather, {plain_ms:.3f} ms without (CUDA events) {tag}")
    outs = {}
    for what, rot, fn, want in (
            ("lvl1 nand", 1, lambda: ctx.nand(a1, b1),
             1 - (bits0 & bits1)),
            ("mux_lvl0", 2, lambda: ctx.mux(c0, a0, b0),
             np.where(bitsc == 1, bits0, bits1))):
        out, dt = run(what, rot, fn)
        _, dt2 = run(what, rot, fn)
        decrypt_errors(what, out, want)
        outs[what] = out
        log(f"{what}: {BATCH / statistics.median((dt, dt2)):.2f} gates/s "
            f"(reps {dt * 1e3:.1f}, {dt2 * 1e3:.1f} ms per batch) {tag}")
    chain, _ = run("gate_chain", len(MIXED),
                   lambda: ctx.gate_chain(MIXED, a0, b0))
    cur, want = a0, bits0
    for nm in MIXED:
        cur = ctx.gate(nm, cur, b0)
        want = np.array([G.PLAIN_GATES[nm](x, y)
                         for x, y in zip(want, bits1)])
    if not torch.equal(chain.data, cur.data):
        raise AssertionError("gate_chain differs from its gate() calls")
    log(f"gate_chain {list(MIXED)}: equal to the {len(MIXED)} separate "
        f"gate() calls")
    decrypt_errors("gate_chain", chain, want)
    consts = B.encode_gate_consts_rows(names16, p.lvl0.mu, DEV)
    mixed, _ = run("gate_rows", 1, lambda: ctx.gate_rows(consts, a0, b0))
    decrypt_errors("gate_rows (ten gates, gate-major)", mixed,
                   [G.PLAIN_GATES[nm](x, y)
                    for nm, x, y in zip(per_row, bits0, bits1)])
    many, _ = run("pbs_many", 1, lambda: B.pbs_many(
        a0.data, from_u32(tv, DEV), 2, ctx.keys, p, theta=1))
    decrypt_errors("pbs_many J=2 theta=1 (bit, not bit)",
                   T.Ctxt(many.reshape(2 * BATCH, -1), 0),
                   np.concatenate([bits0, 1 - bits0]))
    tr, _ = run("bootstrap_tlwe2trlwe", 1,
                lambda: ctx.bootstrap_tlwe2trlwe(a0))
    via, _ = run("pbs_tlwe2trlwe", 1, lambda: ctx.pbs_tlwe2trlwe(
        a0, np.full(lp.n, lp.mu, dtype=np.uint32)))
    if not torch.equal(tr.data, via.data):
        raise AssertionError("pbs_tlwe2trlwe(constant mu) differs from "
                             "bootstrap_tlwe2trlwe")
    log(f"pbs_tlwe2trlwe with the constant-mu test vector: equal to "
        f"bootstrap_tlwe2trlwe at batch {BATCH}")
    rf, _ = run("refresh", 1, lambda: ctx.refresh(tr))
    ext, _ = run("sample_extract_and_keyswitch", 0,
                 lambda: ctx.sample_extract_and_keyswitch(rf))
    decrypt_errors("refresh -> sample_extract_and_keyswitch", ext, bits0)

    got = {"lvl1 nand": to_u32(outs["lvl1 nand"].data),
           "mux_lvl0": to_u32(outs["mux_lvl0"].data),
           "gate_chain": to_u32(chain.data),
           "gate_rows": to_u32(mixed.data),
           "pbs_many": to_u32(many).transpose(1, 0, 2),
           "b2t_refresh": list(zip(to_u32(tr.data), to_u32(rf.data),
                                   to_u32(ext.data)))}
    t0 = time.perf_counter()
    for what, futures in gold.items():
        for r, fut in zip(GOLDEN_ROWS, futures):
            want = fut.result()
            mine = got[what][r]
            if isinstance(want, tuple):
                equal = all(np.array_equal(x, y)
                            for x, y in zip(mine, want))
            else:
                equal = np.array_equal(mine, want)
            if not equal:
                raise AssertionError(f"{what} row {r} disagrees with "
                                     f"golden")
    log(f"full width vs golden on rows {list(GOLDEN_ROWS)}: "
        f"{', '.join(gold)} equal as uint32 (waited "
        f"{time.perf_counter() - t0:.1f} s for the workers)")


def profile_kernels(fn):
    """fn() under torch.profiler: ({kernel name: [device ms, launches]},
    device busy ms (the union of the kernels' spans), host ms to a
    synchronise). The device-side copies of the program's cufhe.* spans
    are no kernels and are left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    per, spans = {}, []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and \
                not e.name.startswith("cufhe."):
            row = per.setdefault(e.name, [0.0, 0])
            row[0] += e.device_time_total / 1e3
            row[1] += 1
            spans.append((e.time_range.start, e.time_range.end))
    busy, end = 0.0, None
    for s, t in sorted(spans):
        if end is None or s > end:
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    return per, busy / 1e3, wall


def phase_persistent(ctx, sk, tag: str) -> dict:
    """21. The persistent rotation, one cooperative launch of
    persistent_extprod_kernel a rotation where rotation_plan takes it: at
    every published preset and PERSIST_ROWS rows, equal as uint32 to
    blind_rotate_ref on the first of PERSIST_REPS fresh inputs and to the
    loop on every one, one blind_rotate.persistent and no rotdec launch a
    rotation; one AES-128 block at batch 1 (the aes128_b1 cell's shape)
    through run_schedule: the block right, a persistent launch for each
    of its 257 rotations and no rotdec launch; then the loop and the
    persistent kernel timed a step at tfhepp_128bit
    (benchmarks.rotation.measure_paths). Returns the kernels line's
    blind_rotate_persistent entry."""
    import torch
    import cufhe_tpu_torch as T
    from cufhe_tpu_torch import _build
    from cufhe_tpu_torch.benchmarks import aes
    from cufhe_tpu_torch.benchmarks import rotation as RT
    from cufhe_tpu_torch.ops import blind_rotate as BR
    from cufhe_tpu_torch.utils.spans import counts

    sms = _build.sms(torch.device(DEV))
    max_err = checked = 0
    for name in ("tfhepp_128bit", *FULL_PRESETS):
        params = T.PRESETS[name]
        depth = BR.kar_depth(params)
        key = RT.random_keys(params, 900, DEV, [(4, depth)])[4, depth]
        lp = params.lvl1
        for rows in PERSIST_ROWS:
            grid = BR.rotation_plan(rows, lp.n, lp.k + 1, key.shape[1], sms,
                                    depth)[1]
            if not grid:
                raise AssertionError(f"{name}, {rows} rows: the loop, where "
                                     f"the persistent kernel should run")
            for rep in range(PERSIST_REPS):
                acc, abar = RT.random_rotation_inputs(params, rows,
                                                      901 + 1000 * rep, DEV)
                before = counts()
                got = BR.blind_rotate_cuda(acc, abar, key, params)
                launched = counts() - before
                want = (BR.blind_rotate_ref(acc, abar, key, params)
                        if rep == 0 else
                        BR._blind_rotate_cuda(acc, abar, key, params, depth,
                                              grid=0))
                err = u32_max_abs_err(got, want)
                if (err or launched["blind_rotate.persistent"] != 1
                        or launched["blind_rotate.persistent_groups"]
                        != BR.persistent_groups(rows, grid)
                        or launched["rotdec"]):
                    raise AssertionError(
                        f"persistent rotation at {name}, {rows} rows, "
                        f"input {rep}: max_abs_err {err}, launches "
                        f"{dict(launched)}")
                max_err = max(max_err, err)
                checked += 1
        log(f"persistent rotation at {name}, {', '.join(map(str, PERSIST_ROWS))}"
            f" rows: equal as uint32 to the plain version and to the loop on "
            f"{PERSIST_REPS} inputs each, one persistent launch of one "
            f"row-tile group a 64-row tile and no rotdec "
            f"launch a rotation")
        del key

    before = counts()
    rec = aes.run(ctx, sk, 1)
    launched = counts() - before
    log(f"AES-128 at batch 1 through run_schedule, {ctx.params.name}: block "
        f"errors {rec['block_errors']}, {rec['rotation_launches']} rotations, "
        f"{launched['blind_rotate.persistent']} persistent launches of "
        f"{launched['blind_rotate.persistent_groups']} row-tile groups, "
        f"{launched['rotdec']} rotdec launches; {rec['seconds'] * 1e3:.1f} ms "
        f"a block {tag}")
    if (rec["block_errors"] or rec["rotation_launches"] != AES_LEVELS
            or launched["blind_rotate.persistent"] != AES_LEVELS
            or launched["blind_rotate.persistent_groups"] != AES_TILES
            or launched["rotdec"]):
        raise AssertionError("AES-128 at batch 1: want every rotation on the "
                             "persistent kernel")

    paths = RT.measure_paths(T.TFHEPP_128, PATHS_ROWS)
    for r in paths:
        log(f"rotation a step at {r['params']}, {r['rows']} rows (takes "
            f"{r['takes']}): loop {r['loop_us_a_step']:.2f} us, persistent "
            f"{r['persistent_us_a_step']:.2f} us "
            f"({100 * r['persistent_over_loop']:.1f} % of the loop), bound "
            f"{r['bound_us_a_step']:.2f} us ({r['bound_by']}), plain "
            f"{r['plain_ms']:.0f} ms a rotation {tag}")
    return {"name": "blind_rotate_persistent", "route": "cuda",
            "instruction": "wgmma", "source": SOURCE, "replaces": REPLACES,
            "checked": checked, "max_abs_err": max_err,
            "launches_aes": launched["blind_rotate.persistent"],
            "groups_aes": launched["blind_rotate.persistent_groups"],
            "aes_block_ms": rec["seconds"] * 1e3,
            "us_a_step": {r["rows"]: [r["loop_us_a_step"],
                                      r["persistent_us_a_step"],
                                      r["bound_us_a_step"]] for r in paths}}


def phase_mux(tag: str) -> None:
    """22. Context.mux at cggi19 (Karatsuba depth 1), BATCH rows, on the
    card: keys and inputs made from a seed by the benchmark's plain
    reference (fhebench/reference), the port's keys built from them as
    fhebench.harness.Session builds them; the MUX and then the NMUX of the
    same inputs equal word for word to fhebench/reference/mux.py, each
    decrypting to the cleartext MUX; a MUX launches two rotations, both at
    depth 1 on the loop of 2 n0 launches (no persistent launch at this
    width), and one key switch, and counts one `mux` of BATCH rows."""
    import torch
    from cufhe_tpu_torch import golden as G
    from cufhe_tpu_torch.models.api import Context, Ctxt
    from cufhe_tpu_torch.utils.spans import counts
    from fhebench import harness as H
    from fhebench.reference import mux as M
    from fhebench.reference import tfhe as R

    cfg = H._json(os.path.join(REPO, "fhebench", "configs", "cggi19.json"))
    dev = torch.device(DEV)
    p = R.Params.from_config(cfg)
    seed = 2 ** 33 + 23
    sk = R.keygen(p, seed, dev)
    ek = R.make_eval_key(p, sk, seed)
    ctx = Context(G.EvalKey(H.port_params(cfg),
                            ek.bk.cpu().numpy().astype("uint32"),
                            ek.ksk.cpu().numpy().astype("uint32")),
                  device=dev)
    g = R.generator(seed, 2, dev)
    bits = [torch.randint(0, 2, (BATCH,), generator=g, device=dev)
            for _ in range(3)]
    cts = [R.encrypt_bits(p, sk, b, g) for b in bits]
    port = [Ctxt(H.Session.to_port(ct), 0) for ct in cts]
    outs, bad = {}, []
    for negate in (False, True):
        torch.cuda.synchronize()
        before = counts()
        t0 = time.perf_counter()
        out = ctx.mux(*port, negate=negate)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = counts() - before
        want = {"blind_rotate": 2, "blind_rotate.kar1": 2, "key_switch": 1,
                "rotdec": 2 * p.n0, "mux": 1, "mux.rows": BATCH,
                "blind_rotate.persistent": 0}
        got = {k: launched[k] for k in want}
        log(f"{'nmux' if negate else 'mux'} at cggi19, {BATCH} rows: "
            f"{seconds * 1e3:.1f} ms (host clock), counts {got} {tag}")
        if got != want:
            bad.append(f"counts {got}, want {want}")
        outs[negate] = H.Session.from_port(out.data)
    del ctx, port
    torch.cuda.empty_cache()
    for negate, got in outs.items():
        ref = M.mux(p, ek, *cts, negate=negate)
        mismatched = int((got != ref).sum())
        wrong = int((R.decrypt_bits(sk, got)
                     != M.plain_mux(*bits, negate=negate)).sum())
        log(f"{'nmux' if negate else 'mux'} at cggi19 vs "
            f"fhebench/reference/mux.py: {mismatched} mismatched words of "
            f"{got.numel()}, {wrong} wrong bits of {BATCH}")
        if mismatched or wrong:
            bad.append(f"{mismatched} mismatched words, {wrong} wrong bits")
    if bad:
        raise AssertionError(f"mux at cggi19: {'; '.join(bad)}")


def phase_profile(ctx, sk, tag: str) -> None:
    """10. One lvl0 NAND at batch 4096 under torch.profiler: device time
    and launches of the product kernel, of rotdec_kernel and of the key
    switch (the kernels key_switch launches when profiled alone at the
    gate's shape), and the device's idle share over the gate."""
    import numpy as np
    import cufhe_tpu_torch as T
    from cufhe_tpu_torch.benchmarks import rotdec as RD
    from cufhe_tpu_torch.benchmarks.rotation import (
        bound, random_rotation_inputs)
    from cufhe_tpu_torch.ops.keyswitch import key_switch
    from cufhe_tpu_torch.ops.poly import sample_extract_for_ks

    params = ctx.params
    rng = np.random.default_rng(12)
    a, b = (T.encrypt_bits(rng.integers(0, 2, BATCH), sk, rng, device=DEV)
            for _ in range(2))
    acc, _ = random_rotation_inputs(params, BATCH, 13, DEV)
    tlwe1 = sample_extract_for_ks(acc, params.lvl1)

    ks, ks_busy, _ = profile_kernels(
        lambda: key_switch(tlwe1, ctx.keys.ksk_tiles, params))
    per, busy, wall = profile_kernels(lambda: ctx.nand(a, b))
    if not per:
        raise AssertionError("torch.profiler recorded no device kernels")
    groups = {"product (extprod_kernel)": [0.0, 0],
              "rotdec_kernel": [0.0, 0],
              "key switch (kernels of key_switch)": [0.0, 0],
              "everything else": [0.0, 0]}
    for name, (ms, n) in per.items():
        key = ("product (extprod_kernel)" if "extprod_kernel" in name
               else "rotdec_kernel" if "rotdec_kernel" in name
               else "key switch (kernels of key_switch)" if name in ks
               else "everything else")
        groups[key][0] += ms
        groups[key][1] += n
    log(f"profile, one lvl0 NAND at batch {BATCH}, {params.name}: host "
        f"{wall:.1f} ms, device busy {busy:.1f} ms (idle "
        f"{100 * (1 - busy / wall):.2f} %), {sum(n for _, n in per.values())}"
        f" kernels {tag}")
    for key, (ms, n) in groups.items():
        log(f"  {key}: {ms:.2f} ms in {n} launches ({100 * ms / busy:.2f} % "
            f"of busy)")
    log(f"  key_switch alone at the gate's shape: {ks_busy:.3f} ms busy, "
        f"{sum(n for _, n in ks.values())} kernels")
    ms, n = groups["rotdec_kernel"]
    bound_us = bound(0, RD.rotdec_bytes(params, BATCH))[0] * 1e3
    if n:
        log(f"  rotdec_kernel in the gate: {ms / n * 1e3:.2f} us a launch "
            f"against its {bound_us:.2f} us bytes bound "
            f"({100 * bound_us / (ms / n * 1e3):.1f} %)")
    n0 = params.lvl0.dim
    for key in ("product (extprod_kernel)", "rotdec_kernel"):
        if groups[key][1] != n0:
            raise AssertionError(f"profile: {groups[key][1]} launches of "
                                 f"{key}, want {n0}")
    ks_launches = sum(n for name, (_, n) in per.items()
                      if "keyswitch_kernel" in name)
    library = [name for name in per if "gemm" in name or "cutlass" in name]
    if ks_launches != 1 or library:
        raise AssertionError(f"profile: {ks_launches} keyswitch_kernel "
                             f"launches (want 1), library kernels {library}")


def sass_mma_counts(sass: str, opcode: str = "IMMA") -> dict:
    """{kernel instance: instructions of `opcode`} in cuobjdump -sass
    output: IMMA, the warp-level int8 MMA (mma.sync), or IGMMA, the
    warpgroup int8 MMA that wgmma s8 compiles to. Loops count once: these
    are the unrolled bodies."""
    import re
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            k = re.search(r"([a-z_]+_kernel)I((?:Li\d+E)+)E", m.group(1))
            name = (f"{k.group(1)}<"
                    f"{', '.join(re.findall(r'Li(\d+)E', k.group(2)))}>"
                    if k else None)
            if name:
                counts[name] = 0
        elif name and re.search(rf"\b{opcode}\.", line):
            counts[name] += 1
    return counts


def library_sass(lib_path) -> str:
    """cuobjdump -sass of the built library. cuobjdump ships beside nvcc,
    which has just built the library, so its absence or failure raises,
    as does output without an extprod_kernel instance."""
    import shutil
    import subprocess
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        raise FileNotFoundError(f"no cuobjdump beside nvcc ({tool})")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    if "extprod_kernel" not in sass:
        raise AssertionError(f"cuobjdump -sass {lib_path} shows no "
                             f"extprod_kernel instance")
    return sass


def phase_pallas3(ek, sk, p5, tag: str) -> dict:
    """20. The reduced-precision pallas3 path: the three-limb instances of
    extprod_kernel against the plain version bit for bit (PALLAS3_SETS);
    every instance's IGMMA and IMMA counts; both key precisions timed in
    turns (benchmarks/rotation.py); a batch-4096 NAND chain on a pallas3
    Context on phase 5's inputs with its decrypt errors and launches (the
    three-limb instance and the key switch once a gate, the exact instance
    never); one profiled pallas3 NAND (one keyswitch_kernel launch, no
    library GEMM); the margins at batch 2048 (benchmarks/noise.py) beside
    the JAX record. Returns the kernels line's blind_rotate_pallas3
    entry."""
    import warnings
    import numpy as np
    import torch
    import cufhe_tpu_torch as T
    from cufhe_tpu_torch import _build
    from cufhe_tpu_torch.bench import expected_nand_chain, time_nand_chain
    from cufhe_tpu_torch.benchmarks import rotation as RT
    from cufhe_tpu_torch.benchmarks.noise import centered_phases, measure_noise
    from cufhe_tpu_torch.ops import blind_rotate as BR
    from cufhe_tpu_torch.utils.spans import counts

    max_err, plain_ms = 0, None
    for name, rows_list in PALLAS3_SETS:
        params = T.PRESETS[name]
        key3 = RT.random_keys(params, 800, DEV, [(3, 0)])[3, 0]
        for rows in rows_list:
            acc, abar = RT.random_rotation_inputs(params, rows, 700 + rows,
                                                  DEV)
            want, ms = cuda_ms(lambda: BR.blind_rotate_ref(acc, abar, key3,
                                                           params))
            if name == T.TFHEPP_128.name and rows == BATCH:
                plain_ms = ms
            got = BR.blind_rotate_cuda(acc, abar, key3, params)
            torch.cuda.synchronize()
            err = u32_max_abs_err(got, want)
            log(f"pallas3 kernel (3 limbs) vs plain {name}, {rows} rows: "
                f"max_abs_err {err}")
            if err:
                raise AssertionError(f"the three-limb kernel disagrees at "
                                     f"{name}, {rows} rows")
            max_err = max(max_err, err)
            del acc, abar, want, got
        del key3

    sass = library_sass(_build.build_dir() / _build.LIB_NAME)
    gmma, imma = ({k: v for k, v in sass_mma_counts(sass, op).items()
                   if k.startswith("extprod")} for op in ("IGMMA", "IMMA"))
    log(f"SASS per unrolled stage (cuobjdump): IGMMA (wgmma s8) "
        f"{json.dumps(gmma)}, IMMA (mma.sync) {json.dumps(imma)}")
    if (set(gmma) != set(EXTPROD_INSTANCES) or any(imma.values())
            or not all(gmma.values())):
        raise AssertionError("an extprod_kernel instance is missing, holds "
                             "an IMMA or no IGMMA")
    # per stage, at the same tile: NL wgmma a k-step
    if (4 * gmma["extprod_kernel<3, 128, 0>"]
            != 3 * gmma["extprod_kernel<4, 128, 0>"]):
        raise AssertionError("the three-limb instance does not issue 3/4 of "
                             "the four-limb instance's MMAs")
    # a leaf's stage is the depth-0 stage: the same MMAs
    if len({gmma[f"extprod_kernel<4, 128, {d}>"] for d in range(3)}) != 1:
        raise AssertionError("a Karatsuba instance issues other MMAs a "
                             "stage than the depth-0 one")

    recs = {(r["nlimbs"], r["depth"]): r
            for r in RT.measure(T.TFHEPP_128, BATCH)}
    for (nl, depth), r in recs.items():
        log(f"rotation at B={BATCH}, {T.TFHEPP_128.name}, {nl} limbs, "
            f"Karatsuba depth {depth}: "
            f"{r['ms']:.1f} ms (reps "
            f"{[round(t, 1) for t in r['ms_reps']]}), "
            f"{r['tmacs_per_sec']:.2f} int8 TMAC/s, bound "
            f"{r['bound_ms']:.1f} ms ({r['bound_by']}), "
            f"{100 * r['share_of_bound']:.1f} % of it; library "
            f"torch._int_mm x n0 {r['library_ms']:.1f} ms; profiled, the "
            f"product {r['product_ms_a_launch']:.4f} ms a launch "
            f"({100 * r['product_share_of_bound']:.1f} % of its bound), "
            f"rotdec_kernel {r['rotdec_us_a_launch']:.2f} us {tag}")
    mine = recs[3, 0]

    bits0, bits1, a, b, exact, _, gate_rate = p5
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ctx3 = T.Context(ek, "pallas3")
    log(f"Context(ek, 'pallas3') warned: {str(caught[0].message)!r}")
    if ctx3.keys.bk_ext.shape[3] != 3:
        raise AssertionError("a pallas3 context holds a four-limb key")
    key_mb = ctx3.keys.bk_ext.numel() / 1e6
    torch.cuda.synchronize()
    before = counts()
    first = ctx3.nand(a, b)
    out, times = time_nand_chain(ctx3, first, b, ITERS, REPS)
    gates = 1 + ITERS * REPS
    launched = counts() - before
    launches = {nl: launched[f"blind_rotate.limbs{nl}"] for nl in (3, 4)}
    errors = int(np.sum(T.decrypt_bits(out, sk)
                        != expected_nand_chain(bits0, bits1, gates)))
    rate = BATCH / statistics.median(times)
    diff = centered_phases(first, sk) - centered_phases(exact, sk)
    diff = (diff + (1 << 31)) % (1 << 32) - (1 << 31)
    log(f"pallas3 main path: {gates} chained NANDs at batch {BATCH}, "
        f"{ek.params.name}, phase 5's inputs: decrypt errors {errors}, "
        f"launches {launches[3]} of the three-limb instance, {launches[4]} "
        f"of the four-limb one; {rate:.2f} gates/s "
        f"({100 * rate / gate_rate:.2f} % of phase 5; reps "
        f"{[round(t * 1e3, 1) for t in times]} ms); key {key_mb:.1f} MB; "
        f"phase distance of the first NAND to the exact one: std "
        f"2^{np.log2(max(diff.std(), 1)):.2f}, max "
        f"2^{np.log2(max(np.abs(diff).max(), 1)):.2f} {tag}")
    if (errors or launches != {3: gates, 4: 0}
            or launched["key_switch"] != gates):
        raise AssertionError("the pallas3 main path failed its checks")

    per, busy, wall = profile_kernels(lambda: ctx3.nand(a, b))
    groups = {"extprod_kernel (3 limbs)": [0.0, 0], "rotdec_kernel": [0.0, 0],
              "keyswitch_kernel": [0.0, 0], "everything else": [0.0, 0]}
    for name, (ms, n) in per.items():
        key = ("extprod_kernel (3 limbs)" if "extprod_kernel" in name
               else "rotdec_kernel" if "rotdec_kernel" in name
               else "keyswitch_kernel" if "keyswitch_kernel" in name
               else "everything else")
        groups[key][0] += ms
        groups[key][1] += n
    log(f"profile, one pallas3 NAND at batch {BATCH}: host {wall:.1f} ms, "
        f"device busy {busy:.1f} ms (idle {100 * (1 - busy / wall):.2f} %) "
        f"{tag}")
    for key, (ms, n) in groups.items():
        log(f"  {key}: {ms:.2f} ms in {n} launches ({100 * ms / busy:.2f} % "
            f"of busy)")
    if groups["extprod_kernel (3 limbs)"][1] != ek.params.n0:
        raise AssertionError("profile: the pallas3 NAND did not launch the "
                             "product once a step")
    library = [name for name in per if "gemm" in name or "cutlass" in name]
    if groups["keyswitch_kernel"][1] != 1 or library:
        raise AssertionError(f"profile: {groups['keyswitch_kernel'][1]} "
                             f"keyswitch_kernel launches in the pallas3 NAND "
                             f"(want 1), library kernels {library}")
    del ctx3, first, out

    noise = measure_noise(T.TFHEPP_128, "pallas3", batch=2048, ek=ek, sk=sk)
    log(f"pallas3 noise at batch 2048: std 2^{noise['noise_std_log2']}, "
        f"decrypt margin {noise['decrypt_margin_sigmas']} sigma, worst-gate "
        f"(XOR) margin {noise['worst_gate_margin_sigmas']} sigma, decrypt "
        f"errors {noise['decrypt_errors']}, wrong XORs of bootstrapped "
        f"outputs {noise['xor_of_bootstrapped_errors']} of 2048; the JAX "
        f"record (benchmarks/BENCHMARKS.md:67): 2^26.13, 7.3, 2.6 sigma "
        f"{tag}")
    if noise["decrypt_errors"]:
        raise AssertionError("pallas3 NANDs decrypt wrong")
    return {"name": "blind_rotate_pallas3", "route": "cuda",
            "instruction": "wgmma", "source": SOURCE, "replaces": REPLACES,
            "launches": launches[3],
            "max_abs_err": max_err, "ms": mine["ms"], "plain_ms": plain_ms,
            "bound_ms": mine["bound_ms"], "bound_by": mine["bound_by"],
            "library_ms": mine["library_ms"],
            "ms_four_limbs": recs[4, BR.kar_depth(T.TFHEPP_128)]["ms"],
            "gates_per_sec": rate, "noise": noise}


def main() -> int:
    started = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import numpy as np

    import cufhe_tpu_torch as T
    from cufhe_tpu_torch import _build
    from cufhe_tpu_torch import golden as G
    from cufhe_tpu_torch.bench import (card, expected_nand_chain,
                                       time_nand_chain)
    from cufhe_tpu_torch.benchmarks import keyswitch as KSB
    from cufhe_tpu_torch.benchmarks import rotdec as RD
    from cufhe_tpu_torch.benchmarks.rotation import (
        bound, random_rotation_inputs, rotation_work)
    from cufhe_tpu_torch.models.integers import IntContext, encrypt_uint
    from cufhe_tpu_torch.ops import blind_rotate as BR
    from cufhe_tpu_torch.ops import keyswitch as KS
    from cufhe_tpu_torch.ops.keys import prepare_keys
    from cufhe_tpu_torch.ops.poly import sample_extract_for_ks
    from cufhe_tpu_torch.torus import to_u32
    from cufhe_tpu_torch.utils.spans import counts

    dev = torch.device("cuda")
    info = card()
    tag = f"[{info['name']}, power limit {info['power_limit']}]"
    log(info["nvidia_smi"])

    # 2. build
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.3f} s {tag} ({_build.build_dir()})")
    build_log = (_build.build_dir() / "build.log").read_text()
    report = ptxas_report(build_log)
    for name, regs, spills in report:
        log(f"  {name}: {regs} registers, spills: {spills}")
        if not spills.startswith("0 bytes spill stores, 0 bytes spill loads"):
            raise AssertionError(f"{name} spills registers")
    for want in ("extprod_kernel", "rotdec_kernel", "keyswitch_kernel",
                 "mxu_peak_kernel", "mxu_peak_wgmma_kernel"):
        if not any(name.split("<")[0] == want for name, _, _ in report):
            raise AssertionError(f"no ptxas report for {want}")
    for want in EXTPROD_INSTANCES + PERSISTENT_INSTANCES:
        if not any(name == want for name, _, _ in report):
            raise AssertionError(f"no ptxas report for {want}")
    for line in ptxas_warnings(build_log):
        log(f"  {line}")
        if "C7508" in line:
            raise AssertionError("ptxas ignored setmaxnreg (C7508)")
        if "wgmma" in line and "serialized" in line:
            raise AssertionError(f"ptxas serialised wgmma: {line}")

    # 3. kernels vs plain versions at ten parameter sets, 1 to 129 rows
    max_err = rotdec_err = 0
    presets = (T.PALLAS_TINY, T.PALLAS_TINY_K2, T.PALLAS_BG10, T.TINY,
               T.TFHEPP_128, *(T.PRESETS[name] for name in FULL_PRESETS))
    eks = {}
    for i, params in enumerate(presets):
        sk = G.keygen(params, seed=100 + i)
        ek = G.make_eval_key(sk, seed=200 + i)
        eks[params.name] = (sk, ek)
        keys = prepare_keys(ek, dev)
        for rows in (1, 8, 65, 129):
            acc, abar = random_rotation_inputs(params, rows, 300 + i, dev)
            before = counts()["blind_rotate"]
            got = BR.blind_rotate_cuda(acc, abar, keys.bk_ext, params)
            want = BR.blind_rotate_ref(acc, abar, keys.bk_ext, params)
            torch.cuda.synchronize()
            err = u32_max_abs_err(got, want)
            launched = counts()["blind_rotate"] - before
            log(f"kernel vs plain {params.name}, {rows} rows: max_abs_err "
                f"{err} (launches {launched})")
            if err != 0 or launched != 1:
                raise AssertionError(f"kernel disagrees at {params.name}")
            max_err = max(max_err, err)
            acc, abar_i = RD.random_inputs(params, rows, 500 + i, dev)
            before = counts()["rotdec"]
            got = BR.rotdec_cuda(acc, abar_i, params)
            want = BR.leaf_operands(BR.rotdec_ref(acc, abar_i, params),
                                    BR.kar_depth(params))
            torch.cuda.synchronize()
            err = int((got.int() - want.int()).abs().max())
            launched = counts()["rotdec"] - before
            log(f"rotdec vs plain {params.name}, {rows} rows: max_abs_err "
                f"{err} (launches {launched})")
            if err != 0 or launched != 1:
                raise AssertionError(f"rotdec kernel disagrees at "
                                     f"{params.name}")
            rotdec_err = max(rotdec_err, err)
        del keys

    # 4. the gate vs the golden model at tfhepp_128bit
    sk, ek = eks[T.TFHEPP_128.name]
    t0 = time.perf_counter()
    ctx = T.Context(ek)                 # keys on the card by default
    torch.cuda.synchronize()
    log(f"key preparation and upload at {T.TFHEPP_128.name}: "
        f"{time.perf_counter() - t0:.3f} s (host clock)")
    rng = np.random.default_rng(7)
    bits0, bits1 = [0, 1, 0, 1], [0, 0, 1, 1]
    a = T.encrypt_bits(bits0, sk, rng, device="cuda")
    b = T.encrypt_bits(bits1, sk, rng, device="cuda")
    got = to_u32(ctx.nand(a, b).data)
    want = np.stack([G.gate_lvl0("nand", x, y, ek)
                     for x, y in zip(to_u32(a.data), to_u32(b.data))])
    if not np.array_equal(got, want):
        raise AssertionError("nand disagrees with golden.gate_lvl0")
    log(f"nand vs golden.gate_lvl0 at {T.TFHEPP_128.name}: equal as uint32 "
        f"on {len(bits0)} input pairs, decrypts {G.decrypt_bit_batch(got, sk)}")

    # 5. the main path, counted
    rng = np.random.default_rng(8)
    bits0 = rng.integers(0, 2, BATCH)
    bits1 = rng.integers(0, 2, BATCH)
    before = counts()
    a = T.encrypt_bits(bits0, sk, rng)  # on the card by default
    b = T.encrypt_bits(bits1, sk, rng)
    first = ctx.nand(a, b)
    out, times = time_nand_chain(ctx, first, b, ITERS, REPS)
    bits = T.decrypt_bits(out, sk)
    launched = counts() - before
    launches, rotdec_launches = launched["blind_rotate"], launched["rotdec"]
    ks_launches = launched["key_switch"]
    gates = 1 + ITERS * REPS
    errors = int(np.sum(bits != expected_nand_chain(bits0, bits1, gates)))
    dt = statistics.median(times)
    gate_rate = BATCH / dt
    log(f"main path: {gates} chained NANDs at batch {BATCH}, "
        f"{T.TFHEPP_128.name}: decrypt errors {errors}, kernel launches "
        f"{launches} (rotdec_kernel {rotdec_launches}, keyswitch_kernel "
        f"{ks_launches}); {BATCH / dt:.2f} "
        f"gates/s ({dt * 1e3:.1f} ms per batch, reps "
        f"{[round(t * 1e3, 1) for t in times]} ms) {tag}")
    if (errors or launches != gates or ks_launches != gates
            or rotdec_launches != gates * T.TFHEPP_128.n0
            or launched["blind_rotate.persistent"]
            or launched["blind_rotate.persistent_groups"]):
        raise AssertionError("main path failed its checks")
    p5 = (bits0, bits1, a, b, first, out, gate_rate)

    # 6. one blind rotation at the main path's shape: kernel vs plain
    acc, abar = random_rotation_inputs(T.TFHEPP_128, BATCH, 400, dev)
    got, ms = cuda_ms(lambda: BR.blind_rotate_cuda(acc, abar, ctx.keys.bk_ext,
                                                   T.TFHEPP_128))
    want, plain_ms = cuda_ms(lambda: BR.blind_rotate_ref(
        acc, abar, ctx.keys.bk_ext, T.TFHEPP_128))
    err = u32_max_abs_err(got, want)
    macs, nbytes = rotation_work(T.TFHEPP_128, BATCH)
    bound_ms, bound_by = bound(2 * macs, nbytes)
    log(f"blind rotation at B={BATCH}, {T.TFHEPP_128.name}: kernel "
        f"{ms:.1f} ms ({macs / ms / 1e9:.2f} int8 TMAC/s), plain PyTorch "
        f"{plain_ms:.1f} ms, max_abs_err {err}; bound {bound_ms:.1f} ms "
        f"({bound_by}: {macs:.4g} MACs, {nbytes / 1e6:.1f} MB) {tag}")
    if err != 0:
        raise AssertionError("kernel disagrees at the main path's shape")
    max_err = max(max_err, err)
    # yardstick: the library's int8 product at one step's shape, x n0
    n0, lp = T.TFHEPP_128.lvl0.dim, T.TFHEPP_128.lvl1
    M, Wc = BATCH, (lp.k + 1) * 4 * lp.n        # columns (o, limb, c)
    Kc = (lp.k + 1) * lp.l * lp.n               # contraction I * N
    a8 = torch.randint(-128, 128, (M, Kc), dtype=torch.int8, device=dev)
    b8 = torch.randint(-128, 128, (Kc, Wc), dtype=torch.int8, device=dev)
    torch._int_mm(a8, b8)
    _, step_ms = cuda_ms(lambda: torch._int_mm(a8, b8), 5)
    library_ms = step_ms * n0
    log(f"library yardstick: torch._int_mm [{M}, {Kc}] @ [{Kc}, {Wc}] "
        f"{step_ms:.3f} ms x {n0} steps = {library_ms:.1f} ms "
        f"({macs / library_ms / 1e9:.2f} TMAC/s) {tag}")
    del a8, b8, got, want
    # the rotate-and-decompose kernel alone, at the main path's shape and
    # at batch 1 (measure holds each case to rotdec_ref first)
    rotdec = {rows: RD.measure(T.TFHEPP_128, rows, ROTDEC_LAUNCHES)
              for rows in (BATCH, 1)}
    acc, abar_i = RD.random_inputs(T.TFHEPP_128, BATCH, 5, dev)
    _, rotdec_plain_ms = cuda_ms(
        lambda: BR.rotdec_ref(acc, abar_i, T.TFHEPP_128), 5)
    for rows, rec in rotdec.items():
        log(f"rotdec_kernel at B={rows}, {T.TFHEPP_128.name}: median of "
            f"{ROTDEC_LAUNCHES} launches {rec['warm_ms'] * 1e3:.2f} us "
            f"({rec['warm_gb_s']:.1f} GB/s), after an L2 flush "
            f"{rec['cold_ms'] * 1e3:.2f} us; bound {rec['bound_ms'] * 1e3:.3g}"
            f" us (bytes: {rec['bytes'] / 1e6:.3g} MB), "
            f"{100 * rec['warm_share_of_bound']:.1f} % of it {tag}")
    log(f"rotdec_ref at B={BATCH}: {rotdec_plain_ms * 1e3:.1f} us (CUDA "
        f"events) {tag}")
    del acc, abar_i
    # the key switch kernel on the context's KSK at the main path's rows
    # and an AES step's, against its plain version; then alone (measure
    # holds each case to the plain version first, on a random KSK)
    ks_err = 0
    for rows in (BATCH, KS_AES_ROWS):
        acc, _ = random_rotation_inputs(T.TFHEPP_128, rows, 600 + rows, dev)
        tlwe1 = sample_extract_for_ks(acc, T.TFHEPP_128.lvl1)
        got = KS.key_switch_cuda(tlwe1, ctx.keys.ksk_tiles, T.TFHEPP_128)
        want = KS.key_switch_ref(tlwe1, ctx.keys.ksk_tiles, T.TFHEPP_128)
        err = u32_max_abs_err(got, want)
        log(f"keyswitch_kernel vs plain at {rows} rows, "
            f"{T.TFHEPP_128.name}, the context's KSK: max_abs_err {err}")
        if err != 0:
            raise AssertionError(f"keyswitch_kernel disagrees at {rows} rows")
        ks_err = max(ks_err, err)
        del acc, tlwe1, got, want
    ksw = {rows: KSB.measure(T.TFHEPP_128, rows, KS_LAUNCHES)
           for rows in (BATCH, KS_AES_ROWS)}
    for rows, rec in ksw.items():
        log(f"keyswitch_kernel at B={rows}, {T.TFHEPP_128.name} (row tile "
            f"{rec['row_tile']}, split {rec['split']}): median of "
            f"{KS_LAUNCHES} launches {rec['warm_ms'] * 1e3:.2f} us, after an "
            f"L2 flush {rec['cold_ms'] * 1e3:.2f} us; bound "
            f"{rec['bound_ms'] * 1e3:.2f} us ({rec['bound_by']}), "
            f"{100 * rec['warm_share_of_bound']:.1f} % of it; plain "
            f"{rec['plain_ms']:.3f} ms (CUDA events) {tag}")

    # 7. the tensor-core probe; 8. and 9. the bootstrapping paths
    seconds = {"1-6": time.perf_counter() - started}

    def phase(name, fn, *args):
        """fn(*args), its host seconds kept under `name`."""
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    probe = phase("7", phase_probe, info, tag)
    phase("8", phase_tiny_paths)
    ictx = IntContext(ctx)
    spawn = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(WORKERS, mp_context=spawn,
                             initializer=_pool_init, initargs=(ek,)) as pool:
        phase("9", phase_full_width, ctx, sk, ek, pool, tag)
        # phase 15's golden ripple runs in the pool while the card works
        rng = np.random.default_rng(20)
        xs8, ys8 = ([int(v) for v in rng.integers(0, 256, INT_BATCH)]
                    for _ in range(2))
        x8, y8 = (encrypt_uint(v, 8, sk, rng=rng, device=DEV)
                  for v in (xs8, ys8))
        gold_add8 = pool.submit(_g_add_ripple, to_u32(x8.digits[0]),
                                to_u32(y8.digits[0]), to_u32(ictx._tv_add))
        phase("10", phase_profile, ctx, sk, tag)
        # 11.-13. the presets, circuits and streams
        phase("11", phase_presets, eks, tag)
        adder = phase("12", phase_circuits, ctx, sk, gate_rate, tag)
        phase("13", phase_streams, ctx, sk, tag)
        # 15. and 16. integers and TOY8 on phase 4's context; each call's
        # launches are read from the counter, zeroed just before it
        int_launches_run = phase(
            "15", phase_integers, ictx, sk, gate_rate,
            ((x8, y8), (xs8, ys8)), gold_add8, tag)
        # 19. the bench surface and the examples, golden in the pool
        surface_launches_run = phase("19", phase_surface, ctx, sk, ek, pool,
                                     info, tag)
    toy8_launches_run = phase("16", phase_toy8, ctx, sk, gate_rate, tag)
    # 17. and 18. the ntt backend and the mesh, on phase 5's inputs
    ntt_launches_run = phase("17", phase_ntt, ctx, sk, ek, p5, tag)
    mesh_launches_run = phase("18", phase_mesh, ctx, sk, ek, p5, adder, tag)
    # 20. the reduced-precision pallas3 path, on phase 5's inputs
    pallas3 = phase("20", phase_pallas3, ek, sk, p5, tag)
    # 21. the persistent rotation, on phase 4's context
    persistent = phase("21", phase_persistent, ctx, sk, tag)
    # 22. the MUX at cggi19 against the benchmark's plain reference
    phase("22", phase_mux, tag)
    # 14. the key lifecycle, last: it swaps the context's preset
    phase("14", phase_lifecycle, ctx, sk, ek, eks["concrete"], tag)
    log("host seconds per phase: " + ", ".join(
        f"{name} {s:.1f}" for name, s in seconds.items()))

    for mod in ("jax", "cufhe_tpu"):
        if mod in sys.modules:
            raise AssertionError(f"{mod} was imported")
    log(f"chip_smoke: every phase passed in {time.perf_counter() - started:.1f}"
        f" s (host clock) {tag}")
    log(json.dumps({"kernels": [
        {"name": "blind_rotate", "route": "cuda", "instruction": "wgmma",
         "source": SOURCE, "replaces": REPLACES, "launches": launches,
         "max_abs_err": max_err,
         "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
         "bound_by": bound_by, "library_ms": library_ms,
         "launches_integers": int_launches_run,
         "launches_toy8": toy8_launches_run,
         "launches_ntt": ntt_launches_run,
         "launches_mesh": mesh_launches_run,
         "launches_surface": surface_launches_run},
        {"name": "rotdec", "route": "cuda", "source": SOURCE,
         "replaces": ROTDEC_REPLACES, "launches": rotdec_launches,
         "max_abs_err": rotdec_err, "ms": rotdec[BATCH]["warm_ms"],
         "plain_ms": rotdec_plain_ms, "bound_ms": rotdec[BATCH]["bound_ms"],
         "bound_by": "bytes", "library_ms": None,
         "ms_cold": rotdec[BATCH]["cold_ms"], "ms_batch1": rotdec[1]["warm_ms"]},
        {"name": "key_switch", "route": "cuda", "instruction": "wgmma",
         "source": KS_SOURCE, "replaces": KS_REPLACES,
         "launches": ks_launches, "max_abs_err": ks_err,
         "ms": ksw[BATCH]["warm_ms"], "plain_ms": ksw[BATCH]["plain_ms"],
         "bound_ms": ksw[BATCH]["bound_ms"],
         "bound_by": ksw[BATCH]["bound_by"],
         "library_ms": None,
         "ms_cold": ksw[BATCH]["cold_ms"],
         "ms_aes_rows": ksw[KS_AES_ROWS]["warm_ms"],
         "plain_ms_aes_rows": ksw[KS_AES_ROWS]["plain_ms"],
         "bound_ms_aes_rows": ksw[KS_AES_ROWS]["bound_ms"]},
        {"name": "mxu_peak", "route": "cuda", "source": PROBE_SOURCE,
         "replaces": PROBE_REPLACES, **probe["mma_sync"]},
        {"name": "mxu_peak_wgmma", "route": "cuda", "source": WGMMA_SOURCE,
         "replaces": PROBE_REPLACES, **probe["wgmma"]},
        {key: v for key, v in pallas3.items() if key != "noise"},
        persistent]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
