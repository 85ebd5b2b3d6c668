"""chip_smoke.py's bookkeeping, on the CPU: the ptxas report that its
build phase fails on when a kernel spills, and the bounds it prints beside
the kernels' times (the least time an H100 could take for their work)."""
import importlib.util
import pathlib

import pytest

from cufhe_tpu_torch import params as P
from cufhe_tpu_torch.benchmarks import rotation as RT

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parent.parent
    / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(smoke)

_LOG = """\
nvcc -gencode arch=compute_90a,code=sm_90a -c blind_rotate.cu
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__eb88de2c_15_blind_rotate_cu_1b2cd1d314extprod_kernelILi128EEEvPjPKaS3_iiii' for 'sm_90a'
ptxas info    : Function properties for _ZN48_GLOBAL__N__eb88de2c_15_blind_rotate_cu_1b2cd1d314extprod_kernelILi128EEEvPjPKaS3_iiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 126 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__eb88de2c_15_blind_rotate_cu_1b2cd1d313rotdec_kernelEPKjPKiPaiiiiiiiij' for 'sm_90a'
ptxas info    : Function properties for _ZN48_GLOBAL__N__eb88de2c_15_blind_rotate_cu_1b2cd1d313rotdec_kernelEPKjPKiPaiiiiiiiij
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers
"""


def test_ptxas_report_names_registers_and_spills():
    assert smoke.ptxas_report(_LOG) == [
        ("extprod_kernel<128>", 126,
         "0 bytes spill stores, 0 bytes spill loads"),
        ("rotdec_kernel", 32, "4 bytes spill stores, 4 bytes spill loads")]


def test_rotation_bound_at_tfhepp_128():
    """One rotation at batch 4096, fhebench/roofline.py's count: 636 steps
    of 9/16 of a 4096 x 6144 x 8192 int8 product (two levels of
    Karatsuba), 74.5 ms at 1,979 dense int8 TOPS, as the benchmark's
    roofline has it; its 109 MB of device memory would take 0.03 ms."""
    macs, nbytes = RT.rotation_work(P.TFHEPP_128, 4096)
    assert macs == 4096 * 6144 * 8192 * 636 * 9 / 16
    assert nbytes == 2 * 4096 * 2 * 1024 * 4 + 636 * 4096 * 4 \
        + 636 * 6 * 2 * 1024 * 4
    ms, by = RT.bound(2 * macs, nbytes)
    assert by == "operations" and ms == pytest.approx(74.536, abs=1e-3)
    assert RT.bound(0, nbytes) == (pytest.approx(nbytes / 3.35e9), "bytes")


@pytest.mark.parametrize("params", [P.PALLAS_BG10, P.TINY_K2],
                         ids=lambda p: p.name)
def test_rotation_work_counts_sub_digit_rows_and_components(params):
    """(k+1) * l gadget digit rows, one int8 each whatever the sub-digits
    (nd = 2 at Bgbit 10 adds none), (k+1) * 4 * N columns, 9/16 of the
    schoolbook products: the benchmark's fixed count."""
    lp = params.lvl1
    macs, _ = RT.rotation_work(params, 3)
    assert macs == 3 * ((lp.k + 1) * lp.l * lp.n) \
        * ((lp.k + 1) * 4 * lp.n) * params.n0 * 9 / 16


_WGMMA_LOG = """\
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__d51f194e_17_mxu_peak_wgmma_cu_6f77326921mxu_peak_wgmma_kernelILi2ELi256EEEv14CUtensorMap_stS1_PKhPiiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN50_GLOBAL__N__d51f194e_17_mxu_peak_wgmma_cu_6f77326921mxu_peak_wgmma_kernelILi2ELi256EEEv14CUtensorMap_stS1_PKhPiiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 2 barriers
ptxas warning : (C7508) setmaxnreg ignored; unable to determine register count at entry
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__d51f194e_17_mxu_peak_wgmma_cu_6f77326921mxu_peak_wgmma_kernelILi1ELi128EEEv14CUtensorMap_stS1_PKhPiiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN50_GLOBAL__N__d51f194e_17_mxu_peak_wgmma_cu_6f77326921mxu_peak_wgmma_kernelILi1ELi128EEEv14CUtensorMap_stS1_PKhPiiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
nvcc warning : Support for offline compilation for architectures prior to '<compute/sm/lto>_75' will be removed in a future release
"""


def test_ptxas_report_names_both_template_arguments():
    """The wgmma probe kernel is a template of (variant, BN): both show."""
    assert smoke.ptxas_report(_WGMMA_LOG) == [
        ("mxu_peak_wgmma_kernel<2, 256>", 168,
         "0 bytes spill stores, 0 bytes spill loads"),
        ("mxu_peak_wgmma_kernel<1, 128>", 168,
         "0 bytes spill stores, 0 bytes spill loads")]


def test_ptxas_warnings_finds_ignored_setmaxnreg():
    """Phase 2 fails on C7508; nvcc's own warnings are not ptxas's."""
    assert smoke.ptxas_warnings(_WGMMA_LOG) == [
        "ptxas warning : (C7508) setmaxnreg ignored; unable to determine "
        "register count at entry"]
    assert smoke.ptxas_warnings(_LOG) == []


def test_ptxas_report_names_template_instances():
    """rotdec_kernel<L, ND> instances report under their template
    arguments, and phase 2 finds them by the name before the '<'."""
    log = """\
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__eb88de2c_15_blind_rotate_cu_1b2cd1d313rotdec_kernelILi3ELi1EEEvPKjPKiPaiiiiiiiij' for 'sm_90a'
ptxas info    : Function properties for _ZN48_GLOBAL__N__eb88de2c_15_blind_rotate_cu_1b2cd1d313rotdec_kernelILi3ELi1EEEvPKjPKiPaiiiiiiiij
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 28 registers, used 1 barriers
"""
    report = smoke.ptxas_report(log)
    assert report == [("rotdec_kernel<3, 1>", 28,
                       "0 bytes spill stores, 0 bytes spill loads")]
    assert report[0][0].split("<")[0] == "rotdec_kernel"


def test_ptxas_report_names_the_persistent_instances():
    """persistent_extprod_kernel<NL, SEG, D, L, ND> reports under its five
    template arguments, one of phase 2's PERSISTENT_INSTANCES, and phase
    20's SASS count (instances whose name starts with extprod) leaves it
    out."""
    name = ("_ZN48_GLOBAL__N__eb88de2c_15_blind_rotate_cu_1b2cd1d325persistent"
            "_extprod_kernelILi4ELi128ELi2ELi3ELi1EEEv14CUtensorMap_stPjPKiPKa"
            "PaS2_NS_11PersistArgsE")
    log = (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
           f"ptxas info    : Function properties for {name}\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\n"
           "ptxas info    : Used 168 registers, used 2 barriers\n")
    report = smoke.ptxas_report(log)
    assert report == [("persistent_extprod_kernel<4, 128, 2, 3, 1>", 168,
                       "0 bytes spill stores, 0 bytes spill loads")]
    assert report[0][0] in smoke.PERSISTENT_INSTANCES
    assert len(set(smoke.PERSISTENT_INSTANCES)) == 8
    sass = f"        Function : {name}\n        IGMMA.64x64x32.S8.S8 R24\n"
    counts = smoke.sass_mma_counts(sass, "IGMMA")
    assert counts == {"persistent_extprod_kernel<4, 128, 2, 3, 1>": 1}
    assert not [k for k in counts if k.startswith("extprod")]


def test_rotdec_bound_is_the_benchs_bound():
    """Phase 6 (the bench's measure) and phase 10 (bound) hold
    rotdec_kernel against the same device-memory rate, the port's own."""
    from cufhe_tpu_torch.benchmarks import _common
    from cufhe_tpu_torch.benchmarks import rotdec as RD
    assert not hasattr(smoke, "HBM_BYTES_PER_S")
    assert RD.HBM_BYTES_PER_S is _common.HBM_BYTES_PER_S
    nbytes = RD.rotdec_bytes(P.TFHEPP_128, 4096)
    ms, by = RT.bound(0, nbytes)
    assert by == "bytes" and ms == nbytes / RD.HBM_BYTES_PER_S * 1e3


def test_rotation_bound_at_three_limbs():
    """The pallas3 rotation contracts against three limbs: 3/4 of the
    exact rotation's MACs, 55.9 ms at batch 4096 on the same count, the
    same bytes (the uint32 key)."""
    macs, nbytes = RT.rotation_work(P.TFHEPP_128, 4096, 3)
    assert macs == 4096 * 6144 * 6144 * 636 * 9 / 16
    assert 4 * macs == 3 * RT.rotation_work(P.TFHEPP_128, 4096)[0]
    assert nbytes == RT.rotation_work(P.TFHEPP_128, 4096)[1]
    ms, by = RT.bound(2 * macs, nbytes)
    assert by == "operations" and ms == pytest.approx(55.902, abs=1e-3)


_SASS = """\
	code for sm_90a
		Function : _ZN12_GLOBAL__N_114extprod_kernelILi128ELi3ELi1EEEvPjPKaS3_iiii
        /*0a10*/                   IMMA.16832.S8.S8 R24, R100.ROW, R8.COL, R24 ;
        /*0a20*/                   IMMA.16832.S8.S8 R28, R104.ROW, R8.COL, R28 ;
        /*0a30*/                   LDSM.16.M88.4 R100, [R3] ;
		Function : _ZN12_GLOBAL__N_113rotdec_kernelILi3ELi1EEEvPKjPKiPaiiiiiiiij
        /*0100*/                   PRMT R5, R4, 0x40, R6 ;
		Function : _ZN12_GLOBAL__N_114extprod_kernelILi128ELi4ELi1EEEvPjPKaS3_iiii
        /*0a10*/                   IMMA.16832.S8.S8 R24, R100.ROW, R8.COL, R24 ;
"""


def test_sass_mma_counts_per_instance():
    """Phase 20 counts the IMMA instructions of each extprod_kernel
    instance in cuobjdump's SASS, by template arguments."""
    assert smoke.sass_mma_counts(_SASS) == {
        "extprod_kernel<128, 3, 1>": 2, "rotdec_kernel<3, 1>": 0,
        "extprod_kernel<128, 4, 1>": 1}
    assert smoke.sass_mma_counts("") == {}


_SASS_WGMMA = """\
	code for sm_90a
		Function : _ZN48_GLOBAL__N__eb88de2c_15_blind_rotate_cu_1b2cd1d314extprod_kernelILi3ELi128EEEv14CUtensorMap_stPjPKaiiii
        /*0a10*/                   IGMMA.64x64x32.S8.S8 R24, R100, gdesc[UR4], R24, gsb0 ;
        /*0a20*/                   PRMT R5, R4, 0x123, R6 ;
        /*0a30*/                   IGMMA.64x64x32.S8.S8 R56, R104, gdesc[UR4], R56, gsb0 ;
		Function : _ZN48_GLOBAL__N__eb88de2c_15_blind_rotate_cu_1b2cd1d314extprod_kernelILi4ELi128EEEv14CUtensorMap_stPjPKaiiii
        /*0a10*/                   IGMMA.64x64x32.S8.S8 R24, R100, gdesc[UR4], R24, gsb0 ;
        /*0a20*/                   IMMA.16832.S8.S8 R24, R100.ROW, R8.COL, R24 ;
"""


def test_sass_mma_counts_of_warpgroup_mma():
    """Phase 20 counts IGMMA (wgmma s8) and IMMA (mma.sync) apart, by
    the wgmma instances' template arguments <NL, SEG>."""
    assert smoke.sass_mma_counts(_SASS_WGMMA, "IGMMA") == {
        "extprod_kernel<3, 128>": 2, "extprod_kernel<4, 128>": 1}
    assert smoke.sass_mma_counts(_SASS_WGMMA) == {
        "extprod_kernel<3, 128>": 0, "extprod_kernel<4, 128>": 1}
    assert smoke.sass_mma_counts(_SASS, "IGMMA") == {
        "extprod_kernel<128, 3, 1>": 0, "rotdec_kernel<3, 1>": 0,
        "extprod_kernel<128, 4, 1>": 0}


def test_ptxas_warnings_finds_serialised_wgmma():
    """Phase 2 fails where ptxas serialised wgmma, a note it prints as
    info."""
    line = ("ptxas info    : (C7511) Potential Performance Loss: "
            "wgmma.mma_async instructions are serialized due to "
            "insufficient register resources for the wgmma pipeline in the "
            "function '_ZN48_GLOBAL__N__eb88de2c_15_blind_rotate_cu_1b2cd1d3"
            "14extprod_kernelILi4ELi64EEEv14CUtensorMap_stPjPKaiiii'")
    assert smoke.ptxas_warnings(_LOG + line + "\n") == [line]


def test_pallas3_sets_are_presets_with_n_128_or_more():
    """Phase 20's sets exist, take the three-limb key (N >= 128), and the
    full-width ones include the main path's batch."""
    from cufhe_tpu_torch.ops.blind_rotate import check_key_limbs
    for name, rows in smoke.PALLAS3_SETS:
        check_key_limbs(3, P.PRESETS[name])
        assert rows
    full = [name for name, rows in smoke.PALLAS3_SETS if smoke.BATCH in rows]
    assert full == ["tfhepp_128bit", "tfhepp_80bit"]


def test_library_sass_raises_without_a_dump(tmp_path):
    """Phase 20's MMA count cannot be skipped: library_sass raises where
    cuobjdump is missing, fails, or dumps no extprod_kernel instance."""
    import subprocess
    with pytest.raises((FileNotFoundError, subprocess.CalledProcessError,
                        AssertionError)):
        smoke.library_sass(tmp_path / "missing.so")
