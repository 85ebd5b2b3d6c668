"""chip_smoke.py's bookkeeping, on the CPU: the ptxas report that its
build phase fails on when a kernel spills, and the bounds it prints beside
the kernels' times (the least time an H100 could take for their work)."""
import importlib.util
import pathlib

import pytest

from cufhe_tpu_torch import params as P

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
    """One rotation at batch 4096: 636 steps of a 4096 x 6144 x 8192 int8
    product, 132.5 ms at 1,979 dense int8 TOPS; its 140 MB of device
    memory would take 0.04 ms."""
    macs, nbytes = smoke.rotation_work(P.TFHEPP_128, 4096)
    assert macs == 4096 * 6144 * 8192 * 636
    assert nbytes == 2 * 4096 * 2 * 1024 * 4 + 636 * 4096 * 4 \
        + 636 * 6 * 2 * 4 * 2048
    ms, by = smoke.bound(2 * macs, nbytes)
    assert by == "operations" and ms == pytest.approx(132.508, abs=1e-3)
    assert smoke.bound(0, nbytes) == (pytest.approx(nbytes / 3.35e9), "bytes")


@pytest.mark.parametrize("params", [P.PALLAS_BG10, P.TINY_K2],
                         ids=lambda p: p.name)
def test_rotation_work_counts_sub_digit_rows_and_components(params):
    """I = (k+1) * l * nd rows of the contraction, (k+1) * 4 * N columns."""
    lp = params.lvl1
    nd = 2 if lp.Bgbit > 8 else 1
    macs, _ = smoke.rotation_work(params, 3)
    assert macs == 3 * ((lp.k + 1) * lp.l * nd * lp.n) \
        * ((lp.k + 1) * 4 * lp.n) * params.n0


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
