"""Build and load the port's CUDA kernels (csrc/*.cu).

Each source is compiled with nvcc for sm_90a by its own process, all started
together, and the objects are linked into one shared library with a plain C
interface, loaded with ctypes. The build happens at first use, into
_build/<hash of the sources, the csrc/*.cuh headers they include and the
flags>/ beside this file, and is reused while those are unchanged. Without
nvcc, or when the build fails, load() raises: there is no fallback.

This module owns that interface: every launch entry's ctypes signature
(_ENTRIES), the checks a tensor passes before its pointer crosses
(check_cuda), and the launch itself (call), which enters the device, passes
its current stream's handle last and turns a nonzero return code into a
RuntimeError. The kernels' wrappers launch only through call.

load_host() does the same for the host-side circuit scheduler
(runtime/_native/circuit.cpp), with g++ and no CUDA, into
_build/host-<hash>/: the CPU tests use it too.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_NAME = "libcufhe_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
HOST_SRC = _PKG / "runtime" / "_native" / "circuit.cpp"
HOST_LIB_NAME = "libcufhe_circuit.so"
GXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]
#: streaming multiprocessors of an H100 SXM, the launch plans' default
H100_SMS = 132

_I, _U, _P = ctypes.c_int, ctypes.c_uint, ctypes.c_void_p
#: every launch entry's arguments before the stream handle, which each takes
#: last; each returns a cudaError_t (0 on success)
_ENTRIES = {
    "cufhe_blind_rotate": [_P] * 4 + [_I] * 11 + [_U, _I, _I, _P],
    "cufhe_rotdec": [_P] * 3 + [_I] * 9 + [_U],
    "cufhe_key_switch": [_P, _P, _I, _P, _I, _P] + [_I] * 5 + [_U, _I, _I],
    "cufhe_mxu_peak": [_I] + [_P] * 4 + [_I] * 5,
    "cufhe_mxu_peak_wgmma": [_I] * 2 + [_P] * 4 + [_I] * 6,
}

_lib = None
_host_lib = None


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def _headers() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda): "
                       "the CUDA kernels of cufhe_tpu_torch are built from "
                       "csrc/ at first use")


def build_dir() -> Path:
    """The directory this tree's sources build into."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + _headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if this tree has no build yet; return the
    library's path. The compiler's output (ptxas register and shared
    memory use) is kept in build.log beside it."""
    out_dir = build_dir()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    nvcc = _nvcc()
    jobs = []
    for src in _sources():
        obj = out_dir / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        text = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + text)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} ({proc.returncode}):\n{text}")
    tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link ({proc.returncode}):\n"
                          f"{proc.stdout}{proc.stderr}")
    (out_dir / "build.log").write_text("".join(log))
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, lib)           # atomic: concurrent builds agree
    return lib


def load() -> ctypes.CDLL:
    """Build if needed and load the kernel library (once per process)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in _ENTRIES.items():
            fn = getattr(lib, name)
            fn.argtypes = args + [_P]
            fn.restype = _I
        lib.cufhe_error_string.argtypes = [_I]
        lib.cufhe_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def cdiv(a: int, b: int) -> int:
    """ceil(a / b) of ints."""
    return -(-a // b)


def sms(device: torch.device) -> int:
    """The SM count of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def check_cuda(want: dict) -> None:
    """Raise ValueError unless every tensor has its dtype and shape (checked
    first, for all), lies on the first one's CUDA device and is contiguous.
    want: name -> (tensor, dtype, shape)."""
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    device = next(iter(want.values()))[0].device
    for name, (t, _, _) in want.items():
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"{name} must lie on one CUDA device with the "
                             f"others, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def call(entry: str, device: torch.device, *args) -> None:
    """Launch C entry `entry` (one of _ENTRIES) of the kernel library on
    `device`: `args`, then the handle of the device's current stream. The
    work is enqueued on that stream; a nonzero return code raises
    RuntimeError naming the entry and cufhe_error_string's message."""
    lib = load()
    with torch.cuda.device(device):
        rc = getattr(lib, entry)(*args,
                                 torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        msg = lib.cufhe_error_string(rc).decode()
        raise RuntimeError(f"{entry} failed: {msg} ({rc})")


def host_build_dir() -> Path:
    """The directory this tree's host scheduler builds into."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(HOST_SRC.read_bytes())
    return BUILD_DIR / f"host-{h.hexdigest()[:16]}"


def build_host() -> Path:
    """Compile the circuit scheduler with g++ if this tree has no build of
    it yet; return the library's path. Raises if g++ is missing or fails."""
    out_dir = host_build_dir()
    lib = out_dir / HOST_LIB_NAME
    if lib.exists():
        return lib
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("g++ not found: the circuit scheduler of "
                           "cufhe_tpu_torch is built from "
                           "runtime/_native/circuit.cpp at first use")
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{HOST_LIB_NAME}.{os.getpid()}.tmp"
    cmd = [cxx, *GXX_FLAGS, str(HOST_SRC), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)           # atomic: concurrent builds agree
    return lib


def load_host() -> ctypes.CDLL:
    """Build if needed and load the circuit scheduler (once per process)."""
    global _host_lib
    if _host_lib is None:
        _host_lib = ctypes.CDLL(str(build_host()))
    return _host_lib
