"""Build and load the port's CUDA kernels (csrc/*.cu).

Each source is compiled with nvcc for sm_90a by its own process, all started
together, and the objects are linked into one shared library with a plain C
interface, loaded with ctypes. The build happens at first use, into
_build/<hash of the sources, the csrc/*.cuh headers they include and the
flags>/ beside this file, and is reused while those are unchanged. Without
nvcc, or when the build fails, load() raises: there is no fallback.

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

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_NAME = "libcufhe_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
HOST_SRC = _PKG / "runtime" / "_native" / "circuit.cpp"
HOST_LIB_NAME = "libcufhe_circuit.so"
GXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]

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
        lib.cufhe_blind_rotate.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11
            + [ctypes.c_uint, ctypes.c_int, ctypes.c_void_p])
        lib.cufhe_blind_rotate.restype = ctypes.c_int
        lib.cufhe_rotdec.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
            + [ctypes.c_uint, ctypes.c_void_p])
        lib.cufhe_rotdec.restype = ctypes.c_int
        lib.cufhe_key_switch.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_void_p]
            + [ctypes.c_int] * 5 + [ctypes.c_uint] + [ctypes.c_int] * 2
            + [ctypes.c_void_p])
        lib.cufhe_key_switch.restype = ctypes.c_int
        lib.cufhe_mxu_peak.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
            + [ctypes.c_void_p])
        lib.cufhe_mxu_peak.restype = ctypes.c_int
        lib.cufhe_mxu_peak_wgmma.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
            + [ctypes.c_void_p])
        lib.cufhe_mxu_peak_wgmma.restype = ctypes.c_int
        lib.cufhe_error_string.argtypes = [ctypes.c_int]
        lib.cufhe_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


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
