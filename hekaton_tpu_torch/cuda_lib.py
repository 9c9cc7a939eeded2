"""Build and load the port's CUDA kernels (hekaton_tpu_torch/csrc/*.cu).

The sources compile with nvcc into one shared library with a plain C
interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/hekaton_tpu_torch/libhk_<hash>.so csrc/*.cu

The library is keyed by a sha256 of the sources (as hekaton_tpu/native keys
its host library), so an edited source builds a new library at its first
use. Nothing is built at import: the first kernel launch calls `lib()`. A
missing nvcc or a failed build raises with the compiler's output; a build
returns ptxas's per-kernel register and spill report (`-Xptxas -v`).
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC_DIR = os.path.join(_PKG_DIR, "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "hekaton_tpu_torch")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_vp = ctypes.c_void_p
_ll = ctypes.c_longlong
_int = ctypes.c_int
# every kernel entry point: argument types; each returns cudaGetLastError()
SIGNATURES = {
    "hk_mont_mul": [_int, _vp, _vp, _vp, _ll, _ll, _vp],
    "hk_fermat_inv": [_int, _vp, _vp, _ll, _vp],
    "hk_aff_root": [_vp, _vp, _vp, _vp, _vp, _vp, _ll, _ll, _int, _vp],
    "hk_aff_fin": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _ll, _ll, _int, _vp],
    "hk_halves_root": [_vp, _vp, _vp, _ll, _int, _vp],
    "hk_halves_fin": [_vp, _vp, _vp, _vp, _ll, _int, _vp],
    "hk_horner": [_vp, _vp, _vp, _vp, _vp, _vp, _int, _int, _vp],
}

_LIB = None


def sources() -> list:
    return sorted(glob.glob(os.path.join(_SRC_DIR, "*.cu")) + glob.glob(os.path.join(_SRC_DIR, "*.cuh")))


def _src_hash() -> str:
    h = hashlib.sha256()
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (looked on PATH and in /usr/local/cuda/bin)")
    return nvcc


def build() -> tuple:
    """Compile the kernels if no library for these sources exists yet.
    Returns (library path, compiler output of this build or "")."""
    path = os.path.join(_BUILD_DIR, f"libhk_{_src_hash()}.so")
    if os.path.exists(path):
        return path, ""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cu = [p for p in sources() if p.endswith(".cu")]
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}\n{proc.stdout}")
    os.replace(tmp, path)
    return path, proc.stderr + proc.stdout


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _LIB
    if _LIB is None:
        path, _ = build()
        handle = ctypes.CDLL(path)
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = handle
    return _LIB


def check(name: str, rc: int) -> None:
    """Raise if a kernel launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
