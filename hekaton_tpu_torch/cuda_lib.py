"""Build and load the port's CUDA kernels (hekaton_tpu_torch/csrc/*.cu).

The sources compile with nvcc into one shared library with a plain C
interface, loaded with ctypes: one nvcc per source, all started together,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC
         -Xptxas -v -c -o <build>/<source>.o csrc/<source>.cu

then one link, `nvcc -gencode arch=compute_90a,code=sm_90a -shared -o
build/hekaton_tpu_torch/libhk_<hash>.so <build>/*.o`.

`build(swap=paths)` builds the same way with each source swapped for the
path of its file name (a timing script's second library, with older
versions of some sources; a swapped source includes the field.cuh beside
it); `load` opens such a library and `using` makes it the one the
wrappers launch from for a block of code.

The library is keyed by a sha256 of the sources (as hekaton_tpu/native keys
its host library), so an edited source builds a new library at its first
use. Nothing is built at import: the first kernel launch calls `lib()`. A
missing nvcc or a failed build raises with the compiler's output; a build
returns ptxas's per-kernel register and spill report (`-Xptxas -v`), which
it keeps beside the library for later calls.
"""
from __future__ import annotations

import contextlib
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
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", _SRC_DIR]

_vp = ctypes.c_void_p
_ll = ctypes.c_longlong
_int = ctypes.c_int
# every entry point: argument types; each kernel's returns cudaGetLastError()
SIGNATURES = {
    "hk_horner_max_w": [],
    "hk_mont_mul": [_int, _vp, _vp, _vp, _ll, _ll, _vp],
    "hk_fermat_inv": [_int, _vp, _vp, _ll, _vp],
    "hk_aff_root": [_vp] * 7 + [_ll, _ll, _int, _vp],
    "hk_aff_fin": [_vp] * 9 + [_ll, _ll, _int, _vp],
    "hk_aff_root_packed": [_vp] * 6 + [_ll, _ll, _int, _vp],
    "hk_aff_fin_packed": [_vp] * 8 + [_ll, _ll, _int, _vp],
    "hk_aff_prep": [_vp] * 6 + [_ll, _vp],
    "hk_aff_finish": [_vp] * 8 + [_ll, _vp],
    "hk_halves_root": [_vp] * 4 + [_ll, _int, _int, _vp],
    "hk_halves_step": [_vp] * 8 + [_ll, _int, _int, _int, _int, _vp],
    "hk_interleave_slab_t": [_vp, _vp, _int, _int, _int, _vp],
    "hk_horner": [_vp, _vp, _vp, _vp, _vp, _vp, _int, _int, _vp],
    "hk_madd": [_vp] * 8 + [_ll, _vp],
    "hk_dbl": [_vp] * 6 + [_ll, _vp],
    "hk_add": [_vp] * 9 + [_ll, _vp],
    "hk_jac_ladder": [_vp] * 6 + [_ll, _int, _vp],
    "hk_jac_sum": [_vp] * 6 + [_ll, _int, _vp],
    "hk_jac_horner": [_vp] * 6 + [_int, _int, _vp],
    "hk_pmadd_rcb": [_vp] * 8 + [_ll, _vp],
    "hk_padd_rcb": [_vp] * 9 + [_ll, _vp],
    "hk_pdbl_rcb": [_vp] * 6 + [_ll, _vp],
    "hk_l1_rcb_mega": [_vp] * 4 + [_ll, _int, _int, _vp],
    "hk_pmadd_rcb_g2": [_vp] * 8 + [_ll, _vp],
    "hk_padd_rcb_g2": [_vp] * 9 + [_ll, _vp],
    "hk_pdbl_rcb_g2": [_vp] * 6 + [_ll, _vp],
}

_LIB = None


def sources() -> list:
    return sorted(glob.glob(os.path.join(_SRC_DIR, "*.cu")) + glob.glob(os.path.join(_SRC_DIR, "*.cuh")))


def _src_hash(cu: list) -> str:
    h = hashlib.sha256()
    headers = {os.path.join(os.path.dirname(p), os.path.basename(hd)) for p in cu
               for hd in sources() if hd.endswith(".cuh")}
    for path in cu + sorted(hd for hd in headers if os.path.exists(hd)):
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


def build(swap: list = ()) -> tuple:
    """Compile the kernels (csrc/*.cu, each one named like a path of `swap`
    replaced by it) if no library for these sources exists yet. Returns
    (library path, compiler output of the build that made it, kept beside
    the library)."""
    cu = [p for p in sources() if p.endswith(".cu")]
    swaps = {os.path.basename(q): os.path.abspath(q) for q in swap}
    cu = [swaps.get(os.path.basename(p), p) for p in cu]
    path = os.path.join(_BUILD_DIR, f"libhk_{_src_hash(cu)}.so")
    if os.path.exists(path) and os.path.exists(path + ".ptxas.txt"):
        with open(path + ".ptxas.txt") as f:
            return path, f.read()
    os.makedirs(_BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(p) + ".o") for p in cu]
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, p], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for p, o in zip(cu, objs)
        ]
        report = ""
        failed = []
        for p, proc in zip(cu, procs):
            out, _ = proc.communicate()
            report += out
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(p)} ({proc.returncode})")
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{report}")
        so = os.path.join(tmp, "lib.so")
        proc = subprocess.run([nvcc, *ARCH, "-shared", "-o", so, *objs], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}\n{proc.stdout}")
        with open(path + ".ptxas.txt", "w") as f:
            f.write(report)
        os.replace(so, path)
    return path, report


def load(path: str) -> ctypes.CDLL:
    """Open a kernel library and declare its entry points."""
    handle = ctypes.CDLL(path)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return handle


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _LIB
    if _LIB is None:
        _LIB = load(build()[0])
    return _LIB


@contextlib.contextmanager
def using(handle: ctypes.CDLL):
    """Launch every kernel from `handle` inside the block (a library of
    `load`), then from the one before."""
    global _LIB
    before, _LIB = _LIB, handle
    try:
        yield handle
    finally:
        _LIB = before


def check(name: str, rc: int) -> None:
    """Raise if a kernel launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


# each source's occupancy entry point: (i, const char** name, int* blocks)
OCCUPANCY = ("hk_field_occupancy", "hk_curve_occupancy", "hk_curve_g2_occupancy")


def occupancy(handle: ctypes.CDLL) -> dict:
    """{kernel: blocks of it an SM holds at its launch's block size}, CUDA's
    occupancy query through each source's entry point that the library
    `handle` has (an older library may have none)."""
    out = {}
    for entry in OCCUPANCY:
        if not hasattr(handle, entry):
            continue
        fn = getattr(handle, entry)
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        i = 0
        while True:
            name, blocks = ctypes.c_char_p(), ctypes.c_int()
            rc = fn(i, ctypes.byref(name), ctypes.byref(blocks))
            if rc < 0:
                break
            check(entry, rc)
            out[name.value.decode()] = blocks.value
            i += 1
    return out


def aligned(t):
    """The tensor t, or a copy of it where its data does not start on a
    16-byte boundary (a view into its storage): the kernels load and store
    rows 16 bytes at a time, and a fresh allocation is aligned."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
