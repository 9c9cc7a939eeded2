"""ctypes bindings for the native C++ BN254 host-algebra library.

Copy of hekaton_tpu/native/__init__.py whose library is the port's own: it
is built from the repo's native/hekaton_native.cpp into
build/hekaton_tpu_torch/libhekaton_native.so (compiled to a temporary file
and renamed, so that processes building at once never load a partial
library), and never writes the JAX package's native/libhekaton_native.so.
It accelerates the latency-bound host algebra — pairings, G1/G2 scalar muls,
host MSMs — that the reference gets from arkworks' asm field arithmetic
(distributed-prover/Cargo.toml:79). The pure-Python
implementations in curves/host.py and pairing/host.py remain the ground truth
and the fallback when the library is unavailable.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

_LIB = None
_TRIED = False

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "hekaton_native.cpp")
_SO = os.path.join(_REPO_ROOT, "build", "hekaton_tpu_torch", "libhekaton_native.so")
_HASHFILE = _SO + ".srchash"


def _src_hash() -> str | None:
    try:
        with open(_SRC, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()
    except OSError:
        return None


def _build() -> bool:
    # Deliberately no -march=native: the .so must be loadable on any host
    # this repo lands on (the binary is NOT committed; it is rebuilt from
    # source whenever the recorded source hash mismatches).
    if not os.path.exists(_SRC):
        return False
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
            check=True,
            capture_output=True,
            timeout=300,
        )
    except Exception:
        return False
    os.replace(tmp, _SO)
    h = _src_hash()
    if h:
        with open(f"{_HASHFILE}.{os.getpid()}.tmp", "w") as f:
            f.write(h)
        os.replace(f"{_HASHFILE}.{os.getpid()}.tmp", _HASHFILE)
    return True


def _stale() -> bool:
    """Rebuild unless the .so exists AND was built from the current source.

    mtime comparison is unreliable after a fresh clone (checkout flattens
    mtimes), so staleness is keyed on a recorded sha256 of the source.
    """
    if not os.path.exists(_SO):
        return True
    h = _src_hash()
    if h is None:
        return False  # no source to rebuild from; trust the existing .so
    try:
        with open(_HASHFILE) as f:
            return f.read().strip() != h
    except OSError:
        return True


def load():
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("HEKATON_NO_NATIVE"):
        return None
    if _stale():
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    lib.hk_init()
    u8p = ctypes.POINTER(ctypes.c_uint8)
    for name, argn in [
        ("hk_g1_add", 3),
        ("hk_g1_mul", 3),
        ("hk_g2_add", 3),
        ("hk_g2_mul", 3),
        ("hk_pairing", 3),
        ("hk_gt_pow", 3),
        ("hk_gt_mul", 3),
    ]:
        getattr(lib, name).argtypes = [ctypes.c_char_p] * (argn - 1) + [u8p]
        getattr(lib, name).restype = None
    for name in ["hk_g1_msm", "hk_g2_msm", "hk_g1_mul_batch", "hk_g2_mul_batch", "hk_multi_pairing"]:
        getattr(lib, name).argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t, u8p]
        getattr(lib, name).restype = None
    _LIB = lib
    return lib


def available() -> bool:
    return load() is not None
