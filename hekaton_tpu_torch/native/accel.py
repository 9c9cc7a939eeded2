"""Native-accelerated drop-in implementations of the host algebra functions.

Same Python-level types as curves/host.py and pairing/host.py (G1 = (int, int)
tuples, G2 = (Fq2, Fq2) tuples, None = infinity, Fq12 tower elements); the
arithmetic runs in native/hekaton_native.cpp. Buffers are the library's
little-endian codecs.
"""
from __future__ import annotations

import ctypes

from ..fields.host import Fq2, Fq12
from . import load

_lib = load()


def _buf(n):
    return (ctypes.c_uint8 * n)()


def g1_enc(pt) -> bytes:
    if pt is None:
        return bytes(64)
    return pt[0].to_bytes(32, "little") + pt[1].to_bytes(32, "little")


def g1_dec(b):
    if not any(b):
        return None
    return (int.from_bytes(b[:32], "little"), int.from_bytes(b[32:64], "little"))


def g2_enc(pt) -> bytes:
    if pt is None:
        return bytes(128)
    x, y = pt
    return (
        x.c0.to_bytes(32, "little")
        + x.c1.to_bytes(32, "little")
        + y.c0.to_bytes(32, "little")
        + y.c1.to_bytes(32, "little")
    )


def g2_dec(b):
    if not any(b):
        return None
    vals = [int.from_bytes(b[i * 32 : (i + 1) * 32], "little") for i in range(4)]
    return (Fq2(vals[0], vals[1]), Fq2(vals[2], vals[3]))


def fq12_enc(f: Fq12) -> bytes:
    return b"".join(c.to_bytes(32, "little") for c in f.to_coeffs())


def fq12_dec(b) -> Fq12:
    return Fq12.from_coeffs(
        [int.from_bytes(b[i * 32 : (i + 1) * 32], "little") for i in range(12)]
    )


def _is_g2(pt) -> bool:
    return isinstance(pt[0], Fq2)


# --- curves.host replacements -------------------------------------------------


def pt_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    out = _buf(128 if _is_g2(p) else 64)
    if _is_g2(p):
        _lib.hk_g2_add(g2_enc(p), g2_enc(q), out)
        return g2_dec(bytes(out))
    _lib.hk_g1_add(g1_enc(p), g1_enc(q), out)
    return g1_dec(bytes(out))


def pt_mul(pt, k: int):
    if pt is None:
        return None
    from ..fields.bn254 import R

    k = k % R
    kb = k.to_bytes(32, "little")
    if _is_g2(pt):
        out = _buf(128)
        _lib.hk_g2_mul(g2_enc(pt), kb, out)
        return g2_dec(bytes(out))
    out = _buf(64)
    _lib.hk_g1_mul(g1_enc(pt), kb, out)
    return g1_dec(bytes(out))


def msm_host(points, scalars):
    from ..fields.bn254 import R

    assert len(points) == len(scalars)
    pairs = [(p, s % R) for p, s in zip(points, scalars) if p is not None]
    if not pairs:
        return None
    n = len(pairs)
    g2 = _is_g2(pairs[0][0])
    enc = g2_enc if g2 else g1_enc
    pts = b"".join(enc(p) for p, _ in pairs)
    ks = b"".join(s.to_bytes(32, "little") for _, s in pairs)
    if g2:
        out = _buf(128)
        _lib.hk_g2_msm(pts, ks, n, out)
        return g2_dec(bytes(out))
    out = _buf(64)
    _lib.hk_g1_msm(pts, ks, n, out)
    return g1_dec(bytes(out))


def mul_batch(points, scalars):
    """Batched per-point scalar mul (scalar_pairing / key-ladder generation)."""
    from ..fields.bn254 import R

    assert len(points) == len(scalars)
    if not points:
        return []
    g2 = _is_g2(next(p for p in points if p is not None)) if any(
        p is not None for p in points
    ) else False
    # native batch path requires no-infinity inputs; route Nones individually
    enc, dec, sz = (g2_enc, g2_dec, 128) if g2 else (g1_enc, g1_dec, 64)
    pts = b"".join(enc(p) for p in points)
    ks = b"".join((s % R).to_bytes(32, "little") for s in scalars)
    out = _buf(sz * len(points))
    fn = _lib.hk_g2_mul_batch if g2 else _lib.hk_g1_mul_batch
    fn(pts, ks, len(points), out)
    ob = bytes(out)
    return [dec(ob[i * sz : (i + 1) * sz]) for i in range(len(points))]


# --- pairing.host replacements -------------------------------------------------


def pairing(p_g1, q_g2) -> Fq12:
    out = _buf(384)
    _lib.hk_pairing(g1_enc(p_g1), g2_enc(q_g2), out)
    return fq12_dec(bytes(out))


def multi_pairing(g1s, g2s) -> Fq12:
    assert len(g1s) == len(g2s)
    n = len(g1s)
    out = _buf(384)
    _lib.hk_multi_pairing(b"".join(g1_enc(p) for p in g1s), b"".join(g2_enc(q) for q in g2s), n, out)
    return fq12_dec(bytes(out))


def gt_pow(f: Fq12, e: int) -> Fq12:
    from ..fields.bn254 import R

    out = _buf(384)
    _lib.hk_gt_pow(fq12_enc(f), (e % R).to_bytes(32, "little"), out)
    return fq12_dec(bytes(out))
