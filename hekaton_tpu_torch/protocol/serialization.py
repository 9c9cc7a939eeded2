"""Byte serialization for the aggregate proof (and its parts).

The reference serializes the final proof with arkworks CanonicalSerialize and
prints measured compressed/uncompressed sizes
(mpi-snark/src/bin/node.rs:608-617). This module is the
framework's equivalent: a fixed, self-describing little-endian layout over
the compressed/uncompressed point encodings in curves/host.py.

Layout (agg proof):
    u32 MAGIC | u8 version | u8 flags(bit0=compressed) | u16 gipa_rounds
    com_ab (2x Fq12) | com_c (2x Fq12)
    cross_terms (16x Fq12)
    per round: com_L (2x Fq12) | com_R (2x Fq12) | z_L (Fq12) | z_R (Fq12)
    final_a (G1) | final_b (G2)
    v1/v2 openings (2x G2 each) | w1/w2 openings (2x G1 each)

Fq12 elements are 12 base-field coefficients, 32 bytes each (384 B) — they
dominate both encodings, as in the reference's SnarkPack proofs.
"""
from __future__ import annotations

import struct

from ..curves import host as ch
from ..fields.host import Fq12
from .aggregation import AggProof
from .ipp import IppCom
from .tipa import KzgOpening, TipaProof

MAGIC = 0x48454B41  # "HEKA"
VERSION = 1

FQ12_BYTES = 384


def fq12_to_bytes(x: Fq12) -> bytes:
    return b"".join(c.to_bytes(32, "little") for c in x.to_coeffs())


def fq12_from_bytes(b: bytes) -> Fq12:
    assert len(b) == FQ12_BYTES
    return Fq12.from_coeffs([int.from_bytes(b[i * 32 : (i + 1) * 32], "little") for i in range(12)])


def _ippcom_to_bytes(c: IppCom) -> bytes:
    return fq12_to_bytes(c.t) + fq12_to_bytes(c.u)


def _ippcom_from(b: bytes, off: int):
    t = fq12_from_bytes(b[off : off + FQ12_BYTES])
    u = fq12_from_bytes(b[off + FQ12_BYTES : off + 2 * FQ12_BYTES])
    return IppCom(t, u), off + 2 * FQ12_BYTES


class _PointCodec:
    """G1/G2 encoders for the two modes; deserialization of compressed G2
    performs the on-curve + subgroup checks (curves/host.py)."""

    def __init__(self, compressed: bool):
        self.compressed = compressed
        if compressed:
            self.g1_size, self.g2_size = 32, 64
            self.g1_enc, self.g1_dec = ch.g1_to_bytes_compressed, ch.g1_from_bytes_compressed
            self.g2_enc, self.g2_dec = ch.g2_to_bytes_compressed, ch.g2_from_bytes_compressed
        else:
            self.g1_size, self.g2_size = 64, 128
            self.g1_enc, self.g1_dec = ch.g1_to_bytes, ch.g1_from_bytes
            self.g2_enc, self.g2_dec = ch.g2_to_bytes, ch.g2_from_bytes


def serialize_agg_proof(proof: AggProof, compressed: bool = True) -> bytes:
    pc = _PointCodec(compressed)
    tp = proof.tipa_proof
    rounds = len(tp.cross_coms)
    assert len(tp.cross_zs) == rounds
    out = bytearray()
    out += struct.pack("<IBBH", MAGIC, VERSION, 1 if compressed else 0, rounds)
    out += _ippcom_to_bytes(proof.com_ab)
    out += _ippcom_to_bytes(proof.com_c)
    assert len(proof.cross_terms) == 4 and all(len(r) == 4 for r in proof.cross_terms)
    for row in proof.cross_terms:
        for x in row:
            out += fq12_to_bytes(x)
    for (cl, cr), (zl, zr) in zip(tp.cross_coms, tp.cross_zs):
        out += _ippcom_to_bytes(cl)
        out += _ippcom_to_bytes(cr)
        out += fq12_to_bytes(zl)
        out += fq12_to_bytes(zr)
    out += pc.g1_enc(tp.final_a)
    out += pc.g2_enc(tp.final_b)
    for op in (tp.v1_opening, tp.v2_opening):
        out += pc.g2_enc(op.value)
        out += pc.g2_enc(op.proof)
    for op in (tp.w1_opening, tp.w2_opening):
        out += pc.g1_enc(op.value)
        out += pc.g1_enc(op.proof)
    return bytes(out)


def deserialize_agg_proof(data: bytes) -> AggProof:
    magic, version, flags, rounds = struct.unpack_from("<IBBH", data, 0)
    if magic != MAGIC or version != VERSION:
        raise ValueError("bad agg-proof header")
    pc = _PointCodec(bool(flags & 1))
    off = 8
    com_ab, off = _ippcom_from(data, off)
    com_c, off = _ippcom_from(data, off)
    cross = []
    for _ in range(4):
        row = []
        for _ in range(4):
            row.append(fq12_from_bytes(data[off : off + FQ12_BYTES]))
            off += FQ12_BYTES
        cross.append(row)
    cross_coms, cross_zs = [], []
    for _ in range(rounds):
        cl, off = _ippcom_from(data, off)
        cr, off = _ippcom_from(data, off)
        zl = fq12_from_bytes(data[off : off + FQ12_BYTES]); off += FQ12_BYTES
        zr = fq12_from_bytes(data[off : off + FQ12_BYTES]); off += FQ12_BYTES
        cross_coms.append((cl, cr))
        cross_zs.append((zl, zr))
    final_a = pc.g1_dec(data[off : off + pc.g1_size]); off += pc.g1_size
    final_b = pc.g2_dec(data[off : off + pc.g2_size]); off += pc.g2_size
    g2_openings = []
    for _ in range(2):
        v = pc.g2_dec(data[off : off + pc.g2_size]); off += pc.g2_size
        p = pc.g2_dec(data[off : off + pc.g2_size]); off += pc.g2_size
        g2_openings.append(KzgOpening(v, p))
    g1_openings = []
    for _ in range(2):
        v = pc.g1_dec(data[off : off + pc.g1_size]); off += pc.g1_size
        p = pc.g1_dec(data[off : off + pc.g1_size]); off += pc.g1_size
        g1_openings.append(KzgOpening(v, p))
    if off != len(data):
        raise ValueError("trailing bytes in agg proof")
    tp = TipaProof(
        cross_coms, cross_zs, final_a, final_b,
        g2_openings[0], g2_openings[1], g1_openings[0], g1_openings[1],
    )
    return AggProof(com_ab, com_c, cross, tp)


def serialize_groth16_proof(proof, compressed: bool = True) -> bytes:
    """CP-Groth16 proof (A, B, C, per-stage commitments D_i) to bytes."""
    pc = _PointCodec(compressed)
    out = bytearray()
    out += struct.pack("<IBBH", MAGIC, VERSION, 1 if compressed else 0, len(proof.ds))
    out += pc.g1_enc(proof.a)
    out += pc.g2_enc(proof.b)
    out += pc.g1_enc(proof.c)
    for d in proof.ds:
        out += pc.g1_enc(d)
    return bytes(out)


def deserialize_groth16_proof(data: bytes):
    from ..cpgroth16.data_structures import Proof

    magic, version, flags, nds = struct.unpack_from("<IBBH", data, 0)
    if magic != MAGIC or version != VERSION:
        raise ValueError("bad proof header")
    pc = _PointCodec(bool(flags & 1))
    off = 8
    a = pc.g1_dec(data[off : off + pc.g1_size]); off += pc.g1_size
    b = pc.g2_dec(data[off : off + pc.g2_size]); off += pc.g2_size
    c = pc.g1_dec(data[off : off + pc.g1_size]); off += pc.g1_size
    ds = []
    for _ in range(nds):
        ds.append(pc.g1_dec(data[off : off + pc.g1_size])); off += pc.g1_size
    if off != len(data):
        raise ValueError("trailing bytes in proof")
    return Proof(a, b, c, ds)
