"""SHA-256 R1CS gadget (plus native helpers via hashlib).

Equivalent of ark-crypto-primitives' Sha256 gadget used by the Big-Merkle
workload (distributed-prover/src/tree_hash_circuit.rs:98-111)
and VKD. Words are LSB-first Boolean vectors; ch/maj use the 1-/2-constraint
select forms; modular additions decompose the LC sum into 32+k bits.
~27k constraints per compression, matching the reference's cost model
(1 SHA-256 iter ~ 45k constraints incl. padding per SURVEY.md §6).
"""
from __future__ import annotations

import hashlib
import struct

from ..fields.bn254 import R
from ..r1cs.builder import ConstraintSystem
from ..r1cs.gadgets import Boolean, FpVar

_K = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1, 0x923F82A4, 0xAB1C5ED5,
    0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3, 0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174,
    0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967,
    0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13, 0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85,
    0xA2BFE8A1, 0xA81A664B, 0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
    0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208, 0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]

_H0 = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A, 0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]


class UInt32:
    """A 32-bit word as LSB-first Boolean vector."""

    __slots__ = ("bits",)

    def __init__(self, bits: list):
        assert len(bits) == 32
        self.bits = bits

    @property
    def cs(self):
        return self.bits[0].var.cs

    @property
    def value(self) -> int:
        return sum(b.value << i for i, b in enumerate(self.bits))

    @staticmethod
    def constant(cs: ConstraintSystem, v: int) -> "UInt32":
        return UInt32([Boolean.constant(cs, (v >> i) & 1) for i in range(32)])

    @staticmethod
    def witness(cs: ConstraintSystem, v: int) -> "UInt32":
        return UInt32([Boolean.witness(cs, (v >> i) & 1) for i in range(32)])

    def to_fpvar(self) -> FpVar:
        acc = FpVar.constant(self.cs, 0)
        for i, b in enumerate(self.bits):
            acc = acc + b.var.scale(1 << i)
        return acc

    def rotr(self, n: int) -> "UInt32":
        # (x >> n) | (x << (32-n)): output bit i = input bit (i+n) mod 32
        return UInt32([self.bits[(i + n) % 32] for i in range(32)])

    def shr(self, n: int) -> "UInt32":
        zero = Boolean.constant(self.cs, 0)
        return UInt32([self.bits[i + n] if i + n < 32 else zero for i in range(32)])

    def __xor__(self, other: "UInt32") -> "UInt32":
        return UInt32([a ^ b for a, b in zip(self.bits, other.bits)])

    def __and__(self, other: "UInt32") -> "UInt32":
        return UInt32([a & b for a, b in zip(self.bits, other.bits)])


def _ch(e: UInt32, f: UInt32, g: UInt32) -> UInt32:
    # per bit: e ? f : g — one constraint each
    return UInt32([Boolean(eb.select(fb.var, gb.var), trusted=True)
                   for eb, fb, gb in zip(e.bits, f.bits, g.bits)])


def _maj(a: UInt32, b: UInt32, c: UInt32) -> UInt32:
    # maj = ab + c(a + b - 2ab): two constraints per bit
    out = []
    for ab, bb, cb in zip(a.bits, b.bits, c.bits):
        t = ab.var * bb.var
        m = t + cb.var * (ab.var + bb.var - t.scale(2))
        out.append(Boolean(m, trusted=True))
    return UInt32(out)


def _add_mod32(cs: ConstraintSystem, words: list, const: int = 0) -> UInt32:
    """(sum of words + const) mod 2^32 via bit decomposition of the LC sum."""
    total = FpVar.constant(cs, const)
    val = const
    for w in words:
        total = total + w.to_fpvar()
        val += w.value
    nbits = max(33, val.bit_length() if val else 33)
    bits = total.to_bits_le(nbits)
    return UInt32([b for b in bits[:32]])


def _big_sigma0(x):
    return x.rotr(2) ^ x.rotr(13) ^ x.rotr(22)


def _big_sigma1(x):
    return x.rotr(6) ^ x.rotr(11) ^ x.rotr(25)


def _small_sigma0(x):
    return x.rotr(7) ^ x.rotr(18) ^ x.shr(3)


def _small_sigma1(x):
    return x.rotr(17) ^ x.rotr(19) ^ x.shr(10)


def sha256_compress_var(cs: ConstraintSystem, state: list, block: list) -> list:
    """One SHA-256 compression: state (8 UInt32), block (16 UInt32) -> 8 UInt32."""
    w = list(block)
    for t in range(16, 64):
        w.append(_add_mod32(cs, [_small_sigma1(w[t - 2]), w[t - 7], _small_sigma0(w[t - 15]), w[t - 16]]))
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        s1 = _big_sigma1(e)
        ch = _ch(e, f, g)
        s0 = _big_sigma0(a)
        mj = _maj(a, b, c)
        new_e = _add_mod32(cs, [d, h, s1, ch, w[t]], const=_K[t])
        new_a = _add_mod32(cs, [h, s1, ch, w[t], s0, mj], const=_K[t])
        a, b, c, d, e, f, g, h = new_a, a, b, c, new_e, e, f, g
    return [_add_mod32(cs, [s, n]) for s, n in zip(state, [a, b, c, d, e, f, g, h])]


def initial_state_var(cs: ConstraintSystem) -> list:
    return [UInt32.constant(cs, v) for v in _H0]


def bytes_to_words_be(data: bytes) -> list:
    assert len(data) % 4 == 0
    return list(struct.unpack(">%dI" % (len(data) // 4), data))


def words_to_bytes_be(words: list) -> bytes:
    return struct.pack(">%dI" % len(words), *[w & 0xFFFFFFFF for w in words])


def sha256_native(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def sha256_compress_native(state: list, block_words: list) -> list:
    """Native mirror of sha256_compress_var for trace generation."""
    mask = 0xFFFFFFFF

    def rotr(x, n):
        return ((x >> n) | (x << (32 - n))) & mask

    w = list(block_words)
    for t in range(16, 64):
        s0 = rotr(w[t - 15], 7) ^ rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = rotr(w[t - 2], 17) ^ rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & mask)
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = (h + s1 + ch + _K[t] + w[t]) & mask
        s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)
        mj = (a & b) ^ (a & c) ^ (b & c)
        t2 = (s0 + mj) & mask
        a, b, c, d, e, f, g, h = (t1 + t2) & mask, a, b, c, (d + t1) & mask, e, f, g
    return [(s + n) & mask for s, n in zip(state, [a, b, c, d, e, f, g, h])]


SHA256_H0 = list(_H0)


# ---------------------------------------------------------------------------
# Byte-level interface (ark UInt8-style: bytes as LSB-first Boolean vectors)
# ---------------------------------------------------------------------------


def witness_bytes(cs: ConstraintSystem, data: bytes) -> list:
    return [[Boolean.witness(cs, (byte >> i) & 1) for i in range(8)] for byte in data]


def constant_bytes(cs: ConstraintSystem, data: bytes) -> list:
    return [[Boolean.constant(cs, (byte >> i) & 1) for i in range(8)] for byte in data]


def _bytes_to_words_be(byte_vars: list) -> list:
    """4 bytes (big-endian) -> one UInt32 per group."""
    assert len(byte_vars) % 4 == 0
    words = []
    for i in range(0, len(byte_vars), 4):
        b0, b1, b2, b3 = byte_vars[i : i + 4]
        bits = list(b3) + list(b2) + list(b1) + list(b0)  # LSB-first word bits
        words.append(UInt32(bits))
    return words


def _words_to_bytes_be(words: list) -> list:
    out = []
    for w in words:
        out.extend([w.bits[24:32], w.bits[16:24], w.bits[8:16], w.bits[0:8]])
    return out


def sha256_digest_var(cs: ConstraintSystem, msg_bytes: list) -> list:
    """Full SHA-256 (with padding) over byte variables; returns 32 byte vars."""
    n = len(msg_bytes)
    padded = list(msg_bytes)
    padded.extend(constant_bytes(cs, b"\x80"))
    while (len(padded) % 64) != 56:
        padded.extend(constant_bytes(cs, b"\x00"))
    padded.extend(constant_bytes(cs, struct.pack(">Q", n * 8)))
    state = initial_state_var(cs)
    for i in range(0, len(padded), 64):
        block = _bytes_to_words_be(padded[i : i + 64])
        state = sha256_compress_var(cs, state, block)
    return _words_to_bytes_be(state)


def digest_bytes_to_fpvar(byte_vars: list, truncate: int = 27) -> FpVar:
    """Truncate to `truncate` bytes and interpret the LE bitstring as Fr
    (vkd/util.rs:19-28)."""
    cs = byte_vars[0][0].var.cs
    acc = FpVar.constant(cs, 0)
    pos = 0
    for byte in byte_vars[:truncate]:
        for bit in byte:
            acc = acc + bit.var.scale(1 << pos)
            pos += 1
    return acc


def fpvar_to_digest_bytes(f: FpVar, truncate: int = 27) -> list:
    """Decompose into truncate*8 bits -> byte vars (vkd/util.rs:30-39)."""
    bits = f.to_bits_le(truncate * 8)
    return [bits[i : i + 8] for i in range(0, truncate * 8, 8)]


def digest_to_int(digest: bytes, truncate: int = 27) -> int:
    return int.from_bytes(digest[:truncate], "little")
