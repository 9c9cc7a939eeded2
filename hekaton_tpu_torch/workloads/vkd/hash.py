"""VKD hash layer: dual SHA-256 / Poseidon over byte-chunked inputs,
native + in-circuit.

Behavioral equivalent of distributed-prover/src/vkd/hash.rs:
a module-level HASH_TYPE switch (hash.rs:33) selects the hash for the whole
sparse-tree/VKD layer, with both branches implemented (hash.rs:44-160).

SHA-256 mode matches the reference exactly: digests are truncated to
INNER_HASH_SIZE = 27 bytes so they embed into Fr (hash.rs:49-52), inner nodes
hash the 54-byte concatenation of the child digests (hash.rs:55-65), and the
in-circuit versions run the SHA-256 gadget over byte variables.

Poseidon mode keeps one TPU-first redesign: inner hashes are FULL Fr elements
instead of truncated digests. The reference truncates Poseidon outputs
"non-standardly" WITHOUT constraining the truncation in-circuit
(hash.rs:146-152 allocates the truncated value as a fresh, unconstrained
witness — their own TODO admits it); keeping field elements end-to-end
removes that soundness gap and the byte<->field conversions.

Byte inputs (usernames, leaves) are chunked exactly like the reference:
INNER_HASH_SIZE-byte little-endian chunks, each < 2^216 < R (hash.rs:95-99).
"""
from __future__ import annotations

import hashlib

from ...fields.bn254 import R
from ...hashes import poseidon
from ...r1cs.gadgets import FpVar

CHUNK_SIZE = 27  # INNER_HASH_SIZE (sparse_tree.rs:42)

# hash.rs:33: compile-time switch; tests flip it via set_hash_type()
HASH_TYPE = "poseidon"  # "poseidon" | "sha256"


def set_hash_type(t: str) -> str:
    """Set the module hash mode; returns the previous mode (for restoring)."""
    global HASH_TYPE
    assert t in ("poseidon", "sha256")
    prev = HASH_TYPE
    HASH_TYPE = t
    return prev


def bytes_to_chunks(value: bytes) -> list:
    return [
        int.from_bytes(value[i : i + CHUNK_SIZE], "little")
        for i in range(0, len(value), CHUNK_SIZE)
    ]


def _int_to_digest27(x: int) -> bytes:
    return int(x).to_bytes(CHUNK_SIZE, "little")


def hash_bytes(value: bytes) -> int:
    """hash() of hash.rs:87-110: SHA-256 digest truncated to 27 LE bytes, or
    Poseidon sponge over 27-byte LE chunks."""
    if HASH_TYPE == "sha256":
        return int.from_bytes(hashlib.sha256(value).digest()[:CHUNK_SIZE], "little")
    return poseidon.hash_leaf(bytes_to_chunks(value))


def hash_leaf(leaf: bytes) -> int:
    """hash_leaf (hash.rs:49-52)."""
    return hash_bytes(leaf)


def hash_inner_node(left: int, right: int) -> int:
    """hash_inner_node (hash.rs:55-85)."""
    if HASH_TYPE == "sha256":
        combined = _int_to_digest27(left) + _int_to_digest27(right)
        return int.from_bytes(hashlib.sha256(combined).digest()[:CHUNK_SIZE], "little")
    return poseidon.hash_two_to_one(left % R, right % R)


def witness_chunks(cs, value: bytes):
    """Allocate the hash input in the mode's native shape: byte variables for
    the SHA-256 gadget (ark UInt8 vectors, vkd_constraints.rs:256), or
    range-bounded 27-byte chunk field elements for Poseidon."""
    if HASH_TYPE == "sha256":
        from ...hashes.sha256_gadget import witness_bytes

        return witness_bytes(cs, value)
    out = []
    for i in range(0, len(value), CHUNK_SIZE):
        chunk = value[i : i + CHUNK_SIZE]
        v = FpVar.witness(cs, int.from_bytes(chunk, "little"))
        v.to_bits_le(8 * len(chunk))
        out.append(v)
    return out


def _cs_of(chunk_vars):
    v = chunk_vars[0]
    while isinstance(v, list):
        v = v[0]
    return v.var.cs if hasattr(v, "var") else v.cs


def hash_bytes_var(chunk_vars) -> FpVar:
    """In-circuit hash() over witness_chunks output (hash_var + digest
    truncation, hash.rs:114-160)."""
    if HASH_TYPE == "sha256":
        from ...hashes.sha256_gadget import digest_bytes_to_fpvar, sha256_digest_var

        cs = _cs_of(chunk_vars)
        digest = sha256_digest_var(cs, chunk_vars)
        return digest_bytes_to_fpvar(digest, truncate=CHUNK_SIZE)
    return poseidon.hash_leaf_var(chunk_vars)


def hash_inner_node_var(left: FpVar, right: FpVar) -> FpVar:
    """In-circuit hash_inner_node (hash.rs:124-152). SHA-256 branch: decompose
    both children to their 27-byte digests (CONSTRAINED decomposition, unlike
    the reference's unconstrained Poseidon truncation), hash the 54-byte
    concatenation, recompose the truncated digest."""
    if HASH_TYPE == "sha256":
        from ...hashes.sha256_gadget import (
            digest_bytes_to_fpvar,
            fpvar_to_digest_bytes,
            sha256_digest_var,
        )

        cs = left.cs
        lb = fpvar_to_digest_bytes(left, truncate=CHUNK_SIZE)
        rb = fpvar_to_digest_bytes(right, truncate=CHUNK_SIZE)
        digest = sha256_digest_var(cs, lb + rb)
        return digest_bytes_to_fpvar(digest, truncate=CHUNK_SIZE)
    return poseidon.hash_two_to_one_var(left, right)
