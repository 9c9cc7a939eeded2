"""Fiat-Shamir transcript (merlin-style labeled absorb/challenge).

Equivalent role to the reference's merlin `ProtoTranscript`
(distributed-prover/src/util.rs:42-75): domain-separated
absorb of serialized group/field elements, SHA-256-based challenge squeezing.
"""
from __future__ import annotations

import hashlib

from ..fields.bn254 import R


class Transcript:
    def __init__(self, label: bytes):
        self._h = hashlib.sha256()
        self._absorb(b"init", label)
        self._state = self._h.digest()

    def _absorb(self, label: bytes, data: bytes):
        self._h.update(len(label).to_bytes(8, "little") + label)
        self._h.update(len(data).to_bytes(8, "little") + data)

    def append(self, label: bytes, data: bytes):
        self._absorb(label, data)
        self._state = self._h.digest()

    def append_serializable(self, label: bytes, obj):
        self.append(label, _serialize(obj))

    def challenge_fr(self, label: bytes) -> int:
        out = hashlib.sha256(self._state + b"chal" + label).digest() + hashlib.sha256(
            self._state + b"chal2" + label
        ).digest()
        # absorb the fact that a challenge was taken (ratchet)
        self.append(b"chal-taken", label)
        return int.from_bytes(out, "little") % R

    def challenge_nonzero_fr(self, label: bytes) -> int:
        i = 0
        while True:
            c = self.challenge_fr(label + i.to_bytes(2, "little"))
            if c != 0:
                return c
            i += 1


def _serialize(obj) -> bytes:
    from ..curves.host import Fq2, g1_to_bytes, g2_to_bytes
    from ..fields.host import Fq12

    if isinstance(obj, bytes):
        return obj
    if isinstance(obj, int):
        return obj.to_bytes(32, "little")
    if isinstance(obj, Fq12):
        return b"".join(c.to_bytes(32, "little") for c in obj.to_coeffs())
    if isinstance(obj, tuple) and len(obj) == 2:
        if isinstance(obj[0], int):
            return g1_to_bytes(obj)
        return g2_to_bytes(obj)
    if obj is None:
        return g1_to_bytes(None)
    if isinstance(obj, (list,)):
        return b"".join(_serialize(x) for x in obj)
    raise TypeError(f"cannot serialize {type(obj)}")
