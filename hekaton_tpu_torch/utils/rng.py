"""Deterministic seedable RNG for protocol randomness.

Plays the role of the reference's ChaCha12/StdRng seeded RNGs
(distributed-prover/src/worker.rs:130-131): a 32-byte seed
fully determines all sampled field elements, which is what lets a stateless
worker re-derive its stage-0 commitment randomness in stage 1. Implemented as
a SHA-256 counter DRBG (framework-internal; determinism is the contract, not
byte-compatibility with rand_chacha).
"""
from __future__ import annotations

import hashlib
import os

from ..fields.bn254 import R


class Rng:
    def __init__(self, seed: bytes):
        assert isinstance(seed, (bytes, bytearray)) and len(seed) == 32
        self.seed = bytes(seed)
        self.counter = 0

    @staticmethod
    def from_entropy() -> "Rng":
        return Rng(os.urandom(32))

    @staticmethod
    def from_int(x: int) -> "Rng":
        return Rng(hashlib.sha256(b"seed-int" + x.to_bytes(16, "little", signed=True)).digest())

    def next_bytes(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            out += hashlib.sha256(
                self.seed + self.counter.to_bytes(8, "little")
            ).digest()
            self.counter += 1
        return out[:n]

    def next_fr(self) -> int:
        # 512 bits reduced mod r: negligible bias
        return int.from_bytes(self.next_bytes(64), "little") % R

    def next_nonzero_fr(self) -> int:
        while True:
            x = self.next_fr()
            if x != 0:
                return x

    def next_u64(self) -> int:
        return int.from_bytes(self.next_bytes(8), "little")

    def next_seed(self) -> bytes:
        return self.next_bytes(32)

    def fork(self, label: bytes) -> "Rng":
        return Rng(hashlib.sha256(self.seed + b"fork" + label).digest())
