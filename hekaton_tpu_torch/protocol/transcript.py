"""Portal-wire transcripts: ROM/RAM entries and running grand-product evals.

Behavioral equivalent of distributed-prover/src/transcript/:
 - ROM entry (addr, val); RAM entry (addr, val, timestamp, read-flag)
   (rom_transcript.rs:223-226, ram_transcript.rs:262-267)
 - running evals: prod (tr_chal - entry_repr) where entry_repr compresses the
   entry with the entry challenges (rom_transcript.rs:78-107)
 - challenges derived by SHA-256 hashing the IPP super-commitment under
   domain-separation tags (rom_transcript.rs:42-75)
Both native (host int) and in-circuit (FpVar) versions, tested for agreement.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

from ..fields.bn254 import R
from ..r1cs.gadgets import Boolean, FpVar

ROM = "rom"
RAM = "ram"


def _chal(tag: bytes, com_bytes: bytes) -> int:
    h = hashlib.sha256(tag + com_bytes).digest()
    return int.from_bytes(h, "little") % R


# ---------------------------------------------------------------------------
# ROM
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RomTranscriptEntry:
    addr: int
    val: int

    @staticmethod
    def padding() -> "RomTranscriptEntry":
        return RomTranscriptEntry(0, 0)

    def to_field_elements(self) -> list:
        return [self.addr % R, self.val % R]


class RomRunningEvaluation:
    def __init__(self, time_ordered_eval=1, addr_ordered_eval=1, challenges=None):
        self.time_ordered_eval = time_ordered_eval
        self.addr_ordered_eval = addr_ordered_eval
        self.challenges = challenges  # (entry_chal, tr_chal) or None

    @staticmethod
    def from_com_bytes(com_bytes: bytes) -> "RomRunningEvaluation":
        return RomRunningEvaluation(
            1, 1, (_chal(b"entry_chal", com_bytes), _chal(b"tr_chal", com_bytes))
        )

    def _repr_entry(self, entry: RomTranscriptEntry) -> int:
        entry_chal, _ = self.challenges
        return (entry.val + entry_chal * entry.addr) % R

    def update_time_ordered(self, entry: RomTranscriptEntry):
        _, tr_chal = self.challenges
        self.time_ordered_eval = self.time_ordered_eval * (tr_chal - self._repr_entry(entry)) % R

    def update_addr_ordered(self, entry: RomTranscriptEntry):
        _, tr_chal = self.challenges
        self.addr_ordered_eval = self.addr_ordered_eval * (tr_chal - self._repr_entry(entry)) % R

    def clone(self) -> "RomRunningEvaluation":
        return RomRunningEvaluation(self.time_ordered_eval, self.addr_ordered_eval, self.challenges)

    def challenge_list(self) -> list:
        return list(self.challenges)


class RomTranscriptEntryVar:
    def __init__(self, addr: FpVar, val: FpVar):
        self.addr = addr
        self.val = val

    @staticmethod
    def witness(cs, entry: RomTranscriptEntry) -> "RomTranscriptEntryVar":
        # allocation order (val, addr) fixed: it defines the committed layout
        val = FpVar.witness(cs, entry.val)
        addr = FpVar.witness(cs, entry.addr)
        return RomTranscriptEntryVar(addr, val)

    def is_padding(self) -> Boolean:
        return self.addr.is_zero() & self.val.is_zero()

    def to_field_elements(self) -> list:
        return [self.addr, self.val]


class RomRunningEvaluationVar:
    def __init__(self, time_ordered_eval: FpVar, addr_ordered_eval: FpVar, challenges=None):
        self.time_ordered_eval = time_ordered_eval
        self.addr_ordered_eval = addr_ordered_eval
        self.challenges = challenges  # (FpVar, FpVar)

    @staticmethod
    def witness(cs, evals: RomRunningEvaluation) -> "RomRunningEvaluationVar":
        t = FpVar.witness(cs, evals.time_ordered_eval)
        a = FpVar.witness(cs, evals.addr_ordered_eval)
        return RomRunningEvaluationVar(t, a)

    def set_challenges(self, chal_vars: list):
        assert len(chal_vars) == 2
        self.challenges = (chal_vars[0], chal_vars[1])

    def update_time_ordered(self, entry: RomTranscriptEntryVar):
        entry_chal, tr_chal = self.challenges
        entry_repr = entry.val + entry_chal * entry.addr
        self.time_ordered_eval = self.time_ordered_eval * (tr_chal - entry_repr)

    def update_addr_ordered(self, entry: RomTranscriptEntryVar):
        entry_chal, tr_chal = self.challenges
        entry_repr = entry.val + entry_chal * entry.addr
        self.addr_ordered_eval = self.addr_ordered_eval * (tr_chal - entry_repr)

    def clone(self) -> "RomRunningEvaluationVar":
        return RomRunningEvaluationVar(self.time_ordered_eval, self.addr_ordered_eval, self.challenges)


# ---------------------------------------------------------------------------
# RAM
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RamTranscriptEntry:
    addr: int
    val: int
    timestamp: int  # u32
    read: bool

    @staticmethod
    def padding() -> "RamTranscriptEntry":
        return RamTranscriptEntry(0, 0, 0, False)

    def to_field_elements(self) -> list:
        return [self.addr % R, self.val % R, self.timestamp % R, int(self.read)]


class RamRunningEvaluation:
    """Entry compressed as val + c1*addr + c2*timestamp + c3*read
    (ram_transcript.rs:108-115); challenges (c1, c2, c3, tr_chal)."""

    def __init__(self, time_ordered_eval=1, addr_ordered_eval=1, challenges=None):
        self.time_ordered_eval = time_ordered_eval
        self.addr_ordered_eval = addr_ordered_eval
        self.challenges = challenges

    @staticmethod
    def from_com_bytes(com_bytes: bytes) -> "RamRunningEvaluation":
        return RamRunningEvaluation(
            1,
            1,
            (
                _chal(b"addr_chal", com_bytes),
                _chal(b"ts_chal", com_bytes),
                _chal(b"read_chal", com_bytes),
                _chal(b"tr_chal", com_bytes),
            ),
        )

    def _repr_entry(self, e: RamTranscriptEntry) -> int:
        c1, c2, c3, _ = self.challenges
        return (e.val + c1 * e.addr + c2 * e.timestamp + c3 * int(e.read)) % R

    def update_time_ordered(self, e: RamTranscriptEntry):
        tr = self.challenges[3]
        self.time_ordered_eval = self.time_ordered_eval * (tr - self._repr_entry(e)) % R

    def update_addr_ordered(self, e: RamTranscriptEntry):
        tr = self.challenges[3]
        self.addr_ordered_eval = self.addr_ordered_eval * (tr - self._repr_entry(e)) % R

    def clone(self):
        return RamRunningEvaluation(self.time_ordered_eval, self.addr_ordered_eval, self.challenges)

    def challenge_list(self) -> list:
        return list(self.challenges)


class RamTranscriptEntryVar:
    def __init__(self, addr: FpVar, val: FpVar, timestamp, read: Boolean):
        self.addr = addr
        self.val = val
        self.timestamp = timestamp  # UInt32Var
        self.read = read

    @staticmethod
    def witness(cs, entry: RamTranscriptEntry) -> "RamTranscriptEntryVar":
        from .uint32 import UInt32Var

        val = FpVar.witness(cs, entry.val)
        addr = FpVar.witness(cs, entry.addr)
        ts = UInt32Var.witness(cs, entry.timestamp)
        read = Boolean.witness(cs, int(entry.read))
        return RamTranscriptEntryVar(addr, val, ts, read)

    def is_padding(self) -> Boolean:
        return self.addr.is_zero() & self.val.is_zero()

    def to_field_elements(self) -> list:
        return [self.addr, self.val, self.timestamp.as_fpvar(), self.read.var]


class RamRunningEvaluationVar:
    def __init__(self, time_ordered_eval: FpVar, addr_ordered_eval: FpVar, challenges=None):
        self.time_ordered_eval = time_ordered_eval
        self.addr_ordered_eval = addr_ordered_eval
        self.challenges = challenges

    @staticmethod
    def witness(cs, evals: RamRunningEvaluation) -> "RamRunningEvaluationVar":
        t = FpVar.witness(cs, evals.time_ordered_eval)
        a = FpVar.witness(cs, evals.addr_ordered_eval)
        return RamRunningEvaluationVar(t, a)

    def set_challenges(self, chal_vars: list):
        assert len(chal_vars) == 4
        self.challenges = tuple(chal_vars)

    def _repr_entry(self, e: RamTranscriptEntryVar) -> FpVar:
        c1, c2, c3, _ = self.challenges
        return e.val + c1 * e.addr + c2 * e.timestamp.as_fpvar() + c3 * e.read.var

    def update_time_ordered(self, e: RamTranscriptEntryVar):
        tr = self.challenges[3]
        self.time_ordered_eval = self.time_ordered_eval * (tr - self._repr_entry(e))

    def update_addr_ordered(self, e: RamTranscriptEntryVar):
        tr = self.challenges[3]
        self.addr_ordered_eval = self.addr_ordered_eval * (tr - self._repr_entry(e))

    def clone(self):
        return RamRunningEvaluationVar(self.time_ordered_eval, self.addr_ordered_eval, self.challenges)


# ---------------------------------------------------------------------------
# Dispatch helpers (transcript/mod.rs:26-72)
# ---------------------------------------------------------------------------


def padding_entry(mem_type: str):
    return RomTranscriptEntry.padding() if mem_type == ROM else RamTranscriptEntry.padding()


def new_running_evaluation(mem_type: str, com_bytes: bytes):
    if mem_type == ROM:
        return RomRunningEvaluation.from_com_bytes(com_bytes)
    return RamRunningEvaluation.from_com_bytes(com_bytes)


def default_running_evaluation(mem_type: str):
    return RomRunningEvaluation() if mem_type == ROM else RamRunningEvaluation()


def witness_entry_var(cs, entry):
    if isinstance(entry, RomTranscriptEntry):
        return RomTranscriptEntryVar.witness(cs, entry)
    return RamTranscriptEntryVar.witness(cs, entry)


def witness_evals_var(cs, evals):
    if isinstance(evals, RomRunningEvaluation):
        return RomRunningEvaluationVar.witness(cs, evals)
    return RamRunningEvaluationVar.witness(cs, evals)


def num_challenges(mem_type: str) -> int:
    return 2 if mem_type == ROM else 4
