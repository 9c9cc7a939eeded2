"""Portal managers: setup-side trace recorders and prover-side checkers.

Behavioral equivalents of distributed-prover/src/portal_manager/:
 - SetupRomPortalManager (rom_portal_manager.rs:34-117): coordinator-side
   recorder; fresh addresses starting at 1 (0 = padding), per-subcircuit
   subtraces.
 - RomProverPortalManager (rom_portal_manager.rs:122-227): in-circuit; each
   get() consumes the next time/addr entries, updates both running evals, and
   enforces the addr-sorted coherence invariants.
 - SetupRamPortalManager / RamProverPortalManager (ram_portal_manager.rs):
   RAM (read/write) variant with 32-bit timestamps.
"""
from __future__ import annotations

from ..r1cs.gadgets import Boolean, FpVar
from .transcript import (
    RamTranscriptEntry,
    RamTranscriptEntryVar,
    RomTranscriptEntry,
    RomTranscriptEntryVar,
)


class SetupRomPortalManager:
    def __init__(self):
        self.subtraces = []
        self.next_var_addr = 1  # 0 is reserved for padding
        self.var_map = {}

    def start_subtrace(self):
        self.subtraces.append([])

    def get(self, name: str) -> int:
        entry = self.var_map[name]
        self.subtraces[-1].append(entry)
        return entry.val

    def set(self, name: str, val: int):
        assert name not in self.var_map, f"cannot set portal wire twice: {name}"
        entry = RomTranscriptEntry(addr=self.next_var_addr, val=val)
        self.next_var_addr += 1
        self.var_map[name] = entry
        self.subtraces[-1].append(entry)


class RomProverPortalManager:
    def __init__(self, time_ordered_subtrace, addr_ordered_subtrace, running_evals):
        self.time_ordered_subtrace = time_ordered_subtrace  # [RomTranscriptEntryVar]
        self.addr_ordered_subtrace = addr_ordered_subtrace  # prepended with prev-leaf entry
        self.running_evals = running_evals
        self.next_entry_idx = 0

    def get(self, name: str) -> FpVar:
        cur_time = self.time_ordered_subtrace[self.next_entry_idx]
        cur_addr = self.addr_ordered_subtrace[self.next_entry_idx]
        self.running_evals.update_time_ordered(cur_time)

        next_addr = self.addr_ordered_subtrace[self.next_entry_idx + 1]
        # next addr equals current or current + 1
        is_same = next_addr.addr.is_eq(cur_addr.addr)
        is_incr = next_addr.addr.is_eq(cur_addr.addr + 1)
        (is_same | is_incr).enforce_true()
        # equal addresses carry equal values
        cur_addr.val.conditional_enforce_equal(next_addr.val, is_same)

        self.next_entry_idx += 1
        self.running_evals.update_addr_ordered(next_addr)
        return cur_time.val

    def set(self, name: str, val: FpVar):
        trace_val = self.get(name)
        val.enforce_equal(trace_val)


class SetupRamPortalManager:
    def __init__(self):
        self.subtraces = []
        self.addr_map = {}
        self.next_addr = 1
        self.time_index = 0
        self.var_map = {}

    def start_subtrace(self):
        self.subtraces.append([])

    def _addr_of(self, name: str) -> int:
        if name not in self.addr_map:
            self.addr_map[name] = self.next_addr
            self.next_addr += 1
        return self.addr_map[name]

    def get(self, name: str) -> int:
        value = self.var_map[name]
        self.subtraces[-1].append(
            RamTranscriptEntry(addr=self._addr_of(name), val=value, timestamp=self.time_index, read=True)
        )
        self.time_index = (self.time_index + 1) & 0xFFFFFFFF
        return value

    def set(self, name: str, val: int):
        self.var_map[name] = val
        self.subtraces[-1].append(
            RamTranscriptEntry(addr=self._addr_of(name), val=val, timestamp=self.time_index, read=False)
        )
        self.time_index = (self.time_index + 1) & 0xFFFFFFFF


class RamProverPortalManager:
    def __init__(self, time_ordered_subtrace, addr_ordered_subtrace, running_evals):
        self.time_ordered_subtrace = time_ordered_subtrace
        self.addr_ordered_subtrace = addr_ordered_subtrace
        self.running_evals = running_evals
        self.next_entry_idx = 0

    def get(self, name: str) -> FpVar:
        cur_time = self.time_ordered_subtrace[self.next_entry_idx]
        cur_addr = self.addr_ordered_subtrace[self.next_entry_idx + 1]
        self.running_evals.update_time_ordered(cur_time)
        self.running_evals.update_addr_ordered(cur_addr)

        if self.next_entry_idx + 2 < len(self.addr_ordered_subtrace):
            next_addr = self.addr_ordered_subtrace[self.next_entry_idx + 2]
            is_same = next_addr.addr.is_eq(cur_addr.addr)
            is_incr = next_addr.addr.is_eq(cur_addr.addr + 1)
            (is_same | is_incr).enforce_true()
            # increasing address => the first touch is a write
            next_addr.read.var.conditional_enforce_equal(FpVar.constant(next_addr.read.var.cs, 0), is_incr)
            # same address + read => value persists
            same_and_read = is_same & next_addr.read
            next_addr.val.conditional_enforce_equal(cur_addr.val, same_and_read)
            # same address => strictly increasing timestamp
            gt = next_addr.timestamp.is_greater_than(cur_addr.timestamp)
            gt.var.conditional_enforce_equal(FpVar.constant(gt.var.cs, 1), is_same)

        if self.next_entry_idx < len(self.time_ordered_subtrace) - 1:
            next_time = self.time_ordered_subtrace[self.next_entry_idx + 1]
            cur_time.timestamp.increment().enforce_equal(next_time.timestamp)

        self.next_entry_idx += 1
        return cur_time.val

    def set(self, name: str, val: FpVar):
        trace_val = self.get(name)
        val.enforce_equal(trace_val)


class SetupVarPortalManager:
    """Trace recorder usable inside real constraint generation — the 'slow'
    trace path (tree_hash_circuit.rs:702-733 slow_get_portal_subtraces) used
    to validate the fast native trace generators."""

    def __init__(self, cs, mem_type: str = "rom"):
        self.cs = cs
        self.inner = SetupRomPortalManager() if mem_type == "rom" else SetupRamPortalManager()

    @property
    def subtraces(self):
        return self.inner.subtraces

    def start_subtrace(self):
        self.inner.start_subtrace()

    def get(self, name: str) -> FpVar:
        return FpVar.witness(self.cs, self.inner.get(name))

    def set(self, name: str, val: FpVar):
        self.inner.set(name, val.value)


def prover_portal_manager(mem_type: str, time_st, addr_st, running_evals):
    if mem_type == "rom":
        return RomProverPortalManager(time_st, addr_st, running_evals)
    return RamProverPortalManager(time_st, addr_st, running_evals)
