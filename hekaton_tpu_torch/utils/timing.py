"""Spans and counters: where a call's time goes, on the host's clock and the
device's.

    with span("msm", N=n):           # a stage; spans nest
        with span("msm.plan"):
            count("slab_entries", k)  # adds to the innermost open span

Recording is on while a torch profiler collects (`torch.profiler.profile`,
`torch.autograd.profiler.emit_nvtx`, ...) or when HEKATON_PRINT_TRACE is
set. Off, `span` costs one check and records nothing, and `count` does
nothing. On, a span

- opens `torch.profiler.record_function(name)`, so the span sits on the
  profiler's timeline around the operations it launched;
- reads `time.perf_counter()` at entry and exit (`host_ms`);
- once CUDA is initialised, records a timing `torch.cuda.Event` at entry
  and exit on the current stream (`device_ms`: the device's clock between
  the two, idle gaps included).

Each record keeps its parent's name and a call id shared by every span of
one top-level span. `count(name, n)` takes an int or a 0-d tensor; a device
tensor is read only when records are read, so counting adds no host sync.
`records()` returns the last MAX_RECORDS finished top-level spans, each
with its children and counters. With HEKATON_PRINT_TRACE, each top-level
span prints one line a span of its tree when it ends, which waits for the
device. This is the reference's arkworks start_timer!/end_timer! under its
print-trace feature (SURVEY.md §5), on both clocks.

The open spans are one stack for the process: spans are opened and closed
on one thread.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import time
from collections import deque

import torch
from torch.autograd import profiler as _profiler

_PRINT = bool(os.environ.get("HEKATON_PRINT_TRACE"))
MAX_RECORDS = 4096  # top-level spans kept

_open: list = []  # the open spans, outermost first
_done: deque = deque(maxlen=MAX_RECORDS)
_call_ids = itertools.count()
_OFF = contextlib.nullcontext()


def recording() -> bool:
    """Whether spans and counters record now."""
    return _PRINT or _profiler._is_profiler_enabled


class Span:
    """One span's record: `name`, `attrs`, `parent` (the parent span's
    name, None at the top), `call` (the top-level span's id), `host_ms`,
    `device_ms` (None off CUDA, and until `records()` resolves it),
    `counters` ({name: int}, resolved by `records()`) and `children`."""

    def __init__(self, name: str, attrs: dict):
        parent = _open[-1] if _open else None
        self.name, self.attrs = name, attrs
        self.parent = parent.name if parent else None
        self.call = parent.call if parent else next(_call_ids)
        self.host_ms = self.device_ms = None
        self.counters: dict = {}
        self.children: list = []
        self._pending: list = []  # (name, 0-d tensor) added by count()
        self._events = None
        self._range = self._t0 = None

    def __enter__(self):
        # the device clock starts first and stops last: the host's work of
        # opening and closing a span falls inside it, not between siblings
        if torch.cuda.is_initialized():
            self._events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        if _open:
            _open[-1].children.append(self)
        _open.append(self)
        self._range = _profiler.record_function(self.name)
        self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.host_ms = (time.perf_counter() - self._t0) * 1e3
        self._range.__exit__(*exc)
        self._range = None
        _open.pop()
        if self._events is not None:
            self._events[1].record()
        if not _open:
            _done.append(self)
            if _PRINT:
                _print_tree(self)
        return False

    def _resolve(self) -> None:
        """Device ms and tensor counts to numbers; the device must have
        passed the span's end."""
        if self._events is not None:
            self.device_ms = self._events[0].elapsed_time(self._events[1])
            self._events = None
        for name, n in self._pending:
            self.counters[name] = self.counters.get(name, 0) + int(n)
        self._pending.clear()
        for child in self.children:
            child._resolve()


def span(name: str, **attrs):
    """A context manager that records the span `name` while recording is
    on, and does nothing otherwise."""
    if not recording():
        return _OFF
    return Span(name, attrs)


def count(name: str, n=1) -> None:
    """Add n (an int or a 0-d tensor) to the counter `name` of the innermost
    open span; nothing when no span is open."""
    if _open:
        top = _open[-1]
        if isinstance(n, torch.Tensor):
            top._pending.append((name, n))
        else:
            top.counters[name] = top.counters.get(name, 0) + n


def records() -> list:
    """The finished top-level spans, oldest first, their device ms and
    counters resolved (after one torch.cuda.synchronize() on CUDA)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    out = list(_done)
    for rec in out:
        rec._resolve()
    return out


def _print_tree(rec: Span, depth: int = 0) -> None:
    if depth == 0:
        if rec._events is not None:
            rec._events[1].synchronize()
        rec._resolve()
    dev = f", {rec.device_ms:.3f} ms device" if rec.device_ms is not None else ""
    extra = "".join(f" {k}={v}" for k, v in {**rec.attrs, **rec.counters}.items())
    print(f"[span] {'  ' * depth}{rec.name}: {rec.host_ms:.3f} ms host{dev}{extra}", flush=True)
    for child in rec.children:
        _print_tree(child, depth + 1)
