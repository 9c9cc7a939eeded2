"""Spans and counters (hekaton_tpu_torch/utils/timing.py) and msm_gpu's
records of them, on the CPU.

msm_gpu at N = 2^8 with TorchBackend.msm_params' c = 4, L = 8, five calls:
on the default route (wsort, pair, affine) uniform and 0/1-heavy 254-bit
scalars (64 windows, ~2 s each on one thread) with HEKATON_PRINT_TRACE's
recording on; on route (e) (tsort, mega, proj) 0/1-heavy 31-bit scalars (8
windows, ~0.3 s) off, with the print switch and under torch.profiler (CPU
activity). The profiled call is the cheapest: with 64 windows and affine
adds the plain Horner fold and Fermat inversions make a 0.8 M-event trace.
Held to: no record while off; one "msm" span a call with its five stage
spans in order, one call id, and in the profiler's Chrome trace as user
annotations nested in "msm"; host_syncs = the strides of _collapse_columns'
schedule; slab_entries = W x mcols x L from the sizes alone; nonzero_digits
= a Python-int count of the signed digits; the same output bits with
recording on and off.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import random

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hekaton_tpu_torch.cpgroth16.backend import TorchBackend
from hekaton_tpu_torch.curves import host as ch
from hekaton_tpu_torch.curves.torch_curve import G1
from hekaton_tpu_torch.fields.bn254 import R
from hekaton_tpu_torch.msm import pippenger as pip
from hekaton_tpu_torch.utils import timing

torch.set_num_threads(1)

N = 1 << 8
C, L = TorchBackend.msm_params(N)
STAGES = ["msm.plan", "msm.level1", "msm.collapse", "msm.suffix", "msm.horner"]


def _scalars(kind: str, nbits: int = 254) -> list:
    rs = random.Random(f"tracing {kind} {nbits}")
    top = R if nbits == 254 else 1 << nbits
    if kind == "uniform":
        return [rs.randrange(top) for _ in range(N)]
    # the witness traffic's shares: 69% zeros, 28% ones, the rest wide
    return [0 if u < 0.69 else 1 if u < 0.97 else rs.randrange(top) for u in (rs.random() for _ in range(N))]


@pytest.fixture(scope="module")
def points():
    p, step = ch.pt_mul(ch.g1_gen(), 0x1234567), ch.pt_mul(ch.g1_gen(), 0xABCDEF)
    pts = [p]
    while len(pts) < N:
        pts.append(ch.pt_add(pts[-1], step))
    return tuple(torch.from_numpy(a) for a in G1.pack_affine(pts))


ROUTE_E = {"plan": "tsort", "accum": "proj"}  # level1 resolves to "mega"


def _call(points, vals, nbits: int = 254, **route):
    return pip.msm_gpu(*points, pip.pack_scalars(vals, G1), c=C, L=L, nbits=nbits, **route)


def _printed(fn):
    """fn() with recording on by the HEKATON_PRINT_TRACE switch: (its
    output, its record, the lines it printed)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(timing, "_PRINT", True)
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            out = fn()
    return out, timing.records()[-1], printed.getvalue().splitlines()


@pytest.fixture(scope="module")
def runs(points):
    """kind -> (record, printed lines) of a 254-bit call on the default route."""
    return {kind: _printed(lambda: _call(points, _scalars(kind)))[1:] for kind in ("uniform", "witness")}


@pytest.fixture(scope="module")
def route_e(points, tmp_path_factory):
    """Route (e) on 31-bit scalars: {"off": output, "print": (output,
    record), "profiler": (output, record, Chrome trace events)}."""
    vals = _scalars("witness", 31)
    assert not timing.recording()
    before = timing.records()
    off = _call(points, vals, 31, **ROUTE_E)
    assert timing.records() == before, "a call outside a profiler recorded a span"
    printed = _printed(lambda: _call(points, vals, 31, **ROUTE_E))[:2]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert timing.recording()
        on = _call(points, vals, 31, **ROUTE_E)
    assert not timing.recording()
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    prof.export_chrome_trace(str(path))
    return {"off": off, "print": printed,
            "profiler": (on, timing.records()[-1], json.loads(path.read_text())["traceEvents"])}


def _check_tree(rec, route: tuple):
    assert rec.name == "msm" and rec.parent is None
    assert rec.attrs == {"curve": G1.name, "N": N, "c": C, "L": L, "accum": route[0], "level1": route[1],
                         "plan": route[2]}
    assert [s.name for s in rec.children] == STAGES
    assert all(s.parent == "msm" and s.call == rec.call and not s.children for s in rec.children)
    assert rec.host_ms >= sum(s.host_ms for s in rec.children) > 0
    assert rec.device_ms is None  # no device on the CPU


def test_msm_spans_nest_in_order(runs, route_e):
    recs = [runs["uniform"][0], runs["witness"][0], route_e["print"][1], route_e["profiler"][1]]
    for rec in recs[:2]:
        _check_tree(rec, ("affine", "pair", "wsort"))
    for rec in recs[2:]:
        _check_tree(rec, ("proj", "mega", "tsort"))
    assert len({rec.call for rec in recs}) == 4
    lines = runs["uniform"][1]
    assert [ln.split(":")[0] for ln in lines] == ["[span] msm"] + [f"[span]   {s}" for s in STAGES]
    assert lines[3].endswith(" ms host host_syncs=5")


def test_chrome_trace_nests_stage_annotations(route_e):
    ann = {e["name"]: e for e in route_e["profiler"][2] if e.get("cat") == "user_annotation" and e["name"].startswith("msm")}
    assert set(ann) == {"msm", *STAGES}
    top = ann["msm"]
    starts = []
    for name in STAGES:
        e = ann[name]
        assert top["ts"] <= e["ts"] and e["ts"] + e["dur"] <= top["ts"] + top["dur"], name
        starts.append(e["ts"])
    assert starts == sorted(starts)


def test_host_syncs_count_the_collapse_strides(runs):
    rec = runs["uniform"][0]
    max_cols = (N + L - 1) // L
    levels = max(1, math.ceil(math.log2(max(2, max_cols))))
    strides = min(3, levels) + max(0, levels - 3)  # p_super = 3: the two rounds' strides
    assert strides == 5
    collapse = rec.children[2]
    assert collapse.counters == {"host_syncs": strides}
    # on the CPU the field ops' carry reads the host's own memory and is not counted
    assert all("host_syncs" not in s.counters for s in rec.children if s is not collapse)


def test_slab_entries_are_windows_by_columns_by_l(runs):
    W = math.ceil(254 / C)
    B = (1 << (C - 1)) + 1
    mcols = math.ceil((N + B * (L - 1)) / L)  # N points and each bucket's L - 1 pad slots, in columns of L
    for kind in ("uniform", "witness"):
        assert runs[kind][0].children[0].counters["slab_entries"] == W * mcols * L


def _signed_nonzero(vals: list, c: int, nbits: int = 254) -> int:
    half, mask, n = 1 << (c - 1), (1 << c) - 1, 0
    for v in vals:
        carry = 0
        for w in range(math.ceil(nbits / c)):
            d = ((v >> (w * c)) & mask) + carry
            carry = int(d > half)
            n += ((1 << c) - d if carry else d) != 0
    return n


@pytest.mark.parametrize("kind", ["uniform", "witness"])
def test_nonzero_digits_match_a_python_count(runs, route_e, kind):
    assert runs[kind][0].children[0].counters["nonzero_digits"] == _signed_nonzero(_scalars(kind), C)
    if kind == "witness":
        want = _signed_nonzero(_scalars(kind, 31), C, 31)
        assert route_e["print"][1].children[0].counters["nonzero_digits"] == want


@pytest.mark.parametrize("switch", ["print", "profiler"])
def test_output_is_the_same_with_recording_on_and_off(route_e, switch):
    assert all(torch.equal(a, b) for a, b in zip(route_e["off"], route_e[switch][0]))


# --- the module alone ---------------------------------------------------------


def test_span_off_is_one_shared_null_context():
    assert not timing.recording()
    assert timing.span("a") is timing.span("b", k=1)
    with timing.span("a"):
        timing.count("n", 5)  # no open span: nothing
    assert not timing._open


def test_counters_resolve_tensors_and_print_each_span(monkeypatch, capsys):
    monkeypatch.setattr(timing, "_PRINT", True)
    with timing.span("outer", k=1) as outer:
        timing.count("n", 2)
        with timing.span("outer.inner"):
            timing.count("t", torch.tensor(3))
            timing.count("t", torch.tensor(4))
        timing.count("n")
    assert outer.counters == {"n": 3}
    assert outer.children[0].counters == {"t": 7}
    assert outer.children[0].parent == "outer" and outer.children[0].call == outer.call
    assert timing.records()[-1] is outer
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[span] outer: ") and lines[0].endswith(" ms host k=1 n=3")
    assert lines[1].startswith("[span]   outer.inner: ") and lines[1].endswith(" ms host t=7")


def test_records_keep_the_last_top_level_spans(monkeypatch):
    monkeypatch.setattr(timing, "_PRINT", True)
    monkeypatch.setattr(timing, "_done", timing.deque(maxlen=3))
    monkeypatch.setattr(timing, "_print_tree", lambda rec: None)
    for i in range(5):
        with timing.span(f"s{i}"):
            pass
    assert [r.name for r in timing.records()] == ["s2", "s3", "s4"]
