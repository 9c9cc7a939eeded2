"""The readers of the program's spans and counters (hkbench/spans.py and
the seven metrics that use it), on the CPU: nothing without records or with
another count of records than of traced calls, averages on synthetic records, and the
program's nonzero_digits against hkbench.work's count on the traffic's own
scalars."""
from __future__ import annotations

import contextlib
import io
from collections import deque
from types import SimpleNamespace

import pytest

from hkbench import run, spans, traffic, work
from hkbench.run import load_cell
from hkbench.trace import CallStats, Summary

STAGES = ("plan", "level1", "collapse", "suffix", "horner")
READERS = [f"msm_{s}_ms" for s in STAGES] + ["msm_host_syncs", "msm_slab_useful_pct"]


def _summary(calls: int) -> Summary:
    return Summary(calls=[CallStats(device_us=1.0, launches=1, port_us=0.0, other_us=1.0) for _ in range(calls)])


def _rec(name="msm", device_ms=None, counters=None, children=()):
    return SimpleNamespace(name=name, device_ms=device_ms, counters=counters or {}, children=list(children))


def _msm(stage_ms: dict, syncs: int, nonzero: int, slab: int):
    kids = [_rec(f"msm.{s}", stage_ms[s]) for s in STAGES]
    kids[0].counters = {"slab_entries": slab, "nonzero_digits": nonzero, "host_syncs": 2}
    kids[2].counters = {"host_syncs": syncs}
    return _rec(children=kids)


@pytest.fixture
def programs_records(monkeypatch):
    from hekaton_tpu_torch.utils import timing

    recs = []
    monkeypatch.setattr(timing, "records", lambda: list(recs))
    return recs


def _read(name: str, summary):
    return run._reader("metrics", name)(summary)


def test_every_reader_is_in_the_benchmark():
    names = {m["name"] for m in load_cell("g1-2p20-uniform")["per_layer"]}
    assert set(READERS) <= names


def test_nothing_without_records_or_with_too_few(programs_records):
    for name in READERS:
        assert _read(name, _summary(2)) is None
        assert _read(name, _summary(0)) is None
    programs_records.append(_msm(dict.fromkeys(STAGES, 1.0), 15, 10, 100))
    for name in READERS:
        assert _read(name, _summary(2)) is None, name


def test_nothing_with_more_records_than_calls(programs_records):
    # two msm spans for one traced call: a call that made two MSMs, or a
    # record from outside the window; neither can be paired with the calls
    programs_records.extend(_msm(dict.fromkeys(STAGES, 1.0), 15, 10, 100) for _ in range(2))
    for name in READERS:
        assert _read(name, _summary(1)) is None, name
    assert _read("msm_plan_ms", _summary(2)) == 1.0


def test_nothing_from_a_program_without_records(monkeypatch):
    from hekaton_tpu_torch.utils import timing

    monkeypatch.delattr(timing, "records")
    for name in READERS:
        assert _read(name, _summary(1)) is None


def test_nothing_without_device_times(programs_records):
    programs_records.append(_msm(dict.fromkeys(STAGES, None), 15, 10, 100))
    for s in STAGES:
        assert _read(f"msm_{s}_ms", _summary(1)) is None
    assert _read("msm_host_syncs", _summary(1)) == 17


def test_averages_over_the_last_records(programs_records):
    programs_records.append(_rec("prove.msm_a"))  # another top-level span, not read
    programs_records.append(_msm({"plan": 26.0, "level1": 7.0, "collapse": 8.0, "suffix": 6.0, "horner": 0.5},
                                 15, 20, 100))
    programs_records.append(_msm({"plan": 28.0, "level1": 7.5, "collapse": 9.0, "suffix": 5.0, "horner": 0.4},
                                 15, 1, 100))
    got = {name: _read(name, _summary(2)) for name in READERS}
    assert got == pytest.approx({"msm_plan_ms": 27.0, "msm_level1_ms": 7.25, "msm_collapse_ms": 8.5,
                                 "msm_suffix_ms": 5.5, "msm_horner_ms": 0.45, "msm_host_syncs": 17.0,
                                 "msm_slab_useful_pct": 10.5})


@pytest.mark.parametrize("mix", ["uniform", "witness"])
def test_nonzero_digits_are_the_works_count(monkeypatch, mix):
    import torch

    from hekaton_tpu_torch.cpgroth16.backend import TorchBackend
    from hekaton_tpu_torch.msm.pippenger import msm_gpu
    from hekaton_tpu_torch.utils import timing

    from hkbench import bn254

    n = 256
    c, L = TorchBackend.msm_params(n)
    cell = load_cell("g1-2p20-" + mix)
    scalars = traffic.draw(traffic.load(cell["mix_file"]), n, traffic.generator(2**31 + 11, "cpu"), "cpu")
    ax, ay = (torch.from_numpy(t) for t in bn254.pack_points(bn254.G1, bn254.chain(bn254.G1, n, 5, 7)))
    monkeypatch.setattr(timing, "_PRINT", True)  # HEKATON_PRINT_TRACE's recording
    monkeypatch.setattr(timing, "_done", deque(maxlen=timing.MAX_RECORDS))  # this call's records alone
    with contextlib.redirect_stdout(io.StringIO()):
        msm_gpu(ax.to(torch.int32), ay.to(torch.int32), scalars, c=c, L=L)
    (rec,) = spans.msm_records(_summary(1))
    assert spans.counter_total(_summary(1), "nonzero_digits") == work.signed_digits_nonzero(scalars, c, 254)
    W, B = -(-254 // c), (1 << (c - 1)) + 1
    assert spans.counter_total(_summary(1), "slab_entries") == W * -(-(n + B * (L - 1)) // L) * L
    assert rec.children[2].counters["host_syncs"] == 5
