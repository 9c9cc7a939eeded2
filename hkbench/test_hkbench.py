"""The benchmark's own tests: python3 -m pytest hkbench -q

On the CPU at small sizes: the reference against known discrete logs, the
traffic's shares and seeding, the work count, the trace readers on a
synthetic trace, the result line's shape, the no-JAX rule, a whole run
through the program's plain versions, the control and the faults that the
check must catch. The test marked `chip` runs a cell on a CUDA device and
skips without one.
"""
from __future__ import annotations

import json
import math
import os
import random
import subprocess
import sys

import pytest
import torch

from hkbench import bn254, limbs, run, trace, traffic, work
from hkbench.drivers import msm as msm_driver

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E2E = [{"name": "msm_points_per_s", "unit": "points/s"}, {"name": "msm_p95_ms", "unit": "ms"},
       {"name": "setup_s", "unit": "s"}]


def small_spec(config: str, mix: str, n: int, distinct: int) -> dict:
    """A cell of the benchmark cut to n points for the CPU."""
    with open(os.path.join(ROOT, "hkbench", "configs", config + ".json")) as f:
        cfg = json.load(f)
    cfg.update(points=n, warmup_calls=1, trace_calls=1)
    cfg["block" if cfg["maker"] == "block_sums" else "distinct_points"] = distinct
    return {"cell": {"name": "small", "chips": 1}, "cfg": cfg, "end_to_end": E2E, "per_layer": [],
            "mix_file": os.path.join(ROOT, "hkbench", "traffic", mix + ".json")}


# --- the reference ----------------------------------------------------------


def test_curves_and_generators():
    for curve in (bn254.G1, bn254.G2):
        assert curve.on_curve(curve.gen)
        assert curve.mul(curve.gen, bn254.R) is None
        assert curve.mul(curve.gen, bn254.R + 5) == curve.mul(curve.gen, 5)
        p = curve.mul(curve.gen, 7)
        assert curve.add(p, curve.mul(curve.gen, 11)) == curve.mul(curve.gen, 18)
        assert curve.add(p, p) == curve.mul(curve.gen, 14)
        assert curve.add(p, curve.mul(curve.gen, bn254.R - 7)) is None


def test_generators_match_the_programs_constants():
    from hekaton_tpu_torch.curves import host as ch

    g2 = ch.g2_gen()
    assert ((g2[0].c0, g2[0].c1), (g2[1].c0, g2[1].c1)) == bn254.G2_GEN
    assert ch.g1_gen() == bn254.G1_GEN
    k = 0x1234567890ABCDEF1234567890
    q = ch.pt_mul(g2, k)
    assert ((q[0].c0, q[0].c1), (q[1].c0, q[1].c1)) == bn254.G2.mul(bn254.G2.gen, k)


def test_mod_arith_against_python_ints():
    rs = random.Random(5)
    for m in (bn254.P, bn254.R):
        ar = limbs.ModArith(m, "cpu")
        xs = [rs.randrange(m) for _ in range(60)] + [0, 1, m - 1]
        ys = [rs.randrange(m) for _ in range(60)] + [m - 1, m - 1, m - 1]
        a, b = ar.tensor(xs, mont=True), ar.tensor(ys, mont=True)
        rinv = pow(1 << 256, -1, m)

        def dec(t):
            return [v * rinv % m for v in bn254.from_limbs(t.numpy())]

        assert dec(ar.mul(a, b)) == [x * y % m for x, y in zip(xs, ys)]
        assert dec(ar.add(a, b)) == [(x + y) % m for x, y in zip(xs, ys)]
        assert dec(ar.sub(a, b)) == [(x - y) % m for x, y in zip(xs, ys)]
        nz = [x or 3 for x in xs]
        assert dec(ar.batch_inv(ar.tensor(nz, mont=True))) == [pow(x, -1, m) for x in nz]


@pytest.mark.parametrize("config,distinct", [("bn254-g1-2p20", 16), ("bn254-g2-2p20", 16)])
def test_point_set_has_its_logs(config, distinct):
    spec = small_spec(config, "uniform", 64, distinct)
    cell = msm_driver.Cell(spec["cfg"], traffic.load(spec["mix_file"]), 2**40 + 3, "cpu")
    cell.make_points()
    na, nb, ka, kb = cell._rows()
    k0, delta = cell._logs()
    for i in (0, 1, 15, 16, 17, 63):
        k = (ka[i // nb] + kb[i % nb]) % bn254.R
        if config.startswith("bn254-g1"):
            assert k == (k0 + i * delta) % bn254.R
        pt = (cell._coord(cell.ax[i]), cell._coord(cell.ay[i]))
        assert pt == cell.curve.mul(cell.curve.gen, k)
    assert cell.points_off() == 0


@pytest.mark.parametrize("config,mix", [("bn254-g1-2p20", "uniform"), ("bn254-g1-2p20", "witness"),
                                        ("bn254-g2-2p20", "witness")])
def test_expected_point_is_the_sum(config, mix):
    """The dot product of logs and scalars against a sum of s_i P_i."""
    spec = small_spec(config, mix, 32, 16)
    cell = msm_driver.Cell(spec["cfg"], traffic.load(spec["mix_file"]), 987654321987, "cpu")
    cell.make_points()
    s = bn254.from_limbs(cell.inputs(3).numpy())
    acc = None
    for i, si in enumerate(s):
        pt = (cell._coord(cell.ax[i]), cell._coord(cell.ay[i]))
        acc = cell.curve.add(acc, cell.curve.mul(pt, si))
    assert cell.expected(3) == acc


# --- traffic ----------------------------------------------------------------


def test_traffic_seeding_and_shares():
    mix = traffic.load(os.path.join(ROOT, "hkbench", "traffic", "witness.json"))
    n = 1 << 16

    def draw(seed):
        return traffic.draw(mix, n, traffic.generator(seed, "cpu"), "cpu")

    a, b = draw(traffic.derive_seed(2**33 + 1, "x", 0)), draw(traffic.derive_seed(2**33 + 1, "x", 0))
    assert torch.equal(a, b)
    assert not torch.equal(a, draw(traffic.derive_seed(2**33 + 1, "x", 1)))
    vals = bn254.from_limbs(a.numpy())
    assert max(vals) < bn254.R
    for cls in mix["classes"]:
        lo = int(cls["low"])
        hi = bn254.R if cls["high"] == "field" else int(cls["high"])
        got = sum(1 for v in vals if lo <= v < hi) / n
        sd = math.sqrt(cls["share"] * (1 - cls["share"]) / n)
        assert abs(got - cls["share"]) <= 5 * sd + 1e-9, cls["name"]


def test_traffic_files_are_valid():
    for name in os.listdir(os.path.join(ROOT, "hkbench", "traffic")):
        mix = traffic.load(os.path.join(ROOT, "hkbench", "traffic", name))
        assert mix["name"] + ".json" == name


def test_uniform_traffic_reaches_the_top_bits():
    mix = traffic.load(os.path.join(ROOT, "hkbench", "traffic", "uniform.json"))
    s = traffic.draw(mix, 4096, traffic.generator(1, "cpu"), "cpu")
    assert work.bit_length(s) == 254


# --- the work count ---------------------------------------------------------


def _least_plain(vals: list) -> int:
    b = max(vals).bit_length()
    if b == 0:
        return 0
    best = None
    for c in range(1, work.MAX_WINDOW + 1):
        nz = 0
        for v in vals:
            carry = 0
            for w in range(math.ceil(b / c)):
                d = ((v >> (w * c)) & ((1 << c) - 1)) + carry
                carry = int(d > 1 << (c - 1))
                nz += d % (1 << c) != 0
            nz += carry
        total = nz + (math.ceil(b / c) << (c - 1))
        best = total if best is None else min(best, total)
    return best


def test_work_count_against_plain_loop():
    rs = random.Random(11)
    cases = [[0] * 8, [1] * 8, [1, 0, 0, 1], [rs.randrange(bn254.R) for _ in range(40)],
             [rs.choice([0, 1, 2, rs.randrange(1 << 32), rs.randrange(bn254.R)]) for _ in range(60)]]
    for vals in cases:
        s = torch.from_numpy(bn254.to_limbs(vals)).to(torch.int32)
        assert work.least_additions(s) == _least_plain(vals)
    zeros = torch.zeros((4, 16), dtype=torch.int32)
    assert work.least_seconds(zeros, 1528, 64, 32) == 4 * 96 / work.HBM_BYTES_PER_S


# --- the trace readers ------------------------------------------------------


def _ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}


SYNTH = [
    _ev("user_annotation", trace.CALL, 100, 100),
    _ev("cpu_op", "aten::sort", 105, 10),
    _ev("cuda_runtime", "cudaStreamSynchronize", 150, 49),
    _ev("kernel", "void (anonymous namespace)::horner_kernel<1>(int const*, int)", 110, 20, 7),
    _ev("kernel", "void at::native::radixSortKernel<int>(int*)", 130, 10, 7),
    _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 145, 5, 7),
    _ev("kernel", "void at::native::fill<int>(int*)", 90, 5, 7),  # before the call: not the call's
    _ev("user_annotation", trace.CALL, 300, 100),
    _ev("kernel", "pmadd_rcb_g2_kernel(int const*)", 310, 40, 7),
    _ev("kernel", "void at::native::gather<int>(int*)", 390, 5, 7),
    _ev("cpu_op", "aten::item", 360, 20),
]


def test_trace_summary_and_readers():
    s = trace.summarize(SYNTH, {"horner_kernel", "pmadd_rcb_g2_kernel"})
    c0, c1 = s.calls
    assert (c0.device_us, c0.launches, c0.port_us, c0.other_us) == (35, 2, 20, 15)
    assert (c1.device_us, c1.launches, c1.port_us, c1.other_us) == (45, 2, 40, 5)
    assert s.window_s == pytest.approx(300e-6)
    assert s.busy_s == pytest.approx(80e-6)
    assert s.device_ops[0] == ["pmadd_rcb_g2_kernel", pytest.approx(40e-6)]
    gaps = dict(s.idle_gaps)
    assert gaps["host, no op"] == pytest.approx(160e-6)  # 150 .. 310, no host event at 230
    assert gaps["aten::item"] == pytest.approx(40e-6)  # 350 .. 390
    assert gaps["aten::sort"] == pytest.approx(10e-6)  # 100 .. 110
    assert gaps[trace.CALL] == pytest.approx(10e-6)  # 140 .. 145 and 395 .. 400
    for call in s.calls:
        call.least_s = 4e-6
    read = {m: run._reader("metrics", m)(s) for m in ("msm_device_ms", "msm_launches", "torch_ops_ms",
                                                       "curve_kernels_ms", "msm_roofline_pct", "device_idle_pct")}
    assert read["msm_device_ms"] == pytest.approx(0.040)
    assert read["msm_launches"] == 2
    assert read["torch_ops_ms"] == pytest.approx(0.010)
    assert read["curve_kernels_ms"] == pytest.approx(0.030)
    assert read["msm_roofline_pct"] == pytest.approx(10.0)
    assert read["device_idle_pct"] == pytest.approx(100 * 220 / 300)


def test_readers_return_nothing_without_device_time():
    empty = trace.summarize([_ev("user_annotation", trace.CALL, 0, 10)], set())
    for m in ("msm_device_ms", "msm_launches", "torch_ops_ms", "curve_kernels_ms", "msm_roofline_pct",
              "device_idle_pct"):
        assert run._reader("metrics", m)(empty) is None
    assert trace.summarize([], set()).calls == []


def test_port_kernel_names_and_ids():
    names = trace.port_kernel_names(os.path.join(ROOT, "hekaton_tpu_torch", "csrc"))
    assert {"mont_mul_kernel", "l1_rcb_mega_kernel", "horner_g2_kernel", "pmadd_rcb_g2_kernel"} <= names
    assert trace.kernel_id("void (anonymous namespace)::l1_rcb_mega_kernel<0>(int const*, int)") == \
        "l1_rcb_mega_kernel"
    assert trace.kernel_id("void at::native::vectorized_elementwise_kernel<4, at::native::(anonymous "
                           "namespace)::F, at::detail::Array<char*, 2> >(int, F)") == "vectorized_elementwise_kernel"


# --- the benchmark file and the result line ---------------------------------


def test_benchmark_file_names_existing_files():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert os.path.exists(os.path.join(ROOT, "hkbench", "drivers", cfg["driver"] + ".py"))
    for w in bench["workloads"]:
        assert os.path.exists(os.path.join(ROOT, "hkbench", "traffic", w["traffic"] + ".json"))
    for m in bench["end_to_end"]:
        assert m["name"] == "setup_s" or os.path.exists(os.path.join(ROOT, "hkbench", "e2e", m["name"] + ".py"))
    for m in bench["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "hkbench", "metrics", m["name"] + ".py"))
    for w in bench["workloads"]:
        spec = run.load_cell(w["name"])
        assert {m["name"] for m in spec["end_to_end"]} >= {"setup_s"} and spec["per_layer"]


def test_result_line_shape():
    res = {"correct": True, "attempted": 3, "failed": 0, "memory_peak_bytes": 123,
           "metrics": {"msm_points_per_s": {"value": 1.5, "unit": "points/s"}},
           "busy": (0.5, 1.0), "breakdown": {"device_ops": [["k", 0.1]], "idle_gaps": [["h", 0.2]]},
           "checks": [("mismatch_pct", 0.0, 0.0), ("points_off", 0.0, 0.0)]}
    line = json.loads(run.result_line(res, "NVIDIA H100 80GB HBM3", 1, traced=False))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["device"] == {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                              "memory_peak_bytes": 123}
    line = json.loads(run.result_line(res, "NVIDIA H100 80GB HBM3", 1, traced=True))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"]
    assert (line["device"]["busy_s"], line["device"]["window_s"]) == (0.5, 1.0)
    assert line["checks"]["mismatch_pct"] == {"value": 0.0, "limit": 0.0}


def test_p95_nearest_rank():
    assert run.p95(list(range(1, 101))) == 95
    assert run.p95([3.0]) == 3.0


# --- the no-JAX rule --------------------------------------------------------

BLOCK = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "hekaton_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
"""


def _python(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", BLOCK + code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_no_jax_in_the_harness_or_the_program():
    out = _python("""
import os, importlib, json
import hkbench.run, hkbench.control, hkbench.drivers.msm as d
for kind in ("e2e", "metrics"):
    for f in sorted(os.listdir(os.path.join("hkbench", kind))):
        if f.endswith(".py") and f != "__init__.py":
            importlib.import_module(f"hkbench.{kind}.{f[:-3]}")
import hekaton_tpu_torch.msm.pippenger, hekaton_tpu_torch.cpgroth16.backend
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "hekaton_tpu"))))
""")
    assert json.loads(out.strip().splitlines()[-1]) == []


def test_reference_imports_nothing_of_the_program():
    out = _python("""
import json
import hkbench.bn254, hkbench.limbs, hkbench.traffic, hkbench.work, hkbench.trace, hkbench.drivers.msm
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0] == "hekaton_tpu_torch")))
""")
    assert json.loads(out.strip().splitlines()[-1]) == []


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "hekaton_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxfoo", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "hekaton_tpu.fields", sys)
    assert run.forbidden_modules() == ["hekaton_tpu.fields"]


# --- whole runs on the CPU, the control and the faults ----------------------

CELLS = [("bn254-g1-2p20", "uniform", 1024, 256), ("bn254-g1-2p20", "witness", 1024, 256),
         ("bn254-g2-2p20", "witness", 256, 64)]


@pytest.mark.parametrize("config,mix,n,distinct", CELLS)
def test_cpu_rehearsal_is_correct(config, mix, n, distinct):
    res = run.measure(small_spec(config, mix, n, distinct), 2**31 + 77, 1e-3, False, device="cpu")
    assert res["attempted"] >= 1 and res["failed"] == 0 and res["correct"]
    assert set(res["metrics"]) == {"msm_points_per_s", "msm_p95_ms", "setup_s"}


@pytest.mark.parametrize("config,mix,n,distinct", CELLS)
def test_control_is_not_correct(config, mix, n, distinct):
    from hkbench import control

    got = control.readings(small_spec(config, mix, n, distinct), 2**31 + 5, 2, device="cpu")
    assert got["program"]["mismatch_pct"] == 0.0
    assert got["control"]["mismatch_pct"] == 100.0


def _faults():
    from hekaton_tpu_torch.msm.pippenger import msm_gpu

    def stale():
        seen = []

        def entry(ax, ay, sc):  # the first answer (the warm-up's) for every call
            if not seen:
                seen.append(msm_gpu(ax, ay, sc, c=5, L=8))
            return seen[0]
        return entry

    def half():
        def entry(ax, ay, sc):  # half of the batch left out
            h = ax.shape[0] // 2
            return msm_gpu(ax[:h].contiguous(), ay[:h].contiguous(), sc[:h].contiguous(), c=5, L=8)
        return entry

    def altered():
        def entry(ax, ay, sc):  # the answer altered where it is produced
            out = msm_gpu(ax, ay, sc, c=5, L=8)
            x = out.x.clone()
            x[..., 0] ^= 1
            return type(out)(x, out.y, out.z)
        return entry

    return {"stale": stale, "half": half, "altered": altered}


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_faults_are_not_correct(fault):
    entry = _faults()[fault]()
    res = run.measure(small_spec("bn254-g1-2p20", "witness", 1024, 256), 2**31 + 9, 1e-3, False,
                      device="cpu", entry=entry)
    assert not res["correct"] and res["failed"] == res["attempted"] >= 1


def test_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    assert run.main(["--workload", "g1-2p20-uniform", "--seed", "1", "--seconds", "1", "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""


@pytest.mark.chip
def test_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "-m", "hkbench.run", "--workload", "g1-2p20-uniform", "--seed",
                          "3000000001", "--seconds", "3", "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
