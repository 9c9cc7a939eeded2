"""Smoke run of the PyTorch + CUDA port (hekaton_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (the kernels are built from hekaton_tpu_torch/csrc
at first use) and a host C++ compiler (the native host library). Phases,
one line each, every failure raises:

  1. device: the card's name and power limit; build the kernels;
  2. kernels: each of the five CUDA kernels against its plain PyTorch version
     on the card, at the main path's shapes, bit for bit, with both times;
  3. the G1 MSM at 2^20 points against a closed-form host result;
  4. the slice: BASELINE.json configuration 1 (Big-Merkle, 4 subcircuits,
     1 SHA2 iteration, 8 portals) through the port's coordinator and worker
     with TorchBackend("cuda"): setup (host fixed-base), stage 0, stage 1,
     per-proof verify, SnarkPack aggregation and aggregate verify; a tampered
     proof is rejected; the stage-1 proofs equal HostBackend's bit for bit;
  5. coverage: every kernel's launch count over phases 3-4 (the counts are
     reset after phase 2) is above 0.

It prints the kernel table as one JSON line, the card's name and power limit,
and last {"ok": true, "device": {...}}. It exits non-zero, printing no
result, where torch.cuda.is_available() is false.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20261016
DEVICE = "cuda"
N_MSM = 1 << 20  # the G1 MSM of phase 3 (bench.py's size, TpuBackend.G1_CHUNK)
N_MUL = 1 << 20  # mont_mul lanes in phase 2
N_AFF = 1 << 18  # aff_add_fused lanes in phase 2
N_PLAN = 1 << 16  # points of the plan whose level-1 slab phase 2 reduces


def require(cond: bool, msg: str) -> None:
    """Fail the run (assert statements vanish under python -O)."""
    if not cond:
        raise RuntimeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(report: str) -> list:
    """(kernel, registers, spill-store bytes) from nvcc's -Xptxas -v output."""
    out, name, spill = [], None, 0
    for line in report.splitlines():
        m = re.search(r"entry function '_Z\w*?\d([a-z][a-z_]*_kernel)(?:ILi(\d)E)?", line)
        if m:
            name = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), spill))
            name = None
    return out


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps runs after one warm run (ms)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(got, ref) -> int:
    got = got if isinstance(got, (tuple, list)) else [got]
    ref = ref if isinstance(ref, (tuple, list)) else [ref]
    return max(int((g.long() - r.long()).abs().max()) for g, r in zip(got, ref))


def rand_limbs(n: int, gen: torch.Generator) -> torch.Tensor:
    """(n, 16) random canonical Montgomery limbs below 0x3064 * 2^240 (< p
    for both BN254 fields, whose top limb is 0x3064)."""
    limbs = torch.randint(0, 1 << 16, (n, 16), generator=gen, device=DEVICE, dtype=torch.int32)
    limbs[:, 15] %= 0x3064
    return limbs


def chain_points(n: int, k0: int, delta: int, h) -> list:
    """P_i = (k0 + i*delta) * G for i < n (n a multiple of 1024), as
    P_{1024a+b} = A_a + B_b with A_a = 1024*a*delta*G and B_b =
    (k0 + b*delta)*G, each block of 1024 sums sharing one host inversion."""
    P = h.P
    g = h.ch.g1_gen()
    step, big = h.ch.pt_mul(g, delta), h.ch.pt_mul(g, 1024 * delta % h.R)
    B = [h.ch.pt_mul(g, k0)]
    for _ in range(1023):
        B.append(h.ch.pt_add(B[-1], step))
    out = list(B)
    A = big
    for _ in range(1, n // 1024):
        xa, ya = A
        dens = [(xb - xa) % P for xb, _ in B]
        pre, acc = [], 1
        for d in dens:
            require(d != 0, "chain_points: a block sum met its own x (k0, delta collide)")
            acc = acc * d % P
            pre.append(acc)
        inv = pow(acc, P - 2, P)
        invs = [0] * 1024
        for j in range(1023, -1, -1):
            invs[j] = inv * pre[j - 1] % P if j else inv
            inv = inv * dens[j] % P
        for (xb, yb), iv in zip(B, invs):
            lam = (yb - ya) * iv % P
            x3 = (lam * lam - xa - xb) % P
            out.append((x3, (lam * (xa - x3) - ya) % P))
        A = h.ch.pt_add(A, big)
    return out


def phase_kernels(tf, cf, cc, proj, G1, pip, pts, gen) -> list:
    """Every kernel against its plain version at the main path's shapes."""
    rows = []

    def record(name, source, replaces, ms, plain_ms, err):
        require(err == 0, f"{name}: kernel differs from its plain version (max abs err {err})")
        log(f"[kernels] {name}: bit-identical, kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})

    # mont_mul: 2^20 lanes, Fq and Fr, with 0, 1 and p-1
    errs, times = 0, {}
    for spec in (tf.FQ, tf.FR):
        a, b = rand_limbs(N_MUL, gen), rand_limbs(N_MUL, gen)
        edge = tf.tensor(spec.pack([0, 1, spec.modulus - 1]), DEVICE)
        a[:3], b[3:6], a[6:9], b[6:9] = edge, edge, edge, edge.flip(0)
        got, ref = cf.mont_mul(spec, a, b), cf.mont_mul_plain(spec, a, b)
        torch.cuda.synchronize()
        errs = max(errs, max_abs_err(got, ref))
        times[spec.name] = (cuda_ms(lambda: cf.mont_mul(spec, a, b), 20),
                            cuda_ms(lambda: cf.mont_mul_plain(spec, a, b), 3))
        log(f"[kernels] mont_mul {spec.name} {N_MUL} lanes: kernel {times[spec.name][0]:.3f} ms, "
            f"plain {times[spec.name][1]:.3f} ms")
    record("mont_mul", "hekaton_tpu_torch/csrc/field.cu", "hekaton_tpu/fields/pallas_field.py:253",
           *times["fq"], errs)

    # fermat_inv: 1024 lanes (the batch_inv root width), with 0
    a = rand_limbs(1024, gen)
    a[:3] = tf.tensor(tf.FQ.pack([0, 1, tf.FQ.modulus - 1]), DEVICE)
    err = max_abs_err(cf.fermat_inv(tf.FQ, a), cf.fermat_inv_plain(tf.FQ, a))
    record("fermat_inv", "hekaton_tpu_torch/csrc/field.cu", "hekaton_tpu/fields/pallas_field.py:238",
           cuda_ms(lambda: cf.fermat_inv(tf.FQ, a), 20), cuda_ms(lambda: cf.fermat_inv_plain(tf.FQ, a), 1),
           err)

    # aff_add_fused: 2^18 lanes with infinity, doubling and inverse-pair lanes
    n = N_AFF
    ax, ay = pts
    x1, y1 = ax[:n].clone(), ay[:n].clone()
    x2, y2 = ax[n:2 * n].clone(), ay[n:2 * n].clone()
    x2[:64], y2[:64] = x1[:64], y1[:64]  # doubling lanes
    x2[64:128], y2[64:128] = x1[64:128], tf.neg(tf.FQ, y1[64:128])  # inverse pairs
    x1[128:192], y1[128:192] = 0, 0  # inf + Q
    x2[192:256], y2[192:256] = 0, 0  # P + inf
    x1[256:320], y1[256:320], x2[256:320], y2[256:320] = 0, 0, 0, 0  # inf + inf
    args = (x1, y1, x2, y2)
    err = max_abs_err(cc.aff_add_fused(*args), cc.aff_add_fused_plain(*args))
    record("aff_add_fused", "hekaton_tpu_torch/csrc/curve.cu", "hekaton_tpu/curves/pallas_curve.py:760",
           cuda_ms(lambda: cc.aff_add_fused(*args), 10), cuda_ms(lambda: cc.aff_add_fused_plain(*args), 2),
           err)

    # l1_aff_halves: the level-1 slab of a 2^16-point plan at L=32
    m = N_PLAN
    c, L = 11, 32
    scal = torch.randint(0, 1 << 16, (m, 16), generator=gen, device=DEVICE, dtype=torch.int32)
    scal[:, 15] %= 0x3064
    slab, _, meta = pip._plan_sorted_w(ax[:m].contiguous(), ay[:m].contiguous(), scal, c, L)
    err = max_abs_err(cc.l1_aff_halves(slab, L), cc.l1_aff_halves_plain(slab, L))
    log(f"[kernels] l1_aff_halves slab: {meta[4]} columns x L={L} ({m} points, c={c})")
    record("l1_aff_halves", "hekaton_tpu_torch/csrc/curve.cu", "hekaton_tpu/curves/pallas_curve.py:930",
           cuda_ms(lambda: cc.l1_aff_halves(slab, L), 5), cuda_ms(lambda: cc.l1_aff_halves_plain(slab, L), 1),
           err)

    # horner_fold: W=20 windows at c=13, compared in affine
    W = 20
    p = proj.PROJ_G1.dbl(proj.PROJ_G1.from_affine(ax[:W].contiguous(), ay[:W].contiguous()))
    p = proj.Proj(*(t.contiguous() for t in p))
    p.x[3], p.y[3], p.z[3] = 0, tf.consts(tf.FQ, DEVICE)["one"], 0  # an empty window
    got, ref = cc.horner_fold(p.x, p.y, p.z, 13), cc.horner_fold_plain(p.x, p.y, p.z, 13)
    g_aff = G1.unpack_jacobian(proj.PROJ_G1.to_jacobian(proj.Proj(*(t[None] for t in got))))
    r_aff = G1.unpack_jacobian(proj.PROJ_G1.to_jacobian(proj.Proj(*(t[None] for t in ref))))
    require(g_aff == r_aff, "horner_fold: kernel differs from its plain version in affine")
    record("horner_fold", "hekaton_tpu_torch/csrc/curve.cu", "hekaton_tpu/curves/pallas_curve.py:625",
           cuda_ms(lambda: cc.horner_fold(p.x, p.y, p.z, 13), 10),
           cuda_ms(lambda: cc.horner_fold_plain(p.x, p.y, p.z, 13), 1), 0)
    return rows


def slice_circuit(h):
    """BASELINE.json configuration 1: Big-Merkle, 4 subcircuits, 1 SHA2
    iteration, 8 portals (cli.py's setup-big-merkle arguments)."""
    params = h.MerkleTreeCircuitParams(4 // 2, 1, 8)
    return "big-merkle", h.MerkleTreeCircuit.rand(h.Rng.from_int(1000), params)


def run_work(h, keys, backend, circ):
    """cmd_work's calls through the port: stage 0, stage 1 (stateless
    recommit), returning (responses 0, responses 1, ipp key, agg state, secs)."""
    from hekaton_tpu_torch.protocol.coordinator import CoordinatorStage0State
    from hekaton_tpu_torch.protocol.worker import process_stage0_request, process_stage1_request

    n = circ.num_subcircuits()
    rng = h.Rng.from_int(1000)
    t0 = time.perf_counter()
    stage0 = CoordinatorStage0State(circ)
    reqs0 = [stage0.gen_request(i) for i in range(n)]
    resps0 = [process_stage0_request(rng.fork(str(i).encode()), type(circ), keys.get_pk(i), reqs0[i], backend)
              for i in range(n)]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ipp_ck = h.ipp_setup(n, h.Rng.from_int(2000))
    stage1 = stage0.process_stage0_responses(ipp_ck, resps0)
    reqs1 = [stage1.gen_request(i) for i in range(n)]
    agg_state = stage1.into_agg_state()
    t2 = time.perf_counter()
    resps1 = [
        process_stage1_request(rng.fork(b"s1" + str(i).encode()), type(circ), keys.get_pk(i), reqs0[i],
                               resps0[i], reqs1[i], backend)
        for i in range(n)
    ]
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    return resps0, resps1, ipp_ck, agg_state, {"stage0": t1 - t0, "exec_tree": t2 - t1, "stage1": t3 - t2}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    t_import = time.perf_counter()
    from hekaton_tpu_torch import cuda_lib
    from hekaton_tpu_torch import host as h
    from hekaton_tpu_torch.cpgroth16.backend import HostBackend, TorchBackend
    from hekaton_tpu_torch.cpgroth16.verifier import prepare_verifying_key, verify_proof
    from hekaton_tpu_torch.curves import cuda_curve as cc
    from hekaton_tpu_torch.curves import proj
    from hekaton_tpu_torch.curves.torch_curve import G1
    from hekaton_tpu_torch.fields import cuda_field as cf
    from hekaton_tpu_torch.fields import torch_field as tf
    from hekaton_tpu_torch.msm import pippenger as pip
    from hekaton_tpu_torch.runtime.keys import ProvingKeys

    require(h.native_available(), "native host library did not build")
    import_s = time.perf_counter() - t_import
    card = gpu_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind} x{torch.cuda.device_count()}; nvidia-smi: {card}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; port imported (native host library built) in {import_s:.1f} s")
    t = time.perf_counter()
    path, report = cuda_lib.build()
    cuda_lib.lib()
    log(f"[device] kernels built in {time.perf_counter() - t:.1f} s -> {os.path.basename(path)}")
    for name, regs, spill in ptxas_summary(report):
        log(f"[device] {name}: {regs} registers, {spill} bytes spilled")

    # the 2^20-point set of phase 3; phase 2 takes its shapes' inputs from it
    N = N_MSM
    rs = np.random.RandomState(SEED)
    k0, delta = (int.from_bytes(rs.bytes(32), "little") % h.R for _ in range(2))
    t = time.perf_counter()
    host_pts = chain_points(N, k0, delta, h)
    ks = [(k0 + i * delta) % h.R for i in range(N)]
    host_pts[5], ks[5] = None, 0  # an infinity row
    host_pts[7], ks[7] = host_pts[6], ks[6]  # a duplicate point
    words = rs.randint(0, 2**63, size=(N, 4), dtype=np.int64)
    scalars = [int(a) | int(b) << 63 | int(c) << 126 | int(d) << 189 for a, b, c, d in words]
    scalars = [s % h.R for s in scalars]
    scalars[0], scalars[1], scalars[2] = 0, 1, h.R - 1
    scalars[7] = scalars[6]
    ax_np, ay_np = G1.pack_affine(host_pts)
    ax, ay = torch.from_numpy(ax_np).to(DEVICE), torch.from_numpy(ay_np).to(DEVICE)
    sc = pip.pack_scalars(scalars).to(DEVICE)
    expected = h.ch.pt_mul(h.ch.g1_gen(), sum(s * k for s, k in zip(scalars, ks)) % h.R)
    log(f"[msm] {N} points and scalars made on the host in {time.perf_counter() - t:.1f} s")

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    rows = phase_kernels(tf, cf, cc, proj, G1, pip, (ax, ay), gen)

    # phases 3-4 are the main path: launch counts from here on
    kernels = {"mont_mul": cf.mont_mul, "fermat_inv": cf.fermat_inv, "aff_add_fused": cc.aff_add_fused,
               "l1_aff_halves": cc.l1_aff_halves, "horner_fold": cc.horner_fold}
    for fn in kernels.values():
        fn.launches = 0

    c, L = TorchBackend.msm_params(N)
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = pip.msm_gpu(ax, ay, sc, c=c, L=L)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t
    got = G1.unpack_jacobian(type(out)(*(a[None] for a in out)))[0]
    require(got == expected, f"{N}-point G1 MSM differs from the host result")
    warm = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        pip.msm_gpu(ax, ay, sc, c=c, L=L)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t)
    best = min(warm)
    log(f"[msm] G1 {N} points (c={c}, L={L}) equals the host result; first {cold:.3f} s, warm "
        f"{', '.join(f'{w:.3f}' for w in warm)} s, best {N / best:,.0f} points/s on {card}")
    del ax, ay, sc, out

    # the slice: BASELINE.json configuration 1
    backend = TorchBackend(DEVICE)
    circ_id, circ = slice_circuit(h)
    t = time.perf_counter()
    keys = ProvingKeys.generate(circ_id, circ, backend, lambda i: h.Rng.from_int(50 + i))
    setup_s = time.perf_counter() - t
    sizes = sorted({len(pk.a_g) for pk in keys.minimal_pks.values()} | {len(pk.h_g) for pk in keys.minimal_pks.values()})
    log(f"[slice] setup: {len(keys.minimal_pks)} unique CRSs in {setup_s:.1f} s (host fixed-base); "
        f"G1 MSM lengths {sizes}")
    resps0, resps1, ipp_ck, agg_state, secs = run_work(h, keys, backend, circ)
    n = circ.num_subcircuits()
    t = time.perf_counter()
    for i, r in enumerate(resps1):
        pvk = prepare_verifying_key(keys.get_pk(i).vk)
        require(verify_proof(pvk, r.proof, agg_state.public_inputs), f"proof {i} rejected")
    verify_s = time.perf_counter() - t
    t = time.perf_counter()
    agg_pk = h.AggProvingKey(h.tipa_key_from_ipp(ipp_ck), lambda i: keys.get_pk(i))
    agg_proof = agg_state.gen_agg_proof(agg_pk, resps1)
    agg_s = time.perf_counter() - t
    t = time.perf_counter()
    ok = agg_pk.verify_aggregate(h.agg_transcript(), agg_state.super_com, agg_proof, agg_state.public_inputs)
    agg_verify_s = time.perf_counter() - t
    require(ok is True, "aggregate proof rejected")
    bad = resps1[0].proof
    bad_c = bad.c
    bad.c = h.ch.pt_add(bad.c, h.ch.g1_gen())
    require(not verify_proof(prepare_verifying_key(keys.get_pk(0).vk), bad, agg_state.public_inputs),
            "a tampered proof verified")
    bad.c = bad_c
    log(f"[slice] {circ_id} {circ.get_params()} on {card}: stage0 {secs['stage0']:.2f} s, exec tree {secs['exec_tree']:.2f} s, "
        f"stage1 {secs['stage1']:.2f} s, verify {verify_s:.2f} s, aggregate {agg_s:.2f} s, "
        f"aggregate verify {agg_verify_s:.2f} s -> {ok}; tampered proof rejected")
    log(f"[slice] backend.ran {backend.ran}")
    counts = {name: fn.launches for name, fn in kernels.items()}

    host = HostBackend()
    h0, h1, _, _, hsecs = run_work(h, keys, host, circ)
    require([r.com for r in h0] == [r.com for r in resps0], "stage-0 commitments differ from HostBackend's")
    for i in range(n):
        p, q = resps1[i].proof, h1[i].proof
        require((p.a, p.b, p.c, p.ds) == (q.a, q.b, q.c, q.ds), f"stage-1 proof {i} differs from HostBackend's")
    log(f"[slice] all {n} stage-1 proofs equal HostBackend's bit for bit (HostBackend stage1 "
        f"{hsecs['stage1']:.2f} s)")

    log(f"[coverage] kernel launches over phases 3-4: {counts}")
    missing = [k for k, v in counts.items() if v <= 0]
    require(not missing, f"kernels never launched on the main path: {missing}")
    for row in rows:
        row["launches"] = counts[row["name"]]
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
