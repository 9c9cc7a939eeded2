"""Inputs of the port's mesh tests, and the rank program of their rehearsal
over gloo (tests/test_torch_mesh_ranks.py).

    python tests/mesh_ranks.py RANK WORLD STORE OUT KEY_FILE

runs one rank of a world of four CPU processes: it joins the process group
through the file store STORE, builds a 2x2 and a 1x4 mesh, runs the sharded
NTT, the sharded MSM, DistributedProverStep and MeshProver on them, and
writes what it got to OUT/rank<RANK>.pkl as plain ints and bytes. It
imports the port alone (JAX and the JAX package are blocked), so the
parent compares the results with the JAX package and the host.

Not a test module: pytest does not collect it.
"""
from __future__ import annotations

import pickle
import sys
from datetime import timedelta

import numpy as np

BLOCKED = ("jax", "jaxlib", "hekaton_tpu")
N_NTT = 1024
N_MSM = 64
STEP_NBITS = 24  # the bit length of step_case's scalars


def step_case(ch, host_ntt, S: int = 4, m: int = 16, ncols: int = 8, m0: int = 8, m1: int = 8, seed: int = 5) -> dict:
    """Host inputs of a DistributedProverStep at small nbits: CRS tables
    with an infinity point and an infinity tail (zero scalars there), and
    per subcircuit scalars below 2^STEP_NBITS. The evaluations come from
    polynomials A, B with coefficients below 2^8 and C = A*B on the domain,
    so the witness map's h (the coefficients of A*B above X^m) stays below
    m 2^16 < 2^STEP_NBITS. `ch` and `host_ntt` are a
    package's curves/host.py and cpgroth16/backend.py::_host_ntt (the points
    are that package's)."""
    R = ch.R

    rs = np.random.RandomState(seed)

    def pts(gen, n, tail):
        out = [ch.pt_mul(gen, int(k)) for k in rs.randint(1, 2**30, size=n)]
        out[1] = None
        return out[: n - tail] + [None] * tail

    def small(n, bits, tail=0):
        vals = [int(v) for v in rs.randint(0, 2**bits, size=n, dtype=np.int64)]
        return vals[: n - tail] + [0] * tail

    case = {"m": m, "ck": pts(ch.g1_gen(), m0, 2), "a": pts(ch.g1_gen(), ncols, 2), "b": pts(ch.g1_gen(), ncols, 2),
            "bh": pts(ch.g2_gen(), ncols, 2), "h": pts(ch.g1_gen(), m - 1, 0) + [None], "l": pts(ch.g1_gen(), m1, 1)}
    case["w0"] = [small(m0, STEP_NBITS, 2) for _ in range(S)]
    case["z"] = [small(ncols, STEP_NBITS, 2) for _ in range(S)]
    case["w1"] = [small(m1, STEP_NBITS, 1) for _ in range(S)]
    evs = []
    for _ in range(S):
        a_ev, b_ev = (host_ntt(small(m, 8)) for _ in range(2))
        evs.append((a_ev, b_ev, [x * y % R for x, y in zip(a_ev, b_ev)]))
    case["evs"] = evs
    return case


def step_expected(case: dict, msm_host, witness_map_host) -> dict:
    """The host's result of every MSM of `step_case`'s step: stage 0, then
    A, H, L, B in G1 and B in G2 per subcircuit."""
    m = case["m"]
    hs = [witness_map_host(*ev) for ev in case["evs"]]
    assert all(v < 2**STEP_NBITS for h in hs for v in h)
    return {
        "stage0": [msm_host(case["ck"], w) for w in case["w0"]],
        "a": [msm_host(case["a"], z) for z in case["z"]],
        "h": [msm_host(case["h"][: m - 1], h) for h in hs],
        "l": [msm_host(case["l"], w) for w in case["w1"]],
        "bg": [msm_host(case["b"], z) for z in case["z"]],
        "bh": [msm_host(case["bh"], z) for z in case["z"]],
    }


def run_step(mesh, case: dict, rows: slice, force_ladder: bool, batched_tables: bool) -> dict:
    """DistributedProverStep's two stages on this row's subcircuits `rows`
    of `step_case`; returns every row's results as host points."""
    import torch

    from hekaton_tpu_torch.curves.torch_curve import G1, G2
    from hekaton_tpu_torch.fields import torch_field as tf
    from hekaton_tpu_torch.msm.pippenger import pack_scalars
    from hekaton_tpu_torch.runtime.spmd import DistributedProverStep, ProverStepKeys

    dev = mesh.device
    S_local = rows.stop - rows.start

    def tab(curve, key):
        ax, ay = (torch.from_numpy(a).to(dev) for a in curve.pack_affine(case[key]))
        if batched_tables:
            return tuple(a[None].expand((S_local,) + a.shape).contiguous() for a in (ax, ay))
        return ax, ay

    def sc(key):
        return torch.stack([pack_scalars(v, G1) for v in case[key][rows]]).to(dev)

    keys = ProverStepKeys(*tab(G1, "ck"), *tab(G1, "a"), *tab(G1, "h"), *tab(G1, "l"),
                          *tab(G1, "b"), *tab(G2, "bh"))
    step = DistributedProverStep(mesh, keys, domain_size=case["m"], nbits=STEP_NBITS, batched_tables=batched_tables,
                                 force_ladder=force_ladder)
    out = {"stage0": G1.unpack_jacobian(step.stage0(sc("w0")))}
    evs = [torch.stack([tf.tensor(tf.FR.pack(ev[k]), dev) for ev in case["evs"][rows]]) for k in range(3)]
    res = step.stage1(*evs, sc("z"), sc("w1"))
    for name, curve, p in zip(("a", "h", "l", "bg", "bh"), (G1, G1, G1, G1, G2), res):
        out[name] = curve.unpack_jacobian(p)
    return out


def _g(pts: list, to_bytes) -> list:
    return [to_bytes(p) for p in pts]


def main(rank: int, world: int, store: str, out_dir: str, key_file: str) -> None:
    class _Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, _Block())
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from hekaton_tpu_torch.cpgroth16.backend import _host_ntt
    from hekaton_tpu_torch.cpgroth16.data_structures import serialize_proof
    from hekaton_tpu_torch.curves import host as ch
    from hekaton_tpu_torch.curves.torch_curve import G1
    from hekaton_tpu_torch.fields import torch_field as tf
    from hekaton_tpu_torch.fields.bn254 import R
    from hekaton_tpu_torch.msm.pippenger import pack_scalars
    from hekaton_tpu_torch.ntt.sharded import make_sharded_ntt
    from hekaton_tpu_torch.runtime.spmd import make_mesh, sharded_msm_fn

    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    mesh22 = make_mesh(4, sub=2, pts=2, device="cpu")
    mesh14 = make_mesh(4, sub=1, pts=4, device="cpu")
    out = {"coords": (mesh22.coords, mesh14.coords)}

    # the sharded NTT at D = 2 (the 2x2 mesh's pts rows) and D = 4, forward and back
    rs = np.random.RandomState(0)
    vals = [int(v) % R for v in rs.randint(1, 2**62, size=N_NTT)]
    x = tf.tensor(tf.FR.pack(vals), "cpu")
    for mesh, D in ((mesh22, 2), (mesh14, 4)):
        fwd = make_sharded_ntt(mesh, N_NTT)(x)
        out[f"ntt{D}"] = tf.FR.unpack(fwd)
        out[f"intt{D}"] = tf.FR.unpack(make_sharded_ntt(mesh, N_NTT, inverse=True)(fwd))

    # the sharded MSM over the whole 2x2 mesh
    p, base = ch.g1_gen(), []
    for _ in range(32):
        base.append(p)
        p = ch.pt_dbl(p)
    pts = [base[i % 32] for i in range(N_MSM)]
    scal = [int(v) for v in rs.randint(1, 2**60, size=N_MSM, dtype=np.int64)]
    ax, ay = (torch.from_numpy(a) for a in G1.pack_affine(pts))
    msm = sharded_msm_fn(mesh22, G1)(ax, ay, pack_scalars(scal, G1))
    out["msm"] = (pts, scal, G1.unpack_jacobian(type(msm)(*(a[None] for a in msm)))[0])

    # the prover step at 2x2, S = 4: this row's two subcircuits
    row = mesh22.coords[0]
    res = run_step(mesh22, step_case(ch, _host_ntt), slice(2 * row, 2 * row + 2), force_ladder=False,
                   batched_tables=True)
    out["step"] = {k: (_g(v, ch.g2_to_bytes) if k == "bh" else _g(v, ch.g1_to_bytes)) for k, v in res.items()}

    out["mesh_prover"] = _mesh_prover(mesh22, key_file, serialize_proof, ch)
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def _mesh_prover(mesh, key_file: str, serialize_proof, ch) -> dict:
    """cmd_work's flow on MeshProver (the algebraic exec-tree hash set):
    stage 0, the coordinator, stage 1, and on rank 0 the aggregate proof
    and its verification."""
    from hekaton_tpu_torch.host import AggProvingKey, Rng, agg_transcript, ipp_setup, tipa_key_from_ipp
    from hekaton_tpu_torch.protocol import eval_tree as et
    from hekaton_tpu_torch.protocol.coordinator import CoordinatorStage0State
    from hekaton_tpu_torch.runtime.keys import ProvingKeys
    from hekaton_tpu_torch.runtime.mesh_prover import MeshProver
    from hekaton_tpu_torch.workloads.chain import PortalChainCircuit

    et.set_tree_hash(et.ALGEBRAIC_TEST_HASH)
    keys = ProvingKeys.load(key_file)
    circ = PortalChainCircuit.rand(Rng.from_int(1000), keys.params)
    n = circ.num_subcircuits()
    rng = Rng.from_int(1000)
    mp = MeshProver(mesh, keys, device="cpu")
    stage0 = CoordinatorStage0State(circ)
    reqs0 = [stage0.gen_request(i) for i in range(n)]
    resps0 = mp.stage0_all(rng, PortalChainCircuit, reqs0)
    ipp_ck = ipp_setup(n, Rng.from_int(2000))
    stage1 = stage0.process_stage0_responses(ipp_ck, resps0)
    reqs1 = [stage1.gen_request(i) for i in range(n)]
    agg_state = stage1.into_agg_state()
    resps1 = mp.stage1_all(rng, PortalChainCircuit, reqs1)
    out = {"coms": [(r.subcircuit_idx, ch.g1_to_bytes(r.com), r.com_seed) for r in resps0],
           "proofs": [(r.subcircuit_idx, serialize_proof(r.proof)) for r in resps1],
           "public_inputs": list(agg_state.public_inputs)}
    if mesh.rank == 0:
        agg_pk = AggProvingKey(tipa_key_from_ipp(ipp_ck), keys.get_pk)
        agg_proof = agg_state.gen_agg_proof(agg_pk, resps1)
        out["aggregate_verified"] = agg_pk.verify_aggregate(agg_transcript(), agg_state.super_com, agg_proof,
                                                            agg_state.public_inputs)
    return out


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
