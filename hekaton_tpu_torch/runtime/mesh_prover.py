"""The work pipeline's two prover stages over a mesh of ranks.

Port of hekaton_tpu/runtime/mesh_prover.py onto the port's torch.distributed
mesh (runtime/spmd.py). In place of the reference's two MPI scatter ->
compute -> gather rounds (mpi-snark node.rs:461-604), the per-subcircuit
prover algebra (the stage-0 commitment MSM, committer.rs:85-91, and the
stage-1 QAP witness map and A / B(G1) / B(G2) / H / L MSMs, prover.rs:
88-129) runs batched over the subcircuits with DistributedProverStep: each
row of the mesh (`sub`) synthesises and proves its own share of the
subcircuits, every MSM's points are split over the row's ranks (`pts`), and
the results are gathered to every rank.

Each subcircuit carries its own CRS tables (batched_tables), padded with
infinity to one common shape per QAP domain size, as the JAX package pads
them. Constraint synthesis and proof assembly stay on the host; every rank
assembles every proof from the gathered MSM results, so each returns the
same responses.

The RNG streams are the sequential worker's (protocol/worker.py and
cli.py's cmd_work), so the proofs are bit-identical to the single-process
pipeline's.
"""
from __future__ import annotations

import numpy as np
import torch

from ..cpgroth16.data_structures import Proof
from ..curves import host as ch
from ..curves.torch_curve import G1, G2
from ..fields import torch_field as tf
from ..fields.bn254 import R
from ..msm.pippenger import pack_scalars
from ..protocol.subcircuit import SubcircuitWithPortalsProver
from ..protocol.worker import Stage0Response, Stage1Response
from ..r1cs.builder import ConstraintSystem
from ..utils.rng import Rng
from .spmd import DistributedProverStep, ProverStepKeys


# the ProverStepKeys fields of each CRS table
_FIELDS = {"ck": ("ck_ax", "ck_ay"), "a": ("a_ax", "a_ay"), "h": ("h_ax", "h_ay"), "l": ("l_ax", "l_ay"),
           "bg": ("b_ax", "b_ay"), "bh": ("bh_x", "bh_y")}


def _pad_points(points: list, n: int) -> list:
    """Pad a host point table with infinity (contributes identity)."""
    assert len(points) <= n
    return list(points) + [None] * (n - len(points))


def _pad_scalars(vals: list, n: int) -> list:
    assert len(vals) <= n
    return [v % R for v in vals] + [0] * (n - len(vals))


class MeshProver:
    """Batched two-stage prover over a (sub x pts) mesh. Every rank runs

        mp = MeshProver(mesh, keys)
        resps0 = mp.stage0_all(rng, circuit_cls, reqs0)
        ... host coordinator: super-commitment + exec tree ...
        resps1 = mp.stage1_all(rng, circuit_cls, reqs1)

    with the same arguments, and gets every subcircuit's responses.
    `device` is the mesh's (by default the card); the JAX package's
    `compiler_options` have no meaning in torch and are dropped.
    """

    def __init__(self, mesh, keys, force_ladder: bool = False, device=None):
        device = mesh.device if device is None else torch.device(device)
        if device != mesh.device:
            raise ValueError(f"MeshProver on {device}, its mesh on {mesh.device}")
        self.mesh = mesh
        self.keys = keys  # runtime.keys.ProvingKeys
        self.device = device
        self.sub_ax, self.pts_ax = mesh.shape
        self.force_ladder = force_ladder
        self._states = {}  # subcircuit idx -> [wrapper, cs, com, kappa] (wrapper, cs: own rows only)
        self._steps = {}  # domain m -> DistributedProverStep
        self._rep_tabs = {}  # (representative idx, table) -> packed np (ax, ay)
        # one common padded shape per QAP domain size, maxed over all unique CRSs
        self._shape_for_m = {}
        for pk in keys.minimal_pks.values():
            m = pk.domain_size
            m0, nc, m1 = (
                self._ceil(len(pk.ck.deltas_abc_g[0])),
                self._ceil(len(pk.a_g)),
                self._ceil(len(pk.ck.deltas_abc_g[-1])),
            )
            cur = self._shape_for_m.get(m, (0, 0, 0))
            m0, nc, m1 = max(cur[0], m0), max(cur[1], nc), max(cur[2], m1)
            # the JAX package's table lengths: L up to A/B, and A/B/L up to m
            # when the domain covers the assignment width
            if m1 <= nc:
                m1 = nc
            if nc <= m:
                nc = m1 = m
            self._shape_for_m[m] = (m0, nc, m1)

    def _ceil(self, n: int) -> int:
        p = self.pts_ax
        return max(p, ((n + p - 1) // p) * p)

    def _table(self, rep: int, key: str) -> tuple:
        """One CRS point table of a unique CRS, padded with infinity to the
        domain's common shape (packed once, reused for every subcircuit of
        this rep: the reference's CRS dedup, data_structures.rs:72-83)."""
        if (rep, key) not in self._rep_tabs:
            pk = self.keys.minimal_pks[rep]
            m0, nc, m1 = self._shape_for_m[pk.domain_size]
            points, n, curve = {
                "ck": (pk.ck.deltas_abc_g[0].points, m0, G1),
                "a": (pk.a_g.points, nc, G1),
                "bg": (pk.b_g.points, nc, G1),
                "bh": (pk.b_h.points, nc, G2),
                # the H query has m-1 rows; the step masks the padded last scalar
                "h": (pk.h_g.points, pk.domain_size, G1),
                "l": (pk.ck.deltas_abc_g[-1].points, m1, G1),
            }[key]
            self._rep_tabs[(rep, key)] = curve.pack_affine(_pad_points(points, n))
        return self._rep_tabs[(rep, key)]

    def _step_for(self, m: int, keys: ProverStepKeys) -> DistributedProverStep:
        if m not in self._steps:
            self._steps[m] = DistributedProverStep(self.mesh, keys, domain_size=m, batched_tables=True,
                                                   force_ladder=self.force_ladder)
        return self._steps[m]

    def _pad_batch(self, n_rows: int) -> int:
        s = self.sub_ax
        return max(s, ((n_rows + s - 1) // s) * s)

    def _stack(self, rows) -> torch.Tensor:
        return torch.from_numpy(np.stack(rows)).to(self.device)

    def _batched_keys(self, reps: list, S_local: int, tables: tuple) -> ProverStepKeys:
        """[S_local]-stacked CRS tables of this row's subcircuits, those a
        stage reads (`tables`; the others None). Pad rows reuse the first
        item's tables; their scalars are zero."""
        reps = reps + [reps[0]] * (S_local - len(reps))
        fields = dict.fromkeys(f for pair in _FIELDS.values() for f in pair)
        for key in tables:
            for comp, field in enumerate(_FIELDS[key]):
                fields[field] = self._stack([self._table(rep, key)[comp] for rep in reps])
        return ProverStepKeys(**fields)

    def _layout(self, idxs) -> dict:
        """domain m -> (its subcircuits in index order, S, S_local, this
        row's slice of them). Row i of the mesh takes subcircuits
        [i S_local, (i+1) S_local) of each domain, as the JAX package's
        P("sub") sharding of the padded [S] batch does."""
        by_m = {}
        for idx in sorted(idxs):
            by_m.setdefault(self.keys.get_pk(idx).domain_size, []).append(idx)
        row = self.mesh.coords[0]
        out = {}
        for m, items in by_m.items():
            S = self._pad_batch(len(items))
            S_local = S // self.sub_ax
            out[m] = (items, S, S_local, items[row * S_local:(row + 1) * S_local])
        return out

    def _rows(self, pack, vals: list, width: int, S_local: int) -> torch.Tensor:
        rows = [pack(_pad_scalars(v, width)) for v in vals]
        rows += [pack([0] * width)] * (S_local - len(vals))
        return self._stack(rows)

    # -- stage 0: commitments ---------------------------------------------

    def stage0_all(self, rng: Rng, circuit_cls, reqs: list) -> list:
        """Batched equivalent of process_stage0_request over all requests.

        Each row synthesises the stage-0 witnesses of its own subcircuits
        (the two subtraces, subcircuit_circuit.rs:139-159); the commitment
        MSMs run in one DistributedProverStep.stage0 call per domain size
        (committer.rs:85-91 batched over the mesh)."""
        by_idx = {req.subcircuit_idx: req for req in reqs}
        seeds = {}
        for idx in by_idx:
            # seed/kappa stream identical to the sequential worker
            # (worker.py process_stage0_request_get_cb)
            com_seed = rng.fork(str(idx).encode()).next_seed()
            seeds[idx] = (com_seed, Rng(com_seed).next_fr())
        responses = {}
        for m, (items, S, S_local, mine) in self._layout(by_idx).items():
            m0, _, _ = self._shape_for_m[m]
            witnesses = []
            for idx in mine:
                req = by_idx[idx]
                prover = SubcircuitWithPortalsProver(circuit_cls, 2)
                prover.subcircuit_idx = idx
                prover.time_ordered_subtrace = req.time_ordered_subtrace
                prover.addr_ordered_subtrace = req.addr_ordered_subtrace
                fast = getattr(self.keys.get_pk(idx), "compiled", None) is not None
                cs = ConstraintSystem(value_only=fast)
                prover.generate_constraints(0, cs)
                # value-only mode defers satisfiability to the stage-1 compiled check
                assert fast or cs.is_satisfied(), f"unsatisfied stage-0 constraint @ {idx}"
                witnesses.append(cs.current_stage_witness())
                self._states[idx] = [prover, cs, None, seeds[idx][1]]
            reps = [self.keys.representatives[idx] for idx in (mine or items[:1])]
            skeys = self._batched_keys(reps, S_local, ("ck",))
            step = self._step_for(m, skeys)
            coms = step.stage0(self._rows(lambda v: pack_scalars(v, G1), witnesses, m0, S_local), keys=skeys)
            host_coms = G1.unpack_jacobian(coms)
            for k, idx in enumerate(items):
                seed, kappa = seeds[idx]
                com = ch.pt_add(host_coms[k], ch.pt_mul(self.keys.get_pk(idx).ck.last_delta_g, kappa))
                state = self._states.setdefault(idx, [None, None, None, kappa])
                state[2] = com
                responses[idx] = Stage0Response(idx, com, seed)
        return [responses[r.subcircuit_idx] for r in reqs]

    # -- stage 1: proofs ----------------------------------------------------

    def stage1_all(self, rng: Rng, circuit_cls, reqs1: list) -> list:
        """Batched equivalent of process_stage1_request_with_cb: each row
        fills its wrapper circuits (leaf, path, root, challenges) and
        synthesises their last stage; the witness map and the five proof
        MSMs run in one DistributedProverStep.stage1 call per domain size;
        every rank assembles every proof on the host (prover.rs:80-148,
        committer.rs:106-121)."""
        from ..cpgroth16.prover import _matrix_evals

        by_idx = {req.subcircuit_idx: req for req in reqs1}
        responses = {}
        for m, (items, S, S_local, mine) in self._layout(by_idx).items():
            m0, ncols, m1 = self._shape_for_m[m]
            own = []
            for idx in mine:
                req = by_idx[idx]
                wrapper, cs, _, _ = self._states[idx]
                underlying = circuit_cls.new(req.circ_params)
                underlying.set_serialized_witnesses(idx, req.serialized_witnesses)
                wrapper.circ = underlying
                wrapper.num_subcircuits = underlying.num_subcircuits()
                wrapper.cur_leaf = req.cur_leaf
                wrapper.next_leaf_membership = req.next_leaf_membership
                wrapper.root = req.root
                wrapper.challenges = req.cur_leaf.evals.challenge_list()
                wrapper.generate_constraints(1, cs)
                pk = self.keys.get_pk(idx)
                z = cs.full_assignment()
                w1 = cs.current_stage_witness()
                if cs.value_only:
                    a_ev, b_ev, c_ev = pk.compiled.evals(z, pk.domain_size, check=True)
                else:
                    assert cs.is_satisfied(), f"unsatisfied stage-1 constraint @ {idx}"
                    a_ev, b_ev, c_ev = _matrix_evals(cs, pk.domain_size)
                own.append((z, w1, a_ev, b_ev, c_ev))
            reps = [self.keys.representatives[idx] for idx in (mine or items[:1])]
            skeys = self._batched_keys(reps, S_local, ("a", "h", "l", "bg", "bh"))
            step = self._step_for(m, skeys)
            evs = [self._rows(tf.FR.pack, [o[k] for o in own], m, S_local) for k in (2, 3, 4)]
            assignment = self._rows(lambda v: pack_scalars(v, G1), [o[0] for o in own], ncols, S_local)
            w1s = self._rows(lambda v: pack_scalars(v, G1), [o[1] for o in own], m1, S_local)
            pa, ph, pl, pbg, pbh = step.stage1(*evs, assignment, w1s, keys=skeys)
            a_acc, h_acc, l_acc, bg_acc = (G1.unpack_jacobian(p) for p in (pa, ph, pl, pbg))
            bh_acc = G2.unpack_jacobian(pbh)

            for k, idx in enumerate(items):
                # r/s stream identical to cli.cmd_work's sequential path
                rng_i = rng.fork(b"s1" + str(idx).encode())
                r, s = rng_i.next_fr(), rng_i.next_fr()
                _, _, com, kappa = self._states[idx]
                pk = self.keys.get_pk(idx)
                # proof assembly: prover.rs:88-148 + committer.rs:106-121
                a_pt = ch.pt_add(ch.pt_add(a_acc[k], pk.vk.alpha_g), ch.pt_mul(pk.last_delta_g, r))
                b_pt_h = ch.pt_add(ch.pt_add(bh_acc[k], pk.vk.beta_h), ch.pt_mul(pk.vk.last_delta_h, s))
                b_pt_g = ch.pt_add(ch.pt_add(bg_acc[k], pk.beta_g), ch.pt_mul(pk.last_delta_g, s))
                c_pt = ch.pt_mul(a_pt, s)
                c_pt = ch.pt_add(c_pt, ch.pt_mul(b_pt_g, r))
                c_pt = ch.pt_sub(c_pt, ch.pt_mul(pk.last_delta_g, r * s % R))
                c_pt = ch.pt_add(c_pt, l_acc[k])
                c_pt = ch.pt_add(c_pt, h_acc[k])
                # C -= kappa * delta_0 over the committed stage
                c_pt = ch.pt_sub(c_pt, ch.pt_mul(pk.deltas_g[0], kappa))
                responses[idx] = Stage1Response(idx, Proof(a_pt, b_pt_h, c_pt, [com]))
        return [responses[r.subcircuit_idx] for r in reqs1]
