"""The distributed prover's compute phases over a (sub x pts) mesh of ranks.

Port of hekaton_tpu/runtime/spmd.py onto torch.distributed. The JAX module
shards one jitted program over a device mesh with shard_map; here each rank
is a process with one device, and the mesh is `Mesh`, a grid of ranks with
one process group per `pts` row and one per `sub` column:

 - subcircuits are split over the `sub` axis: each row of ranks proves its
   own share of the batch (the reference's scatter, mpi-snark node.rs:
   461-604), and the results are gathered to every rank (its gather);
 - every MSM's point range is split over the `pts` axis: each rank of a row
   runs a local MSM on its share, and the partial sums are all-gathered
   over the row and folded in rank order with point adds (`fold_partials`;
   point addition is not a ring op, so no all-reduce applies);
 - the QAP witness map runs batched over the row's subcircuits with the
   port's NTT on the rank's device.

The local MSM follows TorchBackend's rule (cpgroth16/backend.py::
device_msm: the compact msm below COMPACT_PAD, msm_gpu above it), or
with `force_ladder` msm/pippenger.py::_msm_ladder everywhere (on BN254 G1 on
the card: jac_ladder, then jac_sum). The witness map is the backend's too
(cpgroth16/backend.py::witness_map_device). Every device op is one of the port's kernel
wrappers, so on a CUDA mesh (NCCL) every curve and field op is a kernel, and
on a CPU mesh (gloo) the plain versions run. A CUDA mesh never falls back to
gloo or to the CPU.

The host coordinator (exec tree, Fiat-Shamir, pairings) stays off the
device, as in the JAX package.
"""
from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..cpgroth16.backend import device_msm, witness_map_device
from ..curves.torch_curve import G1, G2, CurveOps, Jac
from ..fields import torch_field as tf
from ..fields.cuda_field import mont_mul
from ..msm import pippenger as pip

AXES = ("sub", "pts")


class Mesh:
    """A (sub, pts) grid of the process group's ranks: rank r sits at
    (r // pts, r % pts). `group("pts")` is this rank's row (the ranks that
    split one MSM's points), `group("sub")` its column (the ranks that hold
    the same point share of different subcircuits), `group("all")` the
    world. Every rank creates every group, in the same order, as
    torch.distributed requires."""

    def __init__(self, sub: int, pts: int, device):
        world = dist.get_world_size()
        if sub * pts != world:
            raise ValueError(f"mesh {sub}x{pts} needs {sub * pts} ranks, the process group has {world}")
        self.shape = (sub, pts)
        self.rank = dist.get_rank()
        self.coords = (self.rank // pts, self.rank % pts)
        self.device = torch.device(device)
        rows = [dist.new_group([i * pts + j for j in range(pts)]) for i in range(sub)]
        cols = [dist.new_group([i * pts + j for i in range(sub)]) for j in range(pts)]
        self._groups = {"pts": rows[self.coords[0]], "sub": cols[self.coords[1]], "all": dist.group.WORLD}

    def size(self, axis: str) -> int:
        return self.shape[0] * self.shape[1] if axis == "all" else self.shape[AXES.index(axis)]

    def index(self, axis: str) -> int:
        return self.rank if axis == "all" else self.coords[AXES.index(axis)]

    def group(self, axis: str):
        return self._groups[axis]


def mesh_shape(n: int, sub: int | None = None, pts: int | None = None) -> tuple:
    """The JAX make_mesh's (sub, pts) for n devices: unless both are given,
    pts defaults to 2 for an even n above 2, else 1, and sub = n // pts."""
    if sub is None or pts is None:
        pts = pts or (2 if n % 2 == 0 and n > 2 else 1)
        sub = n // pts
    if sub * pts != n:
        raise ValueError(f"mesh {sub}x{pts} != {n} devices")
    return sub, pts


def _store_dir() -> str:
    path = tempfile.mkdtemp(prefix="hekaton_mesh_")
    atexit.register(shutil.rmtree, path, True)
    return path


def init_group(device) -> None:
    """Initialise the default process group for a mesh on `device`, unless
    one is: NCCL for a CUDA device, gloo for the CPU. Under torchrun (RANK
    and WORLD_SIZE set) from its environment, otherwise a group of one rank
    from a file store in a temporary directory. An existing group must have
    the device's backend."""
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if not dist.is_initialized():
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, init_method=f"file://{_store_dir()}/store", rank=0, world_size=1)
    if dist.get_backend() != backend:
        raise RuntimeError(f"a {torch.device(device).type} mesh runs on {backend}; the process group is "
                           f"{dist.get_backend()}")


def make_mesh(n_devices: int | None = None, sub: int | None = None, pts: int | None = None,
              device="cuda") -> Mesh:
    """2-D mesh (sub, pts) of the process group's ranks, one device each:
    subcircuit-parallel x point-parallel. Initialises the group if none is
    (`init_group`). n_devices defaults to the world size, and the shape to
    the JAX package's rule (`mesh_shape`); sub * pts must be the world size.
    A CUDA rank takes the card of its LOCAL_RANK (torchrun), else card 0."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: a CUDA mesh needs a card (torch.cuda.is_available() is false)")
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    init_group(device)
    world = dist.get_world_size()
    n = n_devices or world
    sub, pts = mesh_shape(n, sub, pts)
    if n != world:
        raise ValueError(f"mesh {sub}x{pts} over {n} devices, but the process group has {world} ranks")
    return Mesh(sub, pts, device)


def _gather(p: Jac, mesh: Mesh, axis: str) -> Jac:
    """All-gather a point batch over one mesh axis -> a new leading axis in
    rank order. One rank on the axis issues no collective."""
    D = mesh.size(axis)
    if D == 1:
        return Jac(*(a[None] for a in p))
    out = []
    for a in p:
        parts = [torch.empty_like(a) for _ in range(D)]
        dist.all_gather(parts, a.contiguous(), group=mesh.group(axis))
        out.append(torch.stack(parts))
    return Jac(*out)


def fold_partials(curve: CurveOps, parts: Jac) -> Jac:
    """Fold a small leading axis of Jacobian partials with point adds, in
    order: ((p0 + p1) + p2) + ... One partial is returned as it is, with no
    add."""
    n = parts.x.shape[0]
    acc = Jac(*(a[0] for a in parts))
    for i in range(1, n):
        acc = curve.add(acc, Jac(*(a[i] for a in parts)))
    return acc


def _local_msms(curve: CurveOps, entries: list, nbits: int | None, force_ladder: bool) -> list:
    """This rank's MSMs of equal-length entries [(ax, ay, scalars)], stacked:
    with force_ladder one batched _msm_ladder, else device_msm
    (TorchBackend's route for the length; a batch of compact MSMs runs as
    one call)."""
    stacked = [torch.stack(t) for t in zip(*entries)]
    out = pip._msm_ladder(curve, *stacked, nbits) if force_ladder else device_msm(curve, *stacked, nbits)[1]
    return [Jac(*(a[i] for a in out)) for i in range(len(entries))]


def _share(n: int, mesh: Mesh, axis: str) -> slice:
    D, j = mesh.size(axis), mesh.index(axis)
    if n % D:
        raise ValueError(f"{n} points do not split over {D} ranks of {axis!r}")
    return slice(j * (n // D), (j + 1) * (n // D))


def sharded_msm_fn(mesh: Mesh, curve: CurveOps = G1):
    """MSM with the point dimension split over the whole mesh.

    The returned f(ax, ay, scalars) takes the whole MSM on every rank (ax,
    ay [n, ...limbs], scalars [n, 16] plain limbs, n a multiple of the
    world size); each rank runs the local MSM on its share (rank r takes
    rows [r n/W, (r+1) n/W)), the partials are gathered and folded. The
    result, an unbatched Jacobian point, is the same on every rank."""

    def run(ax, ay, scalars):
        sl = _share(ax.shape[0], mesh, "all")
        part = _local_msms(curve, [(ax[sl].contiguous(), ay[sl].contiguous(), scalars[sl].contiguous())], None,
                           False)[0]
        return fold_partials(curve, _gather(part, mesh, "all"))

    return run


@dataclass
class ProverStepKeys:
    """CRS point tables of the prover step, as tensors on the mesh's device:
    [n, 16] affine limbs each (G2: [n, 2, 16]), or with batched_tables a
    leading [S_local] axis, one table per subcircuit of this sub row. Every
    table holds the whole point range; each pts rank takes its share. A
    table that a stage does not read may be None (MeshProver passes stage 0
    the committer bases alone)."""

    ck_ax: torch.Tensor | None  # stage-0 committer bases      [m0, 16]
    ck_ay: torch.Tensor | None
    a_ax: torch.Tensor | None  # A-query bases                 [ncols, 16]
    a_ay: torch.Tensor | None
    h_ax: torch.Tensor | None  # H-query bases                 [m-1 padded to m, 16]
    h_ay: torch.Tensor | None
    l_ax: torch.Tensor | None  # last-stage committer bases    [m1, 16]
    l_ay: torch.Tensor | None
    # B-query bases (prover.rs:92-108): a G1 copy and a G2 copy. None = an
    # A/H/L-only step
    b_ax: torch.Tensor | None = None  # [ncols, 16]
    b_ay: torch.Tensor | None = None
    bh_x: torch.Tensor | None = None  # [ncols, 2, 16] (G2 affine, Fq2)
    bh_y: torch.Tensor | None = None


class DistributedProverStep:
    """The two barriered compute phases of the distributed prover (the
    reference's scatter -> compute -> gather rounds, node.rs:477-604):

    stage0(w0):  per-subcircuit commitment MSMs;
    stage1(...): per-subcircuit QAP witness map and A/H/L (and B) MSMs.

    Each rank passes its sub row's subcircuits, S_local of them, with every
    vector whole (the pts ranks of a row pass the same tensors); every MSM
    is split over pts, its partials folded over the row, and the results of
    all rows gathered, so each stage returns all sub * S_local results, row
    after row, on every rank. The JAX step runs one jitted program a stage
    and batches equal-length MSMs (`_msm_grouped`, vmap); here the local
    MSMs of one length on the compact route (the ladder or the bucket msm)
    run as one batched call, those on msm_gpu one after another, with equal
    results. Its `compiler_options`
    have no meaning in torch and are dropped.

    nbits: the scalars' bit length (254 for Fr scalars; tests pass a small
    width for small scalars). batched_tables: the keys carry one table per
    local subcircuit ([S_local] leading axis) instead of one shared table.
    force_ladder: every MSM on pippenger's double-and-add ladder.
    """

    def __init__(self, mesh: Mesh, keys: ProverStepKeys, domain_size: int, nbits: int = 254,
                 batched_tables: bool = False, force_ladder: bool = False):
        self.mesh = mesh
        self.keys = keys
        self.domain_size = domain_size
        self.nbits = nbits
        self.batched_tables = batched_tables
        self.force_ladder = force_ladder
        self._one_plain = tf.tensor(tf.FR.pack([1], mont=False)[0], mesh.device)

    def _msm_jobs(self, curve: CurveOps, jobs: dict) -> dict:
        """jobs: name -> (tx, ty, scalars [S_local, n, 16]) of this row.
        Every local MSM runs on this rank's point share (equal shares
        batched by _local_msms); the partials are folded over pts and the
        rows gathered over sub -> name -> [S] Jacobians."""
        groups = {}
        for name, (tx, ty, sc) in jobs.items():
            sl = _share(sc.shape[1], self.mesh, "pts")
            for s in range(sc.shape[0]):
                ax, ay = (tx[s], ty[s]) if self.batched_tables else (tx, ty)
                groups.setdefault(sl.stop - sl.start, []).append(
                    ((name, s), (ax[sl].contiguous(), ay[sl].contiguous(), sc[s, sl].contiguous())))
        parts = {}
        for items in groups.values():
            outs = _local_msms(curve, [e for _, e in items], self.nbits, self.force_ladder)
            parts.update(zip((key for key, _ in items), outs))
        S_local = next(iter(jobs.values()))[2].shape[0]
        part = Jac(*(torch.stack([torch.stack([parts[(name, s)][i] for s in range(S_local)]) for name in jobs])
                     for i in range(3)))  # [k, S_local, ...]
        folded = fold_partials(curve, _gather(part, self.mesh, "pts"))
        rows = _gather(folded, self.mesh, "sub")  # [sub, k, S_local, ...]
        flat = Jac(*(a.transpose(0, 1).reshape((len(jobs), -1) + a.shape[3:]) for a in rows))
        return {name: Jac(*(a[k] for a in flat)) for k, name in enumerate(jobs)}

    def stage0(self, w0, keys: ProverStepKeys | None = None) -> Jac:
        """w0 [S_local, m0, 16] plain limbs -> the commitment MSMs, [S]."""
        k = keys or self.keys
        return self._msm_jobs(G1, {"ck": (k.ck_ax, k.ck_ay, w0)})["ck"]

    def stage1(self, a_ev, b_ev, c_ev, assignment, w1, keys: ProverStepKeys | None = None) -> tuple:
        """a_ev, b_ev, c_ev [S_local, m, 16] Montgomery limbs; assignment
        [S_local, ncols, 16] and w1 [S_local, m1, 16] plain limbs. Returns
        the (A, H, L) MSMs, plus (B_g1, B_g2) when the keys carry the B
        tables, each [S] Jacobians. `keys` overrides the tables bound at
        construction (one step serves every CRS of the same padded shape)."""
        k = keys or self.keys
        if a_ev.shape[-2] != self.domain_size:
            raise ValueError(f"evaluations of {a_ev.shape[-2]} points, the step's domain is {self.domain_size}")
        h = witness_map_device(torch.stack([a_ev, b_ev, c_ev]))
        # plain limbs for the digits: a Montgomery product by plain 1
        h_plain = mont_mul(tf.FR, h.contiguous(), self._one_plain)
        # the H query has domain_size - 1 rows: mask the padded last scalar
        h_plain[..., -1, :] = 0
        jobs = {"a": (k.a_ax, k.a_ay, assignment), "h": (k.h_ax, k.h_ay, h_plain), "l": (k.l_ax, k.l_ay, w1)}
        if k.b_ax is not None:
            jobs["bg"] = (k.b_ax, k.b_ay, assignment)
        res = self._msm_jobs(G1, jobs)
        if k.b_ax is None:
            return res["a"], res["h"], res["l"]
        # B query in G2 (prover.rs:92-108)
        return res["a"], res["h"], res["l"], res["bg"], self._msm_jobs(G2, {"bh": (k.bh_x, k.bh_y, assignment)})["bh"]
