"""Distributed runtime: the batched prover over a mesh of ranks.

Port of hekaton_tpu/runtime/__init__.py: the reference's mpi-snark crate
(OpenMPI scatter/gather, mpi-snark/src/bin/node.rs:461-604) becomes
torch.distributed process groups over a (sub, pts) mesh of ranks, one device
each: subcircuits split over "sub" (the reference's inter-node data
parallelism), MSM point ranges over "pts", with the partial sums gathered
and folded.
"""
from .spmd import (  # noqa: F401
    DistributedProverStep,
    fold_partials,
    make_mesh,
    sharded_msm_fn,
)
