"""CP-Groth16 (Mirage) data structures.

Copy of hekaton_tpu/cpgroth16/data_structures.py without JAX: the proof
carries per-stage commitments `ds`; the VK has one delta per stage; the PK
carries a CommitterKey with one commitment basis per stage. Group-element
vectors are held as PointVec wrappers that keep host affine points and
lazily cache packed int32 limb tensors for the port's MSMs ((n, 16) per
coordinate on G1, (n, 2, 16) on G2, by the curve descriptor's
`pack_affine`). The pickled
form (host points + curve name) is the JAX package's, so key files written
by either package load into the other's classes (runtime/keys.py).
"""
from __future__ import annotations

import numpy as np
import torch

from ..curves.torch_curve import G1, G2, CurveOps


class PointVec:
    """A vector of affine points: host list + lazily-packed device tensors."""

    def __init__(self, points: list, curve: CurveOps):
        self.points = points
        self.curve = curve
        self._chunks = {}

    def __len__(self):
        return len(self.points)

    def __getitem__(self, i):
        return self.points[i]

    def slice(self, lo: int, hi: int) -> "PointVec":
        """Host-level sub-vector (device packing rebuilt lazily per slice)."""
        return PointVec(self.points[lo:hi], self.curve)

    def device_chunk(self, lo: int, hi: int, m: int, device):
        """Packed (ax, ay) int32 limb tensors on `device` for points[lo:hi],
        zero-padded (= infinity rows) to m rows — memoized on THIS vector,
        so chunked MSMs over a long-lived proving key pack each chunk once
        instead of per call."""
        key = (lo, hi, m, str(torch.device(device)))
        if key not in self._chunks:
            ax, ay = self.curve.pack_affine(self.points[lo:hi])
            if ax.shape[0] < m:
                pad = m - ax.shape[0]
                ax = np.concatenate([ax, np.zeros((pad,) + ax.shape[1:], ax.dtype)])
                ay = np.concatenate([ay, np.zeros((pad,) + ay.shape[1:], ay.dtype)])
            self._chunks[key] = (torch.from_numpy(ax).to(device), torch.from_numpy(ay).to(device))
        return self._chunks[key]

    # pickle support for the ProvingKeys package (runtime/keys.py): persist
    # host points + curve name only; device caches are rebuilt lazily
    def __getstate__(self):
        return {"points": self.points, "curve_name": self.curve.name}

    def __setstate__(self, state):
        self.points = state["points"]
        self.curve = G1 if state["curve_name"] == "g1" else G2
        self._chunks = {}


def g1vec(points):
    return PointVec(points, G1)


def g2vec(points):
    return PointVec(points, G2)


class VerifyingKey:
    """alpha_g, beta_h, gamma_h, per-stage deltas_h (last = delta_last),
    gamma_abc_g (one per instance variable incl. ONE)."""

    def __init__(self, alpha_g, beta_h, gamma_h, deltas_h, gamma_abc_g):
        self.alpha_g = alpha_g
        self.beta_h = beta_h
        self.gamma_h = gamma_h
        self.deltas_h = deltas_h
        self.gamma_abc_g = gamma_abc_g

    @property
    def last_delta_h(self):
        return self.deltas_h[-1]


class CommitterKey:
    """last_delta_g plus per-stage bases (beta*a_i + alpha*b_i + c_i)/delta_j."""

    def __init__(self, last_delta_g, deltas_abc_g):
        self.last_delta_g = last_delta_g
        self.deltas_abc_g = deltas_abc_g  # list[PointVec], one per stage


class ProvingKey:
    def __init__(self, vk, beta_g, a_g, b_g, b_h, h_g, ck, deltas_g, domain_size, num_instance, compiled=None):
        self.vk = vk
        self.beta_g = beta_g
        self.a_g = a_g  # PointVec over all columns [instance..., witness...]
        self.b_g = b_g
        self.b_h = b_h
        self.h_g = h_g  # PointVec, length domain_size - 1
        self.ck = ck
        self.deltas_g = deltas_g  # list of host points, one per stage
        self.domain_size = domain_size
        self.num_instance = num_instance
        # r1cs.fastsynth.CompiledMatrices for this shape (set by the
        # generator): enables value-only per-proof synthesis
        self.compiled = compiled

    @property
    def last_delta_g(self):
        return self.deltas_g[-1]

    def last_ck(self) -> PointVec:
        return self.ck.deltas_abc_g[-1]


class Proof:
    def __init__(self, a, b, c, ds):
        self.a = a  # G1 host point
        self.b = b  # G2 host point
        self.c = c  # G1 host point
        self.ds = ds  # list of G1 host points (per committed stage)

    def __eq__(self, other):
        return (self.a, self.b, self.c, tuple(self.ds)) == (
            other.a,
            other.b,
            other.c,
            tuple(other.ds),
        )


def serialize_proof(proof: Proof) -> bytes:
    from ..curves.host import g1_to_bytes, g2_to_bytes

    out = g1_to_bytes(proof.a) + g2_to_bytes(proof.b) + g1_to_bytes(proof.c)
    out += len(proof.ds).to_bytes(8, "little")
    for d in proof.ds:
        out += g1_to_bytes(d)
    return out


def deserialize_proof(data: bytes) -> Proof:
    from ..curves.host import g1_from_bytes, g2_from_bytes

    a = g1_from_bytes(data[:64])
    b = g2_from_bytes(data[64:192])
    c = g1_from_bytes(data[192:256])
    n = int.from_bytes(data[256:264], "little")
    ds = [g1_from_bytes(data[264 + 64 * i : 264 + 64 * (i + 1)]) for i in range(n)]
    return Proof(a, b, c, ds)
