"""The MSM cell: one closed-loop caller of the program's variable-base MSM.

Set-up makes the configuration's point set from the seed, reads (c, L) from
TorchBackend.msm_params(N), and warms the entry up on the cell's own shape.
Each call of the window draws fresh scalars from the traffic mix (outside
the call's timing) and runs

    hekaton_tpu_torch.msm.pippenger.msm_gpu(ax, ay, scalars, c=c, L=L)

on the default route, ending in torch.cuda.synchronize().

The point set has known discrete logs: point i is k_i G with k_i = k0 + i
delta (G1: rows a*B + b made as A_a + B_b on the device by hkbench/limbs.py
from two host chains; G2: `distinct_points` host-chain points tiled). So the
check needs no MSM of its own: a call's answer is (sum_i s_i k_i mod r) G.
The sum is one float64 product S^T K of the 16-bit limb matrices of the
scalars and the logs, exact because each of its 256 entries is a sum of
N products below 2^32, below 2^53 for N up to 2^21; the host folds the 256
entries modulo r and multiplies the generator (hkbench/bn254.py). Nothing
the program computed enters the reference but the outputs it judges.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .. import bn254, limbs, traffic, work

SAMPLED_POINTS = 8  # points of the set held to k_i G after the window


class Cell:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, entry=None):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, torch.device(device)
        self.curve = bn254.CURVES[cfg["curve"]]
        self.n = int(cfg["points"])
        self.entry = entry  # the call under test; None: msm_gpu on its default route
        self.ax = self.ay = None
        self._dlogs = None

    # --- set-up -----------------------------------------------------------

    def _logs(self):
        """(k0, delta) of the point set, from the seed."""
        rs = np.random.Generator(np.random.PCG64(traffic.derive_seed(self.seed, "points")))
        k0, delta = (int.from_bytes(rs.bytes(32), "little") % bn254.R for _ in range(2))
        return k0, delta or 1

    def _rows(self):
        """(na, nb, log of row block a, log of column b) for point a*nb + b."""
        k0, delta = self._logs()
        if self.cfg["maker"] == "block_sums":
            nb = int(self.cfg["block"])
            na = self.n // nb
            return na, nb, [a * nb * delta % bn254.R for a in range(na)], [(k0 + b * delta) % bn254.R
                                                                          for b in range(nb)]
        nd = int(self.cfg["distinct_points"])
        return self.n // nd, nd, [0] * (self.n // nd), [(k0 + b * delta) % bn254.R for b in range(nd)]

    def make_points(self):
        k0, delta = self._logs()
        curve, dev = self.curve, self.device
        if self.n % int(self.cfg.get("block") or self.cfg["distinct_points"]):
            raise ValueError("points must be a multiple of the block or of the distinct points")
        na, nb, _, _ = self._rows()
        b_pts = bn254.chain(curve, nb, k0, delta)
        bx, by = (torch.from_numpy(t).to(dev) for t in bn254.pack_points(curve, b_pts))
        if self.cfg["maker"] == "block_sums":
            step = nb * delta % bn254.R
            a_pts = bn254.chain(curve, na - 1, step, step)  # rows 1 .. na-1; row 0 is B itself
            ax, ay = (torch.from_numpy(t).to(dev) for t in bn254.pack_points(curve, a_pts))
            x, y = limbs.g1_block_sums(limbs.ModArith(bn254.P, dev), ax, ay, bx, by)
            self.ax = torch.cat([bx, x]).to(torch.int32).contiguous()
            self.ay = torch.cat([by, y]).to(torch.int32).contiguous()
        else:
            reps = (na,) + (1,) * (bx.dim() - 1)
            self.ax = bx.repeat(*reps).to(torch.int32).contiguous()
            self.ay = by.repeat(*reps).to(torch.int32).contiguous()

    def setup(self):
        from hekaton_tpu_torch.cpgroth16.backend import TorchBackend
        from hekaton_tpu_torch.msm.pippenger import msm_gpu

        self.c, self.L = TorchBackend.msm_params(self.n)
        if self.entry is None:
            self.entry = lambda ax, ay, sc: msm_gpu(ax, ay, sc, c=self.c, L=self.L)
        t0 = time.perf_counter()
        self.make_points()
        self.sync()
        t1 = time.perf_counter()
        for j in range(int(self.cfg["warmup_calls"])):
            self.call(self.inputs(j, "warmup"))
            self.sync()
        print(f"hkbench: set-up: points {t1 - t0:.3f} s, {self.cfg['warmup_calls']} warm-up calls "
              f"{time.perf_counter() - t1:.3f} s (c={self.c}, L={self.L})", file=sys.stderr)

    # --- the window -------------------------------------------------------

    items = property(lambda self: self.n)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def inputs(self, j: int, tag: str = "window"):
        gen = traffic.generator(traffic.derive_seed(self.seed, "scalars", tag, j), self.device)
        return traffic.draw(self.mix, self.n, gen, self.device)

    def call(self, scalars):
        return self.entry(self.ax, self.ay, scalars)

    # --- after the window -------------------------------------------------

    def least_seconds(self, j: int) -> float:
        cfg = self.cfg
        return work.least_seconds(self.inputs(j), int(cfg["muls_per_add"]), int(cfg["point_bytes"]),
                                  int(cfg["scalar_bytes"]))

    def _dlog_matrix(self) -> torch.Tensor:
        """(N, 16) float64 limbs of every point's discrete log."""
        if self._dlogs is None:
            na, nb, ka, kb = self._rows()
            ar = limbs.ModArith(bn254.R, self.device)
            ta, tb = ar.tensor(ka), ar.tensor(kb)
            ks = ar.add(ta[:, None, :].expand(na, nb, 16).reshape(-1, 16),
                        tb[None, :, :].expand(na, nb, 16).reshape(-1, 16))
            self._dlogs = ks.to(torch.float64)
        return self._dlogs

    def expected(self, j: int):
        """The affine point call j should return."""
        s = self.inputs(j).long().to(torch.float64)
        m = (s.t() @ self._dlog_matrix()).cpu().numpy()
        t = sum(int(m[a, b]) << (16 * (a + b)) for a in range(16) for b in range(16)) % bn254.R
        return self.curve.mul(self.curve.gen, t)

    def points_off(self) -> int:
        """Points of the set, sampled from the seed, that are not k_i G."""
        na, nb, ka, kb = self._rows()
        rs = np.random.Generator(np.random.PCG64(traffic.derive_seed(self.seed, "sampled points")))
        off = 0
        for i in [0, self.n - 1] + [int(v) for v in rs.integers(0, self.n, SAMPLED_POINTS - 2)]:
            k = (ka[i // nb] + kb[i % nb]) % bn254.R
            x, y = (self._coord(t[i]) for t in (self.ax, self.ay))
            off += (x, y) != self.curve.mul(self.curve.gen, k)
        return off

    def _coord(self, t):
        v = bn254.from_mont_limbs(t.reshape(-1, 16).cpu().numpy())
        return v[0] if len(v) == 1 else tuple(v)

    def check(self, outputs: list) -> tuple:
        """([(name, value, limit)] of the numbers compared, calls failed): the
        share of calls whose point is not the reference's (%), and the points
        of the set that are not k_i G; both must be 0."""
        bad = 0
        for j, out in outputs:
            got = bn254.unpack_jacobian(self.curve, *(t.cpu().numpy() for t in out))
            bad += not self.curve.jacobian_equals(got, self.expected(j))
        share = 100.0 * bad / len(outputs) if outputs else 100.0
        return [("mismatch_pct", share, 0.0), ("points_off", float(self.points_off()), 0.0)], bad
