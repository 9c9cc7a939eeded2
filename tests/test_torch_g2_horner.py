"""The BN254 G2 MSM's window Horner fold in one launch
(curves/cuda_curve.py::horner_fold_g2, kernel csrc/curve_g2.cu:
horner_g2_kernel) against its plain version, the JAX package's G2 combine
and the host MSM:

- a Python model of the kernel's schedule over Fq2, read from the kernel's
  source (the HG2_* macros: per point op a level of Fq2 products, its sums,
  a level, its sums; the window table of b3-scaled values), on values
  tagged with the phase that made them, so that a product reading a value
  of its own level or a later one, a level overwriting one of its own
  operands, or a level wider than the warp fails; held limb for limb to
  `horner_fold_g2_plain`;
- `horner_fold_g2_plain` against the JAX package's XLA `ProjOps` G2 `dbl` /
  `add` loop (hekaton_tpu/msm/pippenger.py:1145-1153; each Fq2 op jitted
  alone) on the CPU, with identity window sums, a first add that doubles
  and an add of an inverse pair;
- msm_gpu on G2 on the CPU: its Horner goes through the wrapper (one call),
  no pdbl_rcb_g2 call is left, and the result equals the host MSM;
- the wrapper refuses a W outside 1..HORNER_G2_MAX_W (the kernel source's
  HG2_MAX_W) and c < 0.

On the CPU the wrapper runs its plain version; chip_smoke.py holds the
kernel against it on the card at the main paths' (W, c) and on edge sets.
"""
import os
import re

import jax
import numpy as np
import pytest
import torch

import hekaton_tpu.curves.host as jch
from hekaton_tpu.curves.proj import Proj as JaxProj
from hekaton_tpu.curves.proj import ProjOps as JaxProjOps
from hekaton_tpu.fields import jax_field as jf
from hekaton_tpu_torch.curves import cuda_curve as cc
from hekaton_tpu_torch.curves import host as ch
from hekaton_tpu_torch.curves.proj import PROJ_G2
from hekaton_tpu_torch.curves.torch_curve import G2
from hekaton_tpu_torch.fields import torch_field as tf
from hekaton_tpu_torch.fields.host import Fq2
from hekaton_tpu_torch.msm import pippenger as tmsm

torch.set_num_threads(1)

P = tf.FQ.modulus
RINV = pow(1 << 256, -1, P)
CURVE_G2_CU = os.path.join(os.path.dirname(__file__), "..", "hekaton_tpu_torch", "csrc", "curve_g2.cu")
LANES = 32  # HG2_THREADS


def _src() -> str:
    return open(CURVE_G2_CU).read()


def _macro(name: str) -> str:
    """The body of the #define `name` of curve_g2.cu, continuation lines joined."""
    lines = _src()[_src().index(f"#define {name}("):].splitlines()
    text = ""
    for line in lines:
        text += line.rstrip("\\")
        if not line.rstrip().endswith("\\"):
            return text
    raise AssertionError(name)


def schedule() -> dict:
    """{"dbl"/"add": (level 1, sums 1, level 2, sums 2)}: a level's products
    as (a, b, out) slot names, a sum as (op, out, a, b)."""
    def muls(name):
        return re.findall(r"MUL\((\w+), (\w+), (\w+)\)", _macro(name))

    def sums(name):
        return re.findall(r"(ADD|SUB)\((\w+), (\w+), (\w+)\)", _macro(name))

    return {op: (muls(f"HG2_{op.upper()}_L1"), sums(f"HG2_{op.upper()}_S1"), muls(f"HG2_{op.upper()}_L2"),
                 sums(f"HG2_{op.upper()}_S2")) for op in ("dbl", "add")}


def slot_names() -> tuple:
    """(working slots, window-table slots) of the kernel's enum Slot."""
    body = _src()[_src().index("enum Slot : int {"):].split("};")[0]
    names = re.findall(r"\b([A-Z][A-Z0-9_]*)\b", body.split("{", 1)[1])
    work = names[: names.index("NSLOT")]
    return work, [n for n in names[names.index("NSLOT") + 1:] if n != "Q_END"]


# -- Fq2 values (Montgomery-form int pairs) and the kernel's model --

def _int(limbs) -> int:
    return sum(int(v) << (16 * i) for i, v in enumerate(np.asarray(limbs).astype(np.int64).reshape(-1)))


B3 = (_int(PROJ_G2._b3[0]), _int(PROJ_G2._b3[1]))  # b3 = 9/(9+u), Montgomery form


def f2_mul(a, b):
    """The kernel's product: component k = (a0 b_k + a1 (k ? b0 : p - b1)) R^-1."""
    return ((a[0] * b[0] - a[1] * b[1]) * RINV % P, (a[0] * b[1] + a[1] * b[0]) * RINV % P)


def f2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


class Ph:
    """An Fq2 value and the phase that made it (0: the window table and the
    accumulator an op starts from)."""

    def __init__(self, v, ph: int):
        self.v, self.ph = v, ph


def window_table(q) -> dict:
    """The kernel's window values of window sum q = (X, Y, Z)."""
    x, y, z = q
    bx, bz = f2_mul(x, B3), f2_mul(z, B3)
    return {"Q_X": x, "Q_Y": y, "Q_Z": z, "Q_3X": f2_add(f2_add(x, x), x), "Q_BX": bx, "Q_BY": f2_mul(y, B3),
            "Q_BZ": bz, "Q_BBZ": f2_mul(bz, B3), "Q_3BX": f2_add(f2_add(bx, bx), bx)}


def model_fold(win: list, c: int) -> tuple:
    """horner_g2_kernel on window sums `win` (W (X, Y, Z) of Fq2 int pairs)."""
    sch = schedule()
    work_names, q_names = slot_names()
    tables = [window_table(q) for q in win]
    assert sorted(tables[0]) == sorted(q_names)
    slots = {n: Ph(v, 0) for n, v in zip(("X", "Y", "Z", "BZ"), (*win[-1], tables[-1]["Q_BZ"]))}
    phase = [0]

    def level(muls, table):
        phase[0] += 1
        assert 2 * len(muls) <= LANES, "a level wider than the warp"
        outs = [o for _, _, o in muls]
        assert len(set(outs)) == len(outs) and not set(outs) & {s for a, b, _ in muls for s in (a, b)}, \
            "a level writes a slot twice or one of its own operands"
        new = {}
        for a, b, o in muls:
            va, vb = (Ph(table[s], 0) if s.startswith("Q_") else slots[s] for s in (a, b))
            assert va.ph < phase[0] and vb.ph < phase[0], f"{o} reads a value of its own level or a later one"
            assert o in work_names
            new[o] = Ph(f2_mul(va.v, vb.v), phase[0])
        slots.update(new)

    def sums(steps):
        for op, o, a, b in steps:
            assert o in work_names
            va, vb = slots[a], slots[b]
            slots[o] = Ph((f2_add if op == "ADD" else f2_sub)(va.v, vb.v), max(va.ph, vb.ph))

    for w in range(len(win) - 2, -1, -1):
        for _ in range(c):
            l1, s1, l2, s2 = sch["dbl"]
            level(l1, None), sums(s1), level(l2, None), sums(s2)
        l1, s1, l2, s2 = sch["add"]
        level(l1, tables[w]), sums(s1), level(l2, tables[w]), sums(s2)
    return tuple(slots[n].v for n in ("X", "Y", "Z"))


# -- window sums: host G2 points, as Fq2 int pairs and (W, 2, 16) limbs --

def _rand_fq2(rng) -> Fq2:
    return Fq2(int(rng.randint(1, 2**62)) ** 4 % P, int(rng.randint(1, 2**62)) ** 4 % P)


def proj_windows(pts: list, seed: int) -> list:
    """Host affine G2 points (None the identity) -> projective (X, Y, Z) host
    Fq2 triples under random z; the identity as (0:1:0)."""
    rng = np.random.RandomState(seed)
    out = []
    for p in pts:
        if p is None:
            out.append((Fq2.zero(), Fq2.one(), Fq2.zero()))
        else:
            z = _rand_fq2(rng)
            out.append((p[0] * z, p[1] * z, z))
    return out


def g2_points(W: int, seed: int) -> list:
    rng = np.random.RandomState(seed)
    return [ch.pt_mul(ch.g2_gen(), int(rng.randint(1, 2**62))) for _ in range(W)]


def edge_points(W: int, c: int, seed: int) -> list:
    """Window sums whose first add doubles (S_(W-2) = 2^c S_(W-1)), whose
    second gives the identity (S_(W-3) = -2^(2c+1) S_(W-1)), and whose
    window 0 is the identity."""
    pts = g2_points(W, seed)
    pts[W - 2] = ch.pt_mul(pts[W - 1], 1 << c)
    pts[W - 3] = ch.pt_neg(ch.pt_mul(pts[W - 1], 1 << (2 * c + 1)))
    pts[0] = None
    return pts


def limbs(win: list) -> tuple:
    """(W, 2, 16) Montgomery limb tensors of each coordinate."""
    return tuple(torch.from_numpy(np.asarray(tf.Fq2Plain.pack([w[k] for w in win])).astype(np.int32))
                 for k in range(3))


def as_ints(t: torch.Tensor) -> tuple:
    return _int(t[0]), _int(t[1])


def test_kernel_schedule_model_matches_plain():
    """The kernel's schedule (levels and sums read from curve_g2.cu) limb
    for limb against horner_fold_g2_plain, at small (W, c), on edge window
    sums, all-identity windows and c = 0."""
    sch = schedule()
    assert [len(sch[op][0]) for op in ("dbl", "add")] == [5, 12] and [len(sch[op][2]) for op in ("dbl", "add")] == [5, 8]
    cases = [(g2_points(4, 1), 3), (edge_points(6, 2, 2), 2), (edge_points(5, 0, 3), 0),
             ([None] * 3, 2), (g2_points(7, 4), 5)]
    for pts, c in cases:
        x, y, z = limbs(proj_windows(pts, 9))
        want = cc.horner_fold_g2_plain(x, y, z, c)
        win = [tuple(as_ints(t[w]) for t in (x, y, z)) for w in range(x.shape[0])]
        assert model_fold(win, c) == tuple(as_ints(t) for t in want), (len(pts), c)


def test_plain_matches_jax_g2_combine():
    """horner_fold_g2_plain limb for limb against the JAX package's XLA G2
    complete formulas (ProjOps over jf.Fq2Ops, each Fq2 op jitted alone, as
    msm_tpu's combine runs them at one lane), at (W, c) = (4, 3) and (6, 2),
    and as points against the host sum."""
    class JitFq2(jf.Fq2Ops):
        add = staticmethod(jax.jit(jf.fq2_add))
        sub = staticmethod(jax.jit(jf.fq2_sub))
        mul = staticmethod(jax.jit(jf.fq2_mul))
        sqr = staticmethod(jax.jit(jf.fq2_sqr))

    proj = JaxProjOps(JitFq2, jch.B_G2 * 3, "g2_proj_generic")
    for pts, c in ((edge_points(4, 3, 5), 3), (g2_points(6, 6), 2), (g2_points(1, 7) * 6, 0)):
        x, y, z = limbs(proj_windows(pts, 11))
        got = cc.horner_fold_g2_plain(x, y, z, c)
        j = [np.asarray(t.numpy()).view(np.uint32) for t in (x, y, z)]
        W = len(pts)
        acc = JaxProj(*(a[W - 1] for a in j))
        for w in range(W - 2, -1, -1):
            for _ in range(c):
                acc = proj.dbl(acc)
            acc = proj.add(acc, JaxProj(*(a[w] for a in j)))
        for g, e in zip(got, acc):
            assert np.array_equal(g.numpy().astype(np.uint32), np.asarray(e)), (W, c)
        want = None  # sum_w 2^(c w) S_w, from the top window down
        for p in reversed(pts):
            want = ch.pt_add(ch.pt_mul(want, 1 << c) if want is not None else None, p)
        jac = PROJ_G2.to_jacobian(type(got)(*(t[None] for t in got)))
        assert G2.unpack_jacobian(jac)[0] == want


def test_msm_gpu_g2_horner_goes_through_the_wrapper(monkeypatch):
    """msm_gpu on G2 (CPU tensors, 32-bit scalars: W = 5 windows of c = 7):
    one horner_fold_g2 call, no pdbl_rcb_g2 call, the host MSM's result."""
    calls = {"horner_fold_g2": 0, "pdbl_rcb_g2": 0}

    def counted(name, fn):
        def run(*args):
            calls[name] += 1
            return fn(*args)
        return run

    monkeypatch.setattr(tmsm, "horner_fold_g2", counted("horner_fold_g2", tmsm.horner_fold_g2))
    monkeypatch.setattr(cc, "pdbl_rcb_g2", counted("pdbl_rcb_g2", cc.pdbl_rcb_g2))  # ProjG2Ops looks it up
    rng = np.random.RandomState(21)
    pts = g2_points(12, 22)
    pts[3], pts[5] = None, pts[4]
    scal = [int(rng.randint(1, 2**32)) for _ in pts]
    scal[0], scal[5] = 0, scal[4]
    ax, ay = (torch.from_numpy(a.astype(np.int32)) for a in G2.pack_affine(pts))
    out = tmsm.msm_gpu(ax, ay, tmsm.pack_scalars(scal, G2), c=7, L=4, nbits=32)
    assert G2.unpack_jacobian(type(out)(*(a[None] for a in out)))[0] == ch.msm_host(pts, scal)
    assert calls == {"horner_fold_g2": 1, "pdbl_rcb_g2": 0}, calls


def test_wrapper_refuses_w_outside_its_range():
    """1 <= W <= HORNER_G2_MAX_W (the kernel source's HG2_MAX_W) and c >= 0;
    outside, the wrapper raises with the range in the message, on the CPU
    as on the card."""
    assert int(re.search(r"constexpr int HG2_MAX_W = (\d+);", _src()).group(1)) == cc.HORNER_G2_MAX_W
    x, y, z = limbs(proj_windows(g2_points(2, 8), 12))
    for W, c in ((0, 1), (cc.HORNER_G2_MAX_W + 1, 1), (2, -1)):
        t = x[:1].expand(W, 2, 16).contiguous() if W else x[:0]
        with pytest.raises(ValueError, match=f"1 <= W <= {cc.HORNER_G2_MAX_W}"):
            cc.horner_fold_g2(t, t, t, c)
    with pytest.raises(ValueError):
        cc.horner_fold_g2(x[0], y[0], z[0], 1)  # not (W, 2, 16)
    assert all(torch.equal(a, b) for a, b in zip(cc.horner_fold_g2(x, y, z, 1), cc.horner_fold_g2_plain(x, y, z, 1)))
