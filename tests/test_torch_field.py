"""The port's field layer (hekaton_tpu_torch.fields) against the JAX package.

Inputs are made with numpy from a seed and handed to both packages; every
comparison is exact (integer limbs). The CUDA wrappers are exercised on CPU
tensors, where they run their plain versions; their kernels are compared with
the same plain versions on the card by chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hekaton_tpu.fields import jax_field as jf
from hekaton_tpu.fields.bn254 import P, R
from hekaton_tpu_torch.fields import cuda_field as cf
from hekaton_tpu_torch.fields import torch_field as tf

# small tensors: one thread each, since pytest-xdist runs several workers at once
torch.set_num_threads(1)

SPECS = [(jf.FQ, tf.FQ), (jf.FR, tf.FR)]
IDS = ["fq", "fr"]


def _vals(modulus: int, n: int, seed: int) -> list:
    """n random field values with the edge values 0, 1 and p-1 first."""
    r = np.random.RandomState(seed)
    vals = [0, 1, modulus - 1]
    while len(vals) < n:
        words = r.randint(0, 2**32, size=8, dtype=np.uint64)
        vals.append(sum(int(w) << (32 * i) for i, w in enumerate(words)) % modulus)
    return vals[:n]


def _t(arr) -> torch.Tensor:
    return torch.from_numpy(np.asarray(arr).astype(np.int32))


def _same(got: torch.Tensor, exp) -> bool:
    return np.array_equal(got.numpy().astype(np.uint32), np.asarray(exp))


@pytest.mark.parametrize("spec_j,spec_t", SPECS, ids=IDS)
def test_pack_unpack_round_trip(spec_j, spec_t):
    vals = _vals(spec_t.modulus, 40, 1)
    for mont in (True, False):
        arr = spec_t.pack(vals, mont=mont)
        assert arr.dtype == np.int32 and arr.shape == (40, 16)
        assert np.array_equal(arr.astype(np.uint32), spec_j.pack(vals, mont=mont))
        assert spec_t.unpack(_t(arr), mont=mont) == vals
    assert spec_t.unpack(tf.consts(spec_t, "cpu")["one"]) == [1]


@pytest.mark.parametrize("spec_j,spec_t", SPECS, ids=IDS)
def test_add_sub_neg_mul_match_jax(spec_j, spec_t):
    a_vals = _vals(spec_t.modulus, 64, 2)
    b_vals = list(reversed(_vals(spec_t.modulus, 64, 3)))
    a_np, b_np = spec_j.pack(a_vals), spec_j.pack(b_vals)
    a, b = _t(a_np), _t(b_np)
    ref = jax.jit(
        lambda x, y: (
            jf.add(spec_j, x, y),
            jf.sub(spec_j, x, y),
            jf.neg(spec_j, x),
            jf.mont_mul(spec_j, x, y),
            jf.mont_mul(spec_j, x, y[5]),
        )
    )(jnp.asarray(a_np), jnp.asarray(b_np))
    assert _same(tf.add(spec_t, a, b), ref[0])
    assert _same(tf.sub(spec_t, a, b), ref[1])
    assert _same(tf.neg(spec_t, a), ref[2])
    assert _same(tf.mont_mul(spec_t, a, b), ref[3])
    # the wrapper on a CPU tensor is the plain version; b may broadcast
    assert _same(cf.mont_mul(spec_t, a, b), ref[3])
    assert _same(cf.mont_mul(spec_t, a, b[5]), ref[4])
    # the wide-batch product path (row accumulation) agrees with the narrow one
    wide = torch.cat([a] * 16)
    assert torch.equal(tf.mont_mul(spec_t, wide, torch.cat([b] * 16))[:64], tf.mont_mul(spec_t, a, b))
    assert torch.equal(tf.select(a[:, 0] > 100, a, b), torch.where((a[:, 0] > 100)[:, None], a, b))


@pytest.mark.parametrize("spec_j,spec_t", SPECS, ids=IDS)
def test_inversions_match_jax(spec_j, spec_t):
    vals = _vals(spec_t.modulus, 12, 4)
    a_np = spec_j.pack(vals)
    a = _t(a_np)
    exp = jf.mont_inv(spec_j, jnp.asarray(a_np))  # inv(0) = 0
    assert _same(tf.mont_inv(spec_t, a), exp)
    assert _same(cf.fermat_inv(spec_t, a), exp)
    assert _same(cf.fermat_inv_plain(spec_t, a), exp)
    # batch_inv takes nonzero lanes; odd lengths exercise the padding. The
    # JAX batch_inv is run at one width (every new width is a new XLA:CPU
    # compile, and eagerly one per op); all widths are held against one JAX
    # mont_inv of their lanes
    sizes = (1, 2, 13, 70)
    cases = [spec_j.pack([v or 1 for v in _vals(spec_t.modulus, m, 5 + m)]) for m in sizes]
    exp_all = np.asarray(jf.mont_inv(spec_j, jnp.asarray(np.concatenate(cases))))
    lo = 0
    for m, nz in zip(sizes, cases):
        exp = exp_all[lo : lo + m]
        lo += m
        assert _same(tf.batch_inv(spec_t, _t(nz)), exp), m
        assert _same(tf.batch_inv_plain(spec_t, _t(nz)), exp), m
    jax_batch_inv = jax.jit(lambda x: jf.batch_inv(spec_j, x))
    assert _same(tf.batch_inv(spec_t, _t(cases[2])), jax_batch_inv(jnp.asarray(cases[2])))
    nz = _t(spec_j.pack([v or 1 for v in vals])).reshape(3, 4, 16)
    got = tf.batch_inv(spec_t, nz)
    assert got.shape == nz.shape
    assert torch.equal(got, tf.mont_inv(spec_t, nz))


def test_fq2_ops_match_jax():
    """Fq2Ops (the mont_mul wrapper underneath) and Fq2Plain against
    jax_field's fq2 functions, with 0, 1, u and p-1 components."""
    from hekaton_tpu.fields.host import Fq2 as JaxFq2

    c0, c1 = _vals(P, 24, 6), list(reversed(_vals(P, 24, 7)))
    a_vals = [JaxFq2(x, y) for x, y in zip(c0, c1)] + [JaxFq2(0, 0), JaxFq2(1, 0), JaxFq2(0, 1)]
    b_vals = list(reversed(a_vals))
    a_np, b_np = jf.Fq2Ops.pack(a_vals), jf.Fq2Ops.pack(b_vals)
    assert np.array_equal(tf.Fq2Ops.pack(a_vals).astype(np.uint32), a_np)  # duck-typed (c0, c1)
    a, b = _t(a_np), _t(b_np)
    ja, jb = jnp.asarray(a_np), jnp.asarray(b_np)
    ref = jax.jit(lambda x, y: (jf.fq2_add(x, y), jf.fq2_sub(x, y), jf.fq2_neg(x), jf.fq2_mul(x, y),
                                jf.fq2_sqr(x), jf.fq2_is_zero(x)))(ja, jb)
    for ops in (tf.Fq2Ops, tf.Fq2Plain):
        got = (ops.add(a, b), ops.sub(a, b), ops.neg(a), ops.mul(a, b), ops.sqr(a), ops.is_zero(a))
        for g, r in zip(got[:5], ref[:5]):
            assert _same(g, r)
        assert np.array_equal(got[5].numpy(), np.asarray(ref[5]))
        assert _same(ops.mul(a, b[3]), jf.fq2_mul(ja, jb[3]))  # a broadcast constant
    unpacked = tf.Fq2Ops.unpack(a)
    assert [(v.c0, v.c1) for v in unpacked] == [(v.c0, v.c1) for v in a_vals]
    assert _same(tf.Fq2Ops.one((3,), "cpu"), jf.Fq2Ops.one((3,)))
    assert _same(tf.Fq2Ops.zeros((3,), "cpu"), jf.Fq2Ops.zeros((3,)))
    assert torch.equal(tf.Fq2Ops.select(a[:, 0, 0] > 100, a, b), torch.where((a[:, 0, 0] > 100)[:, None, None], a, b))


def test_wrappers_refuse_bad_input():
    a = _t(tf.FQ.pack([1, 2]))
    meta = a.to("meta")
    with pytest.raises(ValueError):
        cf.check_limbs("x", a[:, :8], a.device)
    with pytest.raises(TypeError):
        cf.check_limbs("x", a.long(), a.device)
    with pytest.raises(ValueError):
        cf.check_limbs("x", a.t(), a.device)
    with pytest.raises(ValueError):
        cf.check_limbs("x", meta, a.device)
    with pytest.raises(ValueError):
        cf._field_id(tf.FieldSpec(2**61 - 1, "m61", nlimbs=4))
    assert cf._field_id(tf.FQ) == 0 and cf._field_id(tf.FR) == 1
    assert P != R
