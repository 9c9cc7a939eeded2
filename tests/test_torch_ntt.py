"""The port's NTT (hekaton_tpu_torch.ntt) and TorchBackend.witness_map against
the JAX package's NTT and the host witness map, at n=256 (one iterative
plan) and n=1024 (the four-step split). Exact comparisons."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hekaton_tpu.cpgroth16.backend import witness_map_host
from hekaton_tpu.fields import jax_field as jf
from hekaton_tpu.fields.bn254 import R
from hekaton_tpu.ntt import ntt as jntt
from hekaton_tpu_torch.cpgroth16.backend import TorchBackend
from hekaton_tpu_torch.fields import torch_field as tf
from hekaton_tpu_torch.ntt import ntt as tntt

# small tensors: one thread each, since pytest-xdist runs several workers at once
torch.set_num_threads(1)


def _vals(n, seed):
    r = np.random.RandomState(seed)
    return [int(a) * int(b) * int(c) % R for a, b, c in r.randint(1, 2**62, size=(n, 3))]


@pytest.mark.parametrize("n", [256, 1024])
def test_ntt_and_cosets_match_jax(n):
    vals = _vals(n, n)
    arr = jf.FR.pack(vals)
    x = torch.from_numpy(arr.astype(np.int32))
    jx = jnp.asarray(arr)
    refs = jax.jit(lambda v: (jntt.ntt(v), jntt.ntt(v, inverse=True), jntt.coset_ntt(v), jntt.coset_intt(v)))(jx)
    gots = (tntt.ntt(x), tntt.ntt(x, inverse=True), tntt.coset_ntt(x), tntt.coset_intt(x))
    for got, ref in zip(gots, refs):
        assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(ref))
    # a batch of two polynomials transforms row by row
    both = tntt.ntt(torch.stack([x, x.flip(0)]))
    assert torch.equal(both[0], tntt.ntt(x)) and torch.equal(both[1], tntt.ntt(x.flip(0).contiguous()))
    assert tf.FR.unpack(tntt.ntt(tntt.ntt(x), inverse=True)) == vals


@pytest.mark.parametrize("n", [256, 1024])
def test_witness_map_matches_host(n):
    a, b, c = _vals(n, 1), _vals(n, 2), _vals(n, 3)
    backend = TorchBackend("cpu")
    assert backend.witness_map(a, b, c) == witness_map_host(a, b, c)
    assert backend.ran["witness_map_gpu"] == 1


def test_domain_matches_jax():
    for n in (5, 64):
        d, jd = tntt.Domain(n), jntt.Domain(n)
        assert (d.n, d.omega, d.omega_inv) == (jd.n, jd.omega, jd.omega_inv)
        assert d.lagrange_coeffs_at(12345) == jd.lagrange_coeffs_at(12345)
        assert d.elements() == jd.elements()
    assert tntt.root_of_unity(1 << 20) == jntt.root_of_unity(1 << 20)
    assert tntt.COSET_GEN == jntt.COSET_GEN
