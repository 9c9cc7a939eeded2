"""The port's device exec tree (protocol/eval_tree_torch.py) and batched
Poseidon (hashes/poseidon_torch.py), on CPU tensors, against the host tree
and hash and the JAX package's poseidon_jax: roots, levels, leaves and
digests equal bit for bit (tests/test_eval_tree_device.py's checks), and the
coordinator takes the device tree under HEKATON_DEVICE_TREE.
"""
import random
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hekaton_tpu.fields import jax_field as jf
from hekaton_tpu.fields.jax_field import FR as JFR
from hekaton_tpu.hashes import poseidon_jax
from hekaton_tpu_torch.fields import torch_field as tf
from hekaton_tpu_torch.fields.bn254 import R
from hekaton_tpu_torch.hashes import poseidon as pos
from hekaton_tpu_torch.hashes import poseidon_torch
from hekaton_tpu_torch.protocol import coordinator, eval_tree, eval_tree_torch
from hekaton_tpu_torch.protocol.transcript import RamTranscriptEntry, RomTranscriptEntry

# small tensors: one thread each, since pytest-xdist runs several workers at once
torch.set_num_threads(1)


def _t(vals) -> torch.Tensor:
    return tf.tensor(tf.FR.pack([v % R for v in vals]), "cpu")


def test_poseidon_batch_matches_host_and_jax(monkeypatch):
    # poseidon_jax's field ops jitted one at a time: eagerly its ~10^5
    # dispatches take a minute here, a jit of a whole hash minutes
    monkeypatch.setattr(poseidon_jax, "jf", types.SimpleNamespace(
        **{name: jax.jit(getattr(jf, name), static_argnums=0) for name in ("mont_mul", "mont_sqr", "add")}))
    rng = random.Random(23)
    lefts = [rng.randrange(R) for _ in range(5)]
    rights = [rng.randrange(R) for _ in range(5)]
    got = poseidon_torch.hash_two_to_one_batch(_t(lefts), _t(rights))
    assert tf.FR.unpack(got) == [pos.hash_two_to_one(a, b) for a, b in zip(lefts, rights)]
    ref = poseidon_jax.hash_two_to_one_batch(jnp.asarray(JFR.pack(lefts)), jnp.asarray(JFR.pack(rights)))
    assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(ref))

    # the leaf hash over 4 columns: one rate-3 absorb boundary crossed
    cols = [[rng.randrange(R) for _ in range(5)] for _ in range(4)]
    got = poseidon_torch.hash_leaf_batch([_t(c) for c in cols])
    assert tf.FR.unpack(got) == [pos.hash_leaf([cols[j][i] for j in range(4)]) for i in range(5)]
    ref = poseidon_jax.hash_leaf_batch([jnp.asarray(JFR.pack(c)) for c in cols])
    assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(ref))


class _FakeCom:
    def __init__(self, seed):
        self._b = seed

    def to_bytes(self):
        return self._b


def _rom_subtraces(rng, lens):
    return [[RomTranscriptEntry(rng.randrange(1, 1000), rng.randrange(R)) for _ in range(n)] for n in lens]


def _ram_subtraces(rng, lens):
    t = 0
    sts = []
    for n in lens:
        st = []
        for _ in range(n):
            st.append(RamTranscriptEntry(rng.randrange(1, 1000), rng.randrange(R), t, bool(rng.getrandbits(1))))
            t += 1
        sts.append(st)
    return sts


def _addr_sts(time_sts):
    return coordinator.sort_subtraces_by_addr(time_sts)


def _check_equal(host, dev):
    (t_host, l_host), (t_dev, l_dev) = host, dev
    assert t_host.root() == t_dev.root()
    assert t_host.levels == t_dev.levels
    assert [a.to_field_elements() for a in l_host] == [b.to_field_elements() for b in l_dev]


@pytest.mark.parametrize("mem_type", ["rom", "ram"])
def test_exec_tree_device_matches_host(mem_type):
    rng = random.Random(23)
    make = _rom_subtraces if mem_type == "rom" else _ram_subtraces
    time_sts = make(rng, [3, 0, 5, 2, 1, 0, 4, 2])
    addr_sts = _addr_sts(time_sts)
    com = _FakeCom(b"device-tree-test")
    _check_equal(coordinator.generate_exec_tree(mem_type, com, time_sts, addr_sts),
                 eval_tree_torch.generate_exec_tree_device(mem_type, com, time_sts, addr_sts, device="cpu"))


def test_prefix_products_match_a_running_product():
    rng = random.Random(5)
    vals = [rng.randrange(R) for _ in range(13)] + [0, 1]
    got = tf.FR.unpack(eval_tree_torch._prefix_products(_t(vals)))
    acc, want = 1, []
    for v in vals:
        acc = acc * v % R
        want.append(acc)
    assert got == want


def test_coordinator_takes_the_device_tree(monkeypatch):
    rng = random.Random(29)
    time_sts = _ram_subtraces(rng, [2, 4, 1, 3])
    addr_sts = _addr_sts(time_sts)
    com = _FakeCom(b"coordinator")
    monkeypatch.delenv("HEKATON_DEVICE_TREE", raising=False)
    host = coordinator.generate_exec_tree("ram", com, time_sts, addr_sts)
    calls = []
    fn = eval_tree_torch.generate_exec_tree_device

    def on_the_cpu(*a, device):
        # the branch asks for the card; the test builds the same tree on the CPU
        calls.append(device)
        return fn(*a, device="cpu")

    monkeypatch.setattr(eval_tree_torch, "generate_exec_tree_device", on_the_cpu)
    monkeypatch.setenv("HEKATON_DEVICE_TREE", "1")
    _check_equal(host, coordinator.generate_exec_tree("ram", com, time_sts, addr_sts))
    assert calls == ["cuda"]
    # another tree hash keeps the host tree (the batched hash is Poseidon's);
    # the device tree itself refuses it
    prev = eval_tree.set_tree_hash(eval_tree.ALGEBRAIC_TEST_HASH)
    try:
        tree, _ = coordinator.generate_exec_tree("ram", com, time_sts, addr_sts)
        assert len(calls) == 1 and tree.root() != host[0].root()
        with pytest.raises(ValueError):
            fn("ram", com, time_sts, addr_sts, device="cpu")
    finally:
        eval_tree.set_tree_hash(prev)
