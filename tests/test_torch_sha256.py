"""The port's batched SHA-256 (hashes/sha256_torch.py) on CPU tensors,
against the JAX package's hashes/sha256_jax.py and hashlib:

- sha256_compress, bit for bit against the JAX sha256_compress, on 64
  random (state, block) pairs (words of 2^31 and above among them, where
  a sign error of 32-bit arithmetic shows) and on all-ones words;
- sha256_bytes_batch against hashlib and the JAX sha256_bytes_batch at
  lengths around the padding's block boundaries (0, 55, 56, 63, 64, 100,
  119 and 1,000 bytes);
- the iterated Merkle pattern of tests/test_sha256_jax.py;
- a batch of unequal lengths is refused."""
import hashlib

import numpy as np
import pytest
import torch

from hekaton_tpu.hashes import sha256_jax as jsha
from hekaton_tpu_torch.hashes import sha256_torch as tsha

# small tensors: one thread each, since pytest-xdist runs several workers at once
torch.set_num_threads(1)


def test_compress_matches_jax():
    import jax
    import jax.numpy as jnp

    rs = np.random.RandomState(3)
    state = rs.randint(0, 2**32, size=(66, 8), dtype=np.uint64).astype(np.uint32)
    block = rs.randint(0, 2**32, size=(66, 16), dtype=np.uint64).astype(np.uint32)
    state[64:], block[64] = 0xFFFFFFFF, 0xFFFFFFFF
    block[65] = 0
    assert (state >= 2**31).any(axis=1).all() and (block[:64] >= 2**31).any(axis=1).all()
    got = tsha.sha256_compress(torch.from_numpy(state.astype(np.int64)), torch.from_numpy(block.astype(np.int64)))
    want = np.asarray(jax.jit(jsha.sha256_compress)(jnp.asarray(state), jnp.asarray(block)))
    assert got.dtype == torch.int64 and ((got >= 0) & (got < 2**32)).all()
    assert np.array_equal(got.numpy().astype(np.uint32), want)
    # the constants are the JAX module's
    assert np.array_equal(tsha.IV, jsha.IV) and np.array_equal(tsha._K, jsha._K)


@pytest.mark.parametrize("length", [0, 55, 56, 63, 64, 100, 119, 1000])
def test_bytes_batch_matches_hashlib_and_jax(length):
    rs = np.random.RandomState(length)
    msgs = [rs.bytes(length) for _ in range(5)]
    msgs[0] = b"\xff" * length  # every word 2^32 - 1
    got = tsha.sha256_bytes_batch(msgs, device="cpu")
    assert got == [hashlib.sha256(m).digest() for m in msgs]
    assert got == jsha.sha256_bytes_batch(msgs)
    assert np.array_equal(tsha._bytes_to_blocks(msgs[1]), jsha._bytes_to_blocks(msgs[1]))
    # the batch's padding in one array is each message's own
    assert np.array_equal(tsha.messages_to_blocks(msgs)[1], tsha._bytes_to_blocks(msgs[1]))


def test_iterated_merkle_pattern():
    """Iterated hashing (the Big-Merkle node pattern: hash-of-hash chains)."""
    cur = [b"leaf-%d" % i for i in range(4)]
    for _ in range(3):
        cur = tsha.sha256_bytes_batch(cur, device="cpu")
    want = [b"leaf-%d" % i for i in range(4)]
    for _ in range(3):
        want = [hashlib.sha256(m).digest() for m in want]
    assert cur == want


def test_unequal_lengths_refused():
    with pytest.raises(ValueError):
        tsha.sha256_bytes_batch([b"ab", b"abc"], device="cpu")
    with pytest.raises(ValueError):
        tsha.sha256_bytes_batch([], device="cpu")
