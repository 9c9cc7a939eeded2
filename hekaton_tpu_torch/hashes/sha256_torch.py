"""Batched SHA-256 on torch tensors: the compression runs over lanes.

Port of hekaton_tpu/hashes/sha256_jax.py. The batch axis is the lane: one
sequence of 64 rounds processes N independent messages at once, for bulk
leaf hashing and trace generation beside hashes/poseidon_torch.py. The JAX
module is XLA (no Pallas kernel), and so is this one plain PyTorch: every
round is a few elementwise ops over all lanes on the tensors' device.

Words are int64 tensors holding unsigned 32-bit values: torch's `>>` on
int32 is an arithmetic shift and torch.uint32 has few operations, so every
add and every left shift is masked back to 32 bits. The entry point
`sha256_bytes_batch` defaults to the card, as the port's entry points do.
"""
from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF

_K = np.array(
    [
        0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
        0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
        0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
        0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
        0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
        0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
        0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
        0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
        0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
        0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
        0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
    ],
    dtype=np.uint32,
)

IV = np.array(
    [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
     0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19],
    dtype=np.uint32,
)


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x >> n) | ((x << (32 - n)) & MASK)


def sha256_compress(state: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """One compression: state (..., 8), block (..., 16) big-endian words ->
    new state (..., 8), batched over leading axes. Words are int64 tensors
    of values in [0, 2^32); the result is too."""
    w = list(block.long().unbind(-1))
    for t in range(16, 64):
        s0 = _rotr(w[t - 15], 7) ^ _rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = _rotr(w[t - 2], 17) ^ _rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & MASK)
    init = state.long()
    a, b, c, d, e, f, g, h = init.unbind(-1)
    for t in range(64):
        S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ ((e ^ MASK) & g)
        t1 = (h + S1 + ch + int(_K[t]) + w[t]) & MASK
        S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        a, b, c, d, e, f, g, h = (t1 + S0 + maj) & MASK, a, b, c, (d + t1) & MASK, e, f, g
    return (torch.stack([a, b, c, d, e, f, g, h], dim=-1) + init) & MASK


def _padding(length: int) -> bytes:
    """The bytes SHA-256 appends to a message of `length` bytes."""
    pad = b"\x80" + b"\x00" * ((55 - length) % 64)
    return pad + (length * 8).to_bytes(8, "big")


def _bytes_to_blocks(data: bytes) -> np.ndarray:
    """SHA-256 padding for one message -> (nblocks, 16) u32 words."""
    arr = np.frombuffer(data + _padding(len(data)), dtype=">u4").astype(np.uint32)
    return arr.reshape(-1, 16)


def messages_to_blocks(messages: list) -> np.ndarray:
    """A batch of equal-length messages -> (N, nblocks, 16) int64 words of
    their padded blocks (every message takes the same padding, so all are
    padded in one array). Refuses a batch whose messages differ in length
    (one block count per batch), or an empty one."""
    if not messages or any(len(m) != len(messages[0]) for m in messages):
        raise ValueError("sha256: the batch must be non-empty and its messages of equal length")
    n, length = len(messages), len(messages[0])
    pad = np.frombuffer(_padding(length), dtype=np.uint8)
    raw = np.frombuffer(b"".join(messages), dtype=np.uint8).reshape(n, length)
    words = np.ascontiguousarray(np.concatenate([raw, np.broadcast_to(pad, (n, pad.size))], axis=1)).view(">u4")
    return words.astype(np.int64).reshape(n, -1, 16)


def sha256_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """(N, nblocks, 16) int64 words of padded messages -> (N, 8) int64
    digest words, every compression over all N lanes at once."""
    state = torch.from_numpy(IV.astype(np.int64)).to(blocks.device).expand(blocks.shape[0], 8)
    for i in range(blocks.shape[1]):
        state = sha256_compress(state, blocks[:, i, :])
    return state


def sha256_bytes_batch(messages: list, device="cuda") -> list:
    """Digest a batch of equal-length messages on `device`. Returns the
    digests as 32-byte strings (`messages_to_blocks` refuses unequal
    lengths)."""
    out = sha256_blocks(torch.from_numpy(messages_to_blocks(messages)).to(device))
    raw = out.cpu().numpy().astype(">u4").tobytes()
    return [raw[32 * i: 32 * (i + 1)] for i in range(len(messages))]
