"""The least work of an MSM on given scalars, and its least time on one H100.

Frozen with the benchmark, so the roofline reads the same work whatever
route, window or kernel the program takes:

- additions: the fewest that a windowed bucket method needs for these
  scalars, minimised over the window width c: the nonzero signed digits of
  every scalar (each is one point added to a bucket), plus ceil(b/c) 2^(c-1)
  for the window sums, b the bit length of the largest scalar;
- each addition at the configuration's `muls_per_add` 32-bit multiplies
  (the cheapest addition any route of the program uses on that curve);
- bytes: each point and each scalar read once.

The least time is max(bytes / HBM_BYTES_PER_S, multiplies / MULS_PER_S).
"""
from __future__ import annotations

import math

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA's data sheet
# 32-bit integer multiplies a second: 64 an SM a clock (compute capability
# 9.0's IMAD issue, derived, not a data-sheet figure) x 132 SMs x 1,980 MHz,
# a fixed clock so that a throttled card cannot move the yardstick
MULS_PER_S = 64 * 132 * 1.980e9
MAX_WINDOW = 24


def bit_length(scalars: torch.Tensor) -> int:
    """The bit length of the largest of (n, 16) plain limbs."""
    s = scalars.long() & 0xFFFF
    nz = (s != 0).any(dim=0).nonzero()
    if nz.numel() == 0:
        return 0
    top = int(nz.max())
    return 16 * top + int(s[:, top].max()).bit_length()


def _window(s: torch.Tensor, bit: int, c: int) -> torch.Tensor:
    """Bits [bit, bit + c) of every scalar (c <= 24 spans at most 3 limbs)."""
    limb, sh = bit // 16, bit % 16
    val = torch.zeros_like(s[:, 0])
    for k in range(3):
        if limb + k < 16:
            val |= s[:, limb + k] << (16 * k)
    return (val >> sh) & ((1 << c) - 1)


def signed_digits_nonzero(scalars: torch.Tensor, c: int, b: int) -> int:
    """Nonzero signed base-2^c digits (each in (-2^(c-1), 2^(c-1)]) over
    all scalars of b bits or fewer, the final carry included."""
    s = scalars.long() & 0xFFFF
    carry = torch.zeros_like(s[:, 0])
    count = 0
    for w in range(math.ceil(b / c)):
        d = _window(s, w * c, c) + carry
        carry = (d > (1 << (c - 1))).long()
        count += int(((d & ((1 << c) - 1)) != 0).sum())
    return count + int(carry.sum())


def least_additions(scalars: torch.Tensor) -> int:
    b = bit_length(scalars)
    if b == 0:
        return 0
    best = None
    for c in range(1, MAX_WINDOW + 1):
        buckets = math.ceil(b / c) << (c - 1)
        if best is not None and buckets >= best:
            break  # the bucket term only grows with c
        total = signed_digits_nonzero(scalars, c, b) + buckets
        best = total if best is None else min(best, total)
    return best


def least_seconds(scalars: torch.Tensor, muls_per_add: int, point_bytes: int, scalar_bytes: int) -> float:
    n = scalars.shape[0]
    muls = least_additions(scalars) * muls_per_add
    return max(n * (point_bytes + scalar_bytes) / HBM_BYTES_PER_S, muls / MULS_PER_S)
