"""The one scalar generator: it reads a traffic file and draws MSM scalars.

A traffic file (hkbench/traffic/<mix>.json) lists classes of values, each
with its share of the entries and its range [low, high): `high` is an
integer below 2^63, or "field" for a draw below r. Every entry of a scalar
vector picks its class independently by the shares, then its value
uniformly in the class's range. A "field" draw takes 15 uniform 16-bit limbs
and a top limb below r's (0x3064), so it is uniform below 0x3064 * 2^240,
99.9975% of r; its `low` is not enforced (a draw below 2^64 has probability
2^-190).

Scalars are (n, 16) int32 plain limbs, least significant first, the layout
msm_gpu takes. Each call's scalars come from a torch.Generator on the device
seeded by `derive_seed(seed, tag, call)`, so a call's scalars can be drawn
again after the window, for the check, on the same device.
"""
from __future__ import annotations

import hashlib
import json

import torch

FIELD_TOP = 0x3064  # the top 16-bit limb of BN254's r


def load(path: str) -> dict:
    with open(path) as f:
        mix = json.load(f)
    total = 0.0
    for cls in mix["classes"]:
        if cls["high"] != "field" and not 0 <= int(cls["low"]) < int(cls["high"]) <= 1 << 63:
            raise ValueError(f"{path}: class {cls['name']} has no range below 2^63")
        total += float(cls["share"])
    if abs(total - 1.0) > 1e-9:
        raise ValueError(f"{path}: shares add up to {total}, not 1")
    return mix


def derive_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one purpose of one run."""
    text = ":".join(str(t) for t in (seed,) + tags).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _draw_class(cls: dict, n: int, gen: torch.Generator, device) -> torch.Tensor:
    if cls["high"] == "field":
        low = torch.randint(0, 1 << 16, (n, 15), generator=gen, device=device, dtype=torch.int64)
        top = torch.randint(0, FIELD_TOP, (n, 1), generator=gen, device=device, dtype=torch.int64)
        return torch.cat([low, top], dim=1)
    v = torch.randint(int(cls["low"]), int(cls["high"]), (n,), generator=gen, device=device, dtype=torch.int64)
    out = torch.zeros((n, 16), dtype=torch.int64, device=device)
    for k in range(4):
        out[:, k] = (v >> (16 * k)) & 0xFFFF
    return out


def draw(mix: dict, n: int, gen: torch.Generator, device) -> torch.Tensor:
    """n scalars of the mix as (n, 16) int32 plain limbs on `device`. Every
    class is drawn for all n entries, so the work does not depend on the
    shares."""
    shares = torch.tensor([float(c["share"]) for c in mix["classes"]], dtype=torch.float64)
    bounds = torch.cumsum(shares, 0)[:-1].to(device)
    pick = torch.searchsorted(bounds, torch.rand(n, generator=gen, device=device, dtype=torch.float64), right=True)
    out = torch.zeros((n, 16), dtype=torch.int64, device=device)
    for k, cls in enumerate(mix["classes"]):
        out = torch.where((pick == k)[:, None], _draw_class(cls, n, gen, device), out)
    return out.to(torch.int32)
