"""Poseidon hash over BN254-Fr: parameter generation, native sponge, gadget.

Mirrors the reference's Poseidon configuration
(distributed-prover/src/poseidon_util.rs:53-107): leaf hash =
rate 3 / alpha 5 / 8 full / 56 partial rounds; two-to-one hash = rate 2 /
alpha 17 / 8 full / 31 partial rounds; capacity 1. Round constants and the
Cauchy MDS matrix come from the Grain-LFSR procedure of the Poseidon reference
implementation (the same procedure ark-crypto-primitives'
find_poseidon_ark_and_mds implements).
"""
from __future__ import annotations

import functools

from ..fields.bn254 import R
from ..fields.host import fr_inv
from ..r1cs.gadgets import FpVar

PRIME_BITS = 254  # Fr::MODULUS_BIT_SIZE


class _GrainLFSR:
    """80-bit Grain LFSR from the Poseidon reference parameter script."""

    def __init__(self, prime_bits: int, state_len: int, full_rounds: int, partial_rounds: int):
        bits = []
        bits += [0, 1]  # field type: prime
        bits += [0, 0, 0, 0]  # sbox: x^alpha
        bits += [(prime_bits >> (11 - i)) & 1 for i in range(12)]
        bits += [(state_len >> (11 - i)) & 1 for i in range(12)]
        bits += [(full_rounds >> (9 - i)) & 1 for i in range(10)]
        bits += [(partial_rounds >> (9 - i)) & 1 for i in range(10)]
        bits += [1] * 30
        assert len(bits) == 80
        self.state = bits
        for _ in range(160):
            self._update()

    def _update(self) -> int:
        s = self.state
        new = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        self.state = s[1:] + [new]
        return new

    def _next_filtered_bit(self) -> int:
        # evaluate bits in pairs: first bit 1 -> emit second; else discard
        while True:
            b1 = self._update()
            b2 = self._update()
            if b1:
                return b2

    def get_bits(self, n: int) -> list:
        return [self._next_filtered_bit() for _ in range(n)]

    def field_elements_rejection(self, num: int, prime_bits: int = PRIME_BITS) -> list:
        out = []
        while len(out) < num:
            bits = self.get_bits(prime_bits)  # MSB first
            v = 0
            for b in bits:
                v = (v << 1) | b
            if v < R:
                out.append(v)
        return out

    def field_elements_mod_p(self, num: int, prime_bits: int = PRIME_BITS) -> list:
        out = []
        for _ in range(num):
            bits = self.get_bits(prime_bits)
            v = 0
            for b in bits:
                v = (v << 1) | b
            out.append(v % R)
        return out


class PoseidonConfig:
    def __init__(self, rate: int, alpha: int, full_rounds: int, partial_rounds: int):
        self.rate = rate
        self.alpha = alpha
        self.full_rounds = full_rounds
        self.partial_rounds = partial_rounds
        self.capacity = 1
        width = rate + 1
        lfsr = _GrainLFSR(PRIME_BITS, width, full_rounds, partial_rounds)
        self.ark = [
            lfsr.field_elements_rejection(width) for _ in range(full_rounds + partial_rounds)
        ]
        xs = lfsr.field_elements_mod_p(width)
        ys = lfsr.field_elements_mod_p(width)
        self.mds = [[fr_inv((x + y) % R) for y in ys] for x in xs]


# The two configurations used throughout the pipeline (poseidon_util.rs:102-107)
@functools.lru_cache(maxsize=None)
def leaf_config() -> PoseidonConfig:
    return PoseidonConfig(rate=3, alpha=5, full_rounds=8, partial_rounds=56)


@functools.lru_cache(maxsize=None)
def two_to_one_config() -> PoseidonConfig:
    return PoseidonConfig(rate=2, alpha=17, full_rounds=8, partial_rounds=31)


# ---------------------------------------------------------------------------
# Native sponge (host ints)
# ---------------------------------------------------------------------------


def _permute(cfg: PoseidonConfig, state: list) -> list:
    width = cfg.rate + 1
    half = cfg.full_rounds // 2
    total = cfg.full_rounds + cfg.partial_rounds
    for rnd in range(total):
        state = [(s + a) % R for s, a in zip(state, cfg.ark[rnd])]
        if rnd < half or rnd >= half + cfg.partial_rounds:
            state = [pow(s, cfg.alpha, R) for s in state]
        else:
            state[0] = pow(state[0], cfg.alpha, R)
        state = [sum(cfg.mds[i][j] * state[j] for j in range(width)) % R for i in range(width)]
    return state


def sponge_hash(cfg: PoseidonConfig, inputs: list) -> int:
    """Absorb `inputs` then squeeze one element (arkworks CRH semantics:
    elements added into state[capacity + i], permuting on full rate)."""
    width = cfg.rate + 1
    state = [0] * width
    idx = 0
    for elem in inputs:
        if idx == cfg.rate:
            state = _permute(cfg, state)
            idx = 0
        state[cfg.capacity + idx] = (state[cfg.capacity + idx] + elem) % R
        idx += 1
    state = _permute(cfg, state)
    return state[cfg.capacity]


def hash_leaf(elems: list) -> int:
    return sponge_hash(leaf_config(), elems)


def hash_two_to_one(left: int, right: int) -> int:
    return sponge_hash(two_to_one_config(), [left, right])


# ---------------------------------------------------------------------------
# In-circuit sponge (gadget)
# ---------------------------------------------------------------------------


def _pow_alpha_var(x: FpVar, alpha: int) -> FpVar:
    # alpha in {5, 17}: square chain + final multiply
    acc = x
    n = 1
    while n * 2 <= alpha - 1:
        acc = acc.square()
        n *= 2
    # n is now the largest power of two <= alpha-1; alpha-1 is a power of two
    assert n == alpha - 1, "alpha must be 2^k + 1"
    return acc * x


def _permute_var(cfg: PoseidonConfig, state: list) -> list:
    width = cfg.rate + 1
    half = cfg.full_rounds // 2
    total = cfg.full_rounds + cfg.partial_rounds
    for rnd in range(total):
        state = [s + a for s, a in zip(state, cfg.ark[rnd])]
        if rnd < half or rnd >= half + cfg.partial_rounds:
            state = [_pow_alpha_var(s, cfg.alpha) for s in state]
        else:
            state[0] = _pow_alpha_var(state[0], cfg.alpha)
        new_state = []
        for i in range(width):
            acc = state[0].scale(cfg.mds[i][0])
            for j in range(1, width):
                acc = acc + state[j].scale(cfg.mds[i][j])
            new_state.append(acc)
        state = new_state
    return state


def sponge_hash_var(cfg: PoseidonConfig, inputs: list) -> FpVar:
    cs = inputs[0].cs
    width = cfg.rate + 1
    state = [FpVar.constant(cs, 0) for _ in range(width)]
    idx = 0
    for elem in inputs:
        if idx == cfg.rate:
            state = _permute_var(cfg, state)
            idx = 0
        state[cfg.capacity + idx] = state[cfg.capacity + idx] + elem
        idx += 1
    state = _permute_var(cfg, state)
    return state[cfg.capacity]


def hash_leaf_var(elems: list) -> FpVar:
    return sponge_hash_var(leaf_config(), elems)


def hash_two_to_one_var(left: FpVar, right: FpVar) -> FpVar:
    return sponge_hash_var(two_to_one_config(), [left, right])
