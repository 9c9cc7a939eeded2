"""BN254 (alt_bn128) curve and field constants.

The reference pipeline runs entirely over BN254 (`Bn254`, `Fr`) — see
mpi-snark/src/bin/node.rs:12 and
mpi-snark/src/data_structures.rs:9. BLS12-381 is a dependency
there but unused, so we standardize on BN254.

All constants here are public-domain curve parameters (EIP-196/197).
"""

# Base field modulus p and scalar field modulus r.
P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# BN parameter x: p = 36x^4 + 36x^3 + 24x^2 + 6x + 1, r = 36x^4 + 36x^3 + 18x^2 + 6x + 1
BN_X = 4965661367192848881
ATE_LOOP_COUNT = 6 * BN_X + 2  # 29793968203157093288

assert P == 36 * BN_X**4 + 36 * BN_X**3 + 24 * BN_X**2 + 6 * BN_X + 1
assert R == 36 * BN_X**4 + 36 * BN_X**3 + 18 * BN_X**2 + 6 * BN_X + 1

# G1: y^2 = x^3 + 3 over Fq
B_G1 = 3
G1_GEN = (1, 2)

# G2: y^2 = x^3 + 3/(9+u) over Fq2 (u^2 = -1); generator from EIP-197.
G2_GEN_X = (
    10857046999023057135944570762232829481370756359578518086990519993285655852781,
    11559732032986387107991004021392285783925812861821192530917403151452391805634,
)
G2_GEN_Y = (
    8495653923123431417604973247489272438418190587263600148770280649306958101930,
    4082367875863433681332203403145435568316851327593401208105741076214120093531,
)

# Fr NTT support: r - 1 = 2^28 * odd
TWO_ADICITY = 28
assert (R - 1) % (1 << TWO_ADICITY) == 0 and ((R - 1) >> TWO_ADICITY) % 2 == 1
# A 2^28-th root of unity in Fr (element of exact order 2^28; verified below).
FR_TWO_ADIC_ROOT = pow(5, (R - 1) >> TWO_ADICITY, R)
assert pow(FR_TWO_ADIC_ROOT, 1 << (TWO_ADICITY - 1), R) != 1
assert pow(FR_TWO_ADIC_ROOT, 1 << TWO_ADICITY, R) == 1

# Limb representation used by the TPU kernels: 16 limbs x 16 bits, little-endian.
NLIMBS = 16
LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1
MONT_R = 1 << (NLIMBS * LIMB_BITS)  # Montgomery radix 2^256


def to_limbs(x: int, n: int = NLIMBS) -> list:
    """Split an integer into n little-endian 16-bit limbs."""
    return [(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(n)]


def from_limbs(limbs) -> int:
    acc = 0
    for i, l in enumerate(limbs):
        acc |= int(l) << (LIMB_BITS * i)
    return acc


def mont_constants(modulus: int):
    """(R mod m, R^2 mod m, -m^{-1} mod R) for the 2^256 Montgomery radix."""
    r_mod = MONT_R % modulus
    r2_mod = (MONT_R * MONT_R) % modulus
    ninv = (-pow(modulus, -1, MONT_R)) % MONT_R
    return r_mod, r2_mod, ninv
