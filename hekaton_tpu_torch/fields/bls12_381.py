"""BLS12-381 curve and field constants (public-domain parameters).

The reference lists ark-bls12-381 as a dependency but never uses it in the
pipeline (SURVEY.md §6); the north star asks for the field/curve kernels to
support it. The base field needs 24 16-bit limbs (381 bits); the scalar
field fits the standard 16-limb packing (255 bits). Fr is highly 2-adic
(2^32 | r-1), so NTT domains reach 2^32.
"""

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

NLIMBS_FQ = 24  # 384 bits
NLIMBS_FR = 16  # 256 bits

# x parameter: p = (x-1)^2 (x^4 - x^2 + 1)/3 + x, r = x^4 - x^2 + 1
BLS_X = -0xD201000000010000
assert R == BLS_X**4 - BLS_X**2 + 1

# G1: y^2 = x^3 + 4
B_G1 = 4
G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)

# Fr NTT support: r - 1 = 2^32 * odd
TWO_ADICITY = 32
assert (R - 1) % (1 << TWO_ADICITY) == 0 and ((R - 1) >> TWO_ADICITY) % 2 == 1
FR_TWO_ADIC_ROOT = pow(7, (R - 1) >> TWO_ADICITY, R)
assert pow(FR_TWO_ADIC_ROOT, 1 << (TWO_ADICITY - 1), R) != 1
assert pow(FR_TWO_ADIC_ROOT, 1 << TWO_ADICITY, R) == 1

assert (G1_GEN[1] ** 2 - G1_GEN[0] ** 3 - B_G1) % P == 0
