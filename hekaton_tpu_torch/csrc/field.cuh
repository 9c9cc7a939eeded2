// BN254 Fq / Fr Montgomery arithmetic for the port's CUDA kernels.
//
// An element is 8 little-endian 32-bit words in Montgomery form with
// R = 2^256: the same value the JAX package keeps as 16 little-endian 16-bit
// limbs (fields/jax_field.py), so a kernel that unpacks the limbs into words
// and packs them back agrees bit for bit with the limb formulas. Every
// function returns canonical values (< p) for canonical inputs.
//
// Tensors at the kernel boundary are int32: either (n, 16) limb rows (one
// 16-bit limb per word) or packed slab rows (two limbs per word, already the
// 32-bit words used here). An Fq2 = Fq[u]/(u^2+1) element is a pair of Fq
// elements (c0, c1), at the boundary an (n, 2, 16) limb row of 32 limbs.
#pragma once

#include <cstdint>

namespace hk {

constexpr int FQ = 0;
constexpr int FR = 1;

// modulus words, -p^-1 mod 2^32 and R mod p (Montgomery one), per field
static __constant__ uint32_t P_WORDS[2][8] = {
    {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
     0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u},
    {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
     0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u},
};
static __constant__ uint32_t NINV[2] = {0xe4866389u, 0xefffffffu};
static __constant__ uint32_t ONE_WORDS[2][8] = {
    {0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,
     0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u},
    {0x4ffffffbu, 0xac96341cu, 0x9f60cd29u, 0x36fc7695u,
     0x7879462eu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u},
};

struct Fe {
  uint32_t w[8];
};

__device__ __forceinline__ Fe fe_zero() {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.w[i] = 0u;
  return r;
}

template <int F>
__device__ __forceinline__ Fe fe_one() {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.w[i] = ONE_WORDS[F][i];
  return r;
}

// (16,) 16-bit limbs -> words, and back
__device__ __forceinline__ Fe load_limbs(const int32_t* src) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; i++)
    r.w[i] = (uint32_t)src[2 * i] | ((uint32_t)src[2 * i + 1] << 16);
  return r;
}

__device__ __forceinline__ void store_limbs(int32_t* dst, const Fe& a) {
#pragma unroll
  for (int i = 0; i < 8; i++) {
    dst[2 * i] = (int32_t)(a.w[i] & 0xffffu);
    dst[2 * i + 1] = (int32_t)(a.w[i] >> 16);
  }
}

// (8,) packed words (two limbs per word) -> words, and back
__device__ __forceinline__ Fe load_words(const int32_t* src) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.w[i] = (uint32_t)src[i];
  return r;
}

__device__ __forceinline__ void store_words(int32_t* dst, const Fe& a) {
#pragma unroll
  for (int i = 0; i < 8; i++) dst[i] = (int32_t)a.w[i];
}

__device__ __forceinline__ bool fe_is_zero(const Fe& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) acc |= a.w[i];
  return acc == 0u;
}

__device__ __forceinline__ Fe fe_select(bool c, const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.w[i] = c ? a.w[i] : b.w[i];
  return r;
}

// t (< 2p, with `top` the bit above word 7) minus p when t >= p
template <int F>
__device__ __forceinline__ Fe reduce_once(const uint32_t t[8], uint32_t top) {
  Fe d;
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t s = (uint64_t)t[i] - (uint64_t)P_WORDS[F][i] - borrow;
    d.w[i] = (uint32_t)s;
    borrow = s >> 63;
  }
  bool ge = top != 0u || borrow == 0;
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.w[i] = ge ? d.w[i] : t[i];
  return r;
}

template <int F>
__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b) {
  uint32_t t[8];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t s = (uint64_t)a.w[i] + b.w[i] + c;
    t[i] = (uint32_t)s;
    c = s >> 32;
  }
  return reduce_once<F>(t, (uint32_t)c);
}

template <int F>
__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b) {
  Fe d;
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t s = (uint64_t)a.w[i] - (uint64_t)b.w[i] - borrow;
    d.w[i] = (uint32_t)s;
    borrow = s >> 63;
  }
  if (borrow) {
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
      uint64_t s = (uint64_t)d.w[i] + P_WORDS[F][i] + c;
      d.w[i] = (uint32_t)s;
      c = s >> 32;
    }
  }
  return d;
}

// CIOS Montgomery product a*b*R^-1 mod p over 32-bit words; the running
// sum t stays below 2p, so one conditional subtraction ends it
template <int F>
__device__ __forceinline__ Fe fe_mul(const Fe& a, const Fe& b) {
  uint32_t t[10];
#pragma unroll
  for (int j = 0; j < 10; j++) t[j] = 0u;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      uint64_t s = (uint64_t)a.w[i] * b.w[j] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[8] + c;
    t[8] = (uint32_t)s;
    t[9] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * NINV[F];
    s = (uint64_t)m * P_WORDS[F][0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < 8; j++) {
      s = (uint64_t)m * P_WORDS[F][j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[8] + c;
    t[7] = (uint32_t)s;
    t[8] = t[9] + (uint32_t)(s >> 32);
  }
  return reduce_once<F>(t, t[8]);
}

template <int F>
__device__ __forceinline__ Fe fe_sqr(const Fe& a) {
  return fe_mul<F>(a, a);
}

// a^(p-2) by left-to-right square-and-multiply; inv(0) = 0
template <int F>
__device__ __forceinline__ Fe fe_inv(const Fe& a) {
  Fe acc = a;
  // p - 2 has bit 253 as its top bit for both BN254 moduli
  for (int bit = 252; bit >= 0; bit--) {
    acc = fe_sqr<F>(acc);
    uint32_t w = P_WORDS[F][bit >> 5] - ((bit >> 5) == 0 ? 2u : 0u);
    if ((w >> (bit & 31)) & 1u) acc = fe_mul<F>(acc, a);
  }
  return acc;
}

// -- Fq2 = Fq[u]/(u^2+1) (pallas_curve.py::f2_add/f2_sub/f2_mul, :982-1005) --

struct Fe2 {
  Fe c0, c1;
};

// 3b' = 9/(9+u), the RCB mul-by-3b constant of the BN254 G2 twist
// b' = 3/(9+u), in Montgomery form (pallas_curve.py::_b3_g2_limbs, :1008)
static __constant__ uint32_t B3_G2_WORDS[2][8] = {
    {0xb62e0d6au, 0x3baa927cu, 0xd1b664fdu, 0xd71e7c52u,
     0xd95d4664u, 0x03873e63u, 0x082ab8f4u, 0x0e75b5b1u},
    {0x7596fe35u, 0xaab7c666u, 0xbb6a27bau, 0x31d21a78u,
     0x680401ffu, 0x85dd7297u, 0xdf39a7e9u, 0x03c52d6au},
};

__device__ __forceinline__ Fe2 f2_b3() {
  Fe2 r;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    r.c0.w[i] = B3_G2_WORDS[0][i];
    r.c1.w[i] = B3_G2_WORDS[1][i];
  }
  return r;
}

__device__ __forceinline__ Fe2 f2_add(const Fe2& a, const Fe2& b) {
  return Fe2{fe_add<FQ>(a.c0, b.c0), fe_add<FQ>(a.c1, b.c1)};
}

__device__ __forceinline__ Fe2 f2_sub(const Fe2& a, const Fe2& b) {
  return Fe2{fe_sub<FQ>(a.c0, b.c0), fe_sub<FQ>(a.c1, b.c1)};
}

// Karatsuba: 3 Fq products (jax_field.py::fq2_mul)
__device__ __forceinline__ Fe2 f2_mul(const Fe2& a, const Fe2& b) {
  Fe t0 = fe_mul<FQ>(a.c0, b.c0);
  Fe t1 = fe_mul<FQ>(a.c1, b.c1);
  Fe s = fe_mul<FQ>(fe_add<FQ>(a.c0, a.c1), fe_add<FQ>(b.c0, b.c1));
  return Fe2{fe_sub<FQ>(t0, t1), fe_sub<FQ>(fe_sub<FQ>(s, t0), t1)};
}

// (a0 + a1 u)^2 = (a0 + a1)(a0 - a1) + 2 a0 a1 u: 2 Fq products; the same
// canonical values as f2_mul(a, a)
__device__ __forceinline__ Fe2 f2_sqr(const Fe2& a) {
  Fe m = fe_mul<FQ>(a.c0, a.c1);
  return Fe2{fe_mul<FQ>(fe_add<FQ>(a.c0, a.c1), fe_sub<FQ>(a.c0, a.c1)), fe_add<FQ>(m, m)};
}

__device__ __forceinline__ bool f2_is_zero(const Fe2& a) { return fe_is_zero(a.c0) && fe_is_zero(a.c1); }

__device__ __forceinline__ Fe2 f2_select(bool c, const Fe2& a, const Fe2& b) {
  return Fe2{fe_select(c, a.c0, b.c0), fe_select(c, a.c1, b.c1)};
}

// (2, 16) limb row (c0 limbs then c1 limbs) -> Fq2, and back
__device__ __forceinline__ Fe2 load_limbs2(const int32_t* src) {
  return Fe2{load_limbs(src), load_limbs(src + 16)};
}

__device__ __forceinline__ void store_limbs2(int32_t* dst, const Fe2& a) {
  store_limbs(dst, a.c0);
  store_limbs(dst + 16, a.c1);
}

}  // namespace hk
