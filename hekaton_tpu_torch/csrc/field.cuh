// Montgomery arithmetic over BN254 Fq / Fr and BLS12-381 Fq for the port's
// CUDA kernels.
//
// An element is NW little-endian 32-bit words in Montgomery form with R =
// 2^(32 NW): 8 words (R = 2^256) on the BN254 fields, 12 (R = 2^384) on
// BLS12-381 Fq. That is the value the JAX package keeps as 2 NW little-endian
// 16-bit limbs (16, or 24 on BLS12-381; fields/jax_field.py), so a kernel
// that unpacks the limbs into words and packs them back agrees bit for bit
// with the limb formulas. Every function returns canonical values (< p) for
// canonical inputs. `Field<F>` holds a field's word count and constants;
// `Fe` is the 8-word element of the BN254 kernels. Every kernel's
// arithmetic runs on one set of PTX carry chains (`ptx::`, `mac_row`):
// additions and subtractions, the Montgomery product `fe_mul` (the whole
// product, then its reduction) and the square `fe_sqr` (each cross product
// once, doubled), at 8 and at 12 words.
//
// Tensors at the kernel boundary are int32: either (n, 2 NW) limb rows (one
// 16-bit limb per word) or packed slab rows (two limbs per word, already the
// 32-bit words used here). An Fq2 = Fq[u]/(u^2+1) element is a pair of BN254
// Fq elements (c0, c1), at the boundary an (n, 2, 16) limb row of 32 limbs.
#pragma once

#include <cstddef>
#include <cstdint>

namespace hk {

constexpr int FQ = 0;      // BN254 base field
constexpr int FR = 1;      // BN254 scalar field
constexpr int FQ_BLS = 2;  // BLS12-381 base field

// BN254: modulus words, -p^-1 mod 2^32 and R mod p (Montgomery one), per field
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

// per-field traits: word count and constants (BLS12-381's specialization is
// at the end of this header)
template <int F>
struct Field {  // BN254 Fq (F = FQ) and Fr (F = FR)
  static constexpr int NW = 8;
  __device__ __forceinline__ static uint32_t p(int i) { return P_WORDS[F][i]; }
  __device__ __forceinline__ static uint32_t ninv() { return NINV[F]; }
  __device__ __forceinline__ static uint32_t one(int i) { return ONE_WORDS[F][i]; }
};

template <int NW>
struct FeN {
  uint32_t w[NW];
};

using Fe = FeN<8>;  // a BN254 element

template <int F>
using FeF = FeN<Field<F>::NW>;

__device__ __forceinline__ Fe fe_zero() {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.w[i] = 0u;
  return r;
}

template <int F>
__device__ __forceinline__ FeF<F> fe_one() {
  FeF<F> r;
#pragma unroll
  for (int i = 0; i < Field<F>::NW; i++) r.w[i] = Field<F>::one(i);
  return r;
}

// (2 NW,) 16-bit limbs -> NW words, and back
template <int NW = 8>
__device__ __forceinline__ FeN<NW> load_limbs(const int32_t* src) {
  FeN<NW> r;
#pragma unroll
  for (int i = 0; i < NW; i++)
    r.w[i] = (uint32_t)src[2 * i] | ((uint32_t)src[2 * i + 1] << 16);
  return r;
}

template <int NW>
__device__ __forceinline__ void store_limbs(int32_t* dst, const FeN<NW>& a) {
#pragma unroll
  for (int i = 0; i < NW; i++) {
    dst[2 * i] = (int32_t)(a.w[i] & 0xffffu);
    dst[2 * i + 1] = (int32_t)(a.w[i] >> 16);
  }
}

// the same by 16-byte loads and stores (NW/2 of them), for rows that start
// on 16-byte boundaries
template <int NW = 8>
__device__ __forceinline__ FeN<NW> load_limbs16(const int32_t* src) {
  const int4* s4 = reinterpret_cast<const int4*>(src);
  FeN<NW> r;
#pragma unroll
  for (int q = 0; q < NW / 2; q++) {
    int4 v = s4[q];
    r.w[2 * q] = (uint32_t)v.x | ((uint32_t)v.y << 16);
    r.w[2 * q + 1] = (uint32_t)v.z | ((uint32_t)v.w << 16);
  }
  return r;
}

template <int NW>
__device__ __forceinline__ void store_limbs16(int32_t* dst, const FeN<NW>& a) {
  int4* d4 = reinterpret_cast<int4*>(dst);
#pragma unroll
  for (int q = 0; q < NW / 2; q++)
    d4[q] = make_int4((int)(a.w[2 * q] & 0xffffu), (int)(a.w[2 * q] >> 16), (int)(a.w[2 * q + 1] & 0xffffu),
                      (int)(a.w[2 * q + 1] >> 16));
}

template <int NW>
__device__ __forceinline__ bool fe_is_zero(const FeN<NW>& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < NW; i++) acc |= a.w[i];
  return acc == 0u;
}

template <int NW>
__device__ __forceinline__ FeN<NW> fe_select(bool c, const FeN<NW>& a, const FeN<NW>& b) {
  FeN<NW> r;
#pragma unroll
  for (int i = 0; i < NW; i++) r.w[i] = c ? a.w[i] : b.w[i];
  return r;
}

// -- PTX carry chains --
//
// One PTX instruction each. `volatile` keeps them in program order, so a
// chain of them (an instruction that sets the carry flag, then ones that
// read and set it) hands the flag from one to the next: the code the
// compiler places between two of them (moves, loads, address arithmetic)
// never writes it. ptxas turns a mad.lo.cc / madc.hi.cc pair on one
// product into IMAD.WIDE.U32.X-style instructions with the carry in a
// predicate; 64-bit C carries (s = a b + t + c) cost an IMAD.WIDE, an IADD3
// and an IMAD.X or IADD3.X a word product.
namespace ptx {

__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// low / high half of a b, plus c (and the carry), setting the carry
__device__ __forceinline__ uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

__device__ __forceinline__ uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

__device__ __forceinline__ uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

}  // namespace ptx

// T[0..N] += s v + e_in 2^(32 N) for v of N words, in two carry chains: the
// products of v's even words (low halves at words 0, 2, .., high halves at
// 1, 3, ..), then those of its odd words one word up; e_in goes in at word
// N on whichever chain ends below it. Returns the carries owed to word N+1
// (at most 2), which the caller's next row takes as its e_in.
template <int N>
__device__ __forceinline__ uint32_t mac_row(uint32_t* T, const uint32_t* v, uint32_t s, uint32_t e_in) {
  T[0] = ptx::mad_lo_cc(v[0], s, T[0]);
  T[1] = ptx::madc_hi_cc(v[0], s, T[1]);
#pragma unroll
  for (int j = 2; j < N; j += 2) {
    T[j] = ptx::madc_lo_cc(v[j], s, T[j]);
    T[j + 1] = ptx::madc_hi_cc(v[j], s, T[j + 1]);
  }
  if constexpr (N % 2 == 0) T[N] = ptx::addc_cc(T[N], e_in);  // the even chain ended at word N-1
  const uint32_t e1 = ptx::addc(0u, 0u);
  if constexpr (N == 1) {
    T[1] = ptx::add_cc(T[1], e_in);
  } else {
    T[1] = ptx::mad_lo_cc(v[1], s, T[1]);
    T[2] = ptx::madc_hi_cc(v[1], s, T[2]);
#pragma unroll
    for (int j = 3; j < N; j += 2) {
      T[j] = ptx::madc_lo_cc(v[j], s, T[j]);
      T[j + 1] = ptx::madc_hi_cc(v[j], s, T[j + 1]);
    }
    if constexpr (N % 2 == 1) T[N] = ptx::addc_cc(T[N], e_in);  // the odd chain ended at word N-1
  }
  return ptx::addc(e1, 0u);
}

// T (2 NW words) += a b (the sum must stay below 2^(64 NW)): row I adds
// a_I b at word I, its carries going on to the next row
template <int NW, int I = 0>
__device__ __forceinline__ void mac_wide(uint32_t* T, const FeN<NW>& a, const FeN<NW>& b, uint32_t e = 0u) {
  if constexpr (I < NW) mac_wide<NW, I + 1>(T, a, b, mac_row<NW>(T + I, b.w, a.w[I], e));
}

// t (< 2p, with `top` the bit above word NW-1) minus p when t >= p: one
// borrow chain over the words and `top`, which ends at 2^32 - 1 exactly
// when t < p
template <int F>
__device__ __forceinline__ FeF<F> reduce_once(const uint32_t* t, uint32_t top) {
  constexpr int NW = Field<F>::NW;
  FeF<F> d;
  d.w[0] = ptx::sub_cc(t[0], Field<F>::p(0));
#pragma unroll
  for (int i = 1; i < NW; i++) d.w[i] = ptx::subc_cc(t[i], Field<F>::p(i));
  const bool ge = ptx::subc(top, 0u) != 0xffffffffu;
  FeF<F> r;
#pragma unroll
  for (int i = 0; i < NW; i++) r.w[i] = ge ? d.w[i] : t[i];
  return r;
}

// T R^-1 mod p for T (2 NW words) < p R: row I adds m p at word I, m = T_I
// (-p^-1) mod 2^32, which clears word I; the result, words NW..2NW-1 and
// the carry above them, is below 2p, and one conditional subtraction ends
// it (separated operand scanning: the product first, then the reduction)
template <int F>
__device__ __forceinline__ FeF<F> redc_wide(uint32_t* T) {
  constexpr int NW = Field<F>::NW;
  uint32_t p[NW];
#pragma unroll
  for (int i = 0; i < NW; i++) p[i] = Field<F>::p(i);
  uint32_t e = 0u;
#pragma unroll
  for (int i = 0; i < NW; i++) e = mac_row<NW>(T + i, p, T[i] * Field<F>::ninv(), e);
  return reduce_once<F>(T + NW, e);
}

template <int F>
__device__ __forceinline__ FeF<F> fe_add(const FeF<F>& a, const FeF<F>& b) {
  constexpr int NW = Field<F>::NW;
  uint32_t t[NW];
  t[0] = ptx::add_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int i = 1; i < NW; i++) t[i] = ptx::addc_cc(a.w[i], b.w[i]);
  return reduce_once<F>(t, ptx::addc(0u, 0u));
}

// a - b, plus p where that borrows (the borrow chain's end as a mask)
template <int F>
__device__ __forceinline__ FeF<F> fe_sub(const FeF<F>& a, const FeF<F>& b) {
  constexpr int NW = Field<F>::NW;
  FeF<F> d;
  d.w[0] = ptx::sub_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int i = 1; i < NW; i++) d.w[i] = ptx::subc_cc(a.w[i], b.w[i]);
  const uint32_t mask = ptx::subc(0u, 0u);  // 2^32 - 1 on a borrow, else 0
  d.w[0] = ptx::add_cc(d.w[0], Field<F>::p(0) & mask);
#pragma unroll
  for (int i = 1; i < NW; i++) d.w[i] = ptx::addc_cc(d.w[i], Field<F>::p(i) & mask);
  return d;
}

// Montgomery product a b R^-1 mod p: the 2 NW-word product on carry
// chains (mac_wide), then its reduction (redc_wide); canonical for
// canonical inputs
template <int F>
__device__ __forceinline__ FeF<F> fe_mul(const FeF<F>& a, const FeF<F>& b) {
  uint32_t T[2 * Field<F>::NW] = {0u};
  mac_wide(T, a, b);
  return redc_wide<F>(T);
}

// rows I < NW-1 of a square's off-diagonal half: a_I times words I+1.. of
// a, at word 2I+1
template <int NW, int I = 0>
__device__ __forceinline__ uint32_t sqr_rows(uint32_t* T, const FeN<NW>& a, uint32_t e = 0u) {
  if constexpr (I < NW - 1) {
    return sqr_rows<NW, I + 1>(T, a, mac_row<NW - 1 - I>(T + 2 * I + 1, a.w + I + 1, a.w[I], e));
  } else {
    return e;
  }
}

// a^2 R^-1 mod p: the products a_i a_j (i < j) once (NW (NW-1) / 2 word
// products), doubled by one carry chain, the squares a_i^2 added by
// another, then the same reduction as fe_mul; the same canonical value as
// fe_mul(a, a)
template <int F>
__device__ __forceinline__ FeF<F> fe_sqr(const FeF<F>& a) {
  constexpr int NW = Field<F>::NW;
  uint32_t T[2 * NW] = {0u};
  T[2 * NW - 1] = sqr_rows(T, a);  // the last row (I = NW-2) ends at word 2NW-2
  T[1] = ptx::add_cc(T[1], T[1]);  // word 0 of the half is 0
#pragma unroll
  for (int k = 2; k < 2 * NW - 1; k++) T[k] = ptx::addc_cc(T[k], T[k]);
  T[2 * NW - 1] = ptx::addc(T[2 * NW - 1], T[2 * NW - 1]);  // the half < 2^(64 NW - 1): no carry out
  T[0] = ptx::mad_lo_cc(a.w[0], a.w[0], T[0]);
  T[1] = ptx::madc_hi_cc(a.w[0], a.w[0], T[1]);
#pragma unroll
  for (int i = 1; i < NW; i++) {
    T[2 * i] = ptx::madc_lo_cc(a.w[i], a.w[i], T[2 * i]);
    T[2 * i + 1] = ptx::madc_hi_cc(a.w[i], a.w[i], T[2 * i + 1]);
  }
  return redc_wide<F>(T);
}

// -- Fq2 = Fq[u]/(u^2+1): the twist constant of the G2 kernels (curve_g2.cu
// makes an Fq2 value's two components on two threads, from Fq words) --

// 3b' = 9/(9+u), the RCB mul-by-3b constant of the BN254 G2 twist
// b' = 3/(9+u), in Montgomery form (pallas_curve.py::_b3_g2_limbs, :1008)
static __constant__ uint32_t B3_G2_WORDS[2][8] = {
    {0xb62e0d6au, 0x3baa927cu, 0xd1b664fdu, 0xd71e7c52u,
     0xd95d4664u, 0x03873e63u, 0x082ab8f4u, 0x0e75b5b1u},
    {0x7596fe35u, 0xaab7c666u, 0xbb6a27bau, 0x31d21a78u,
     0x680401ffu, 0x85dd7297u, 0xdf39a7e9u, 0x03c52d6au},
};

// -- BLS12-381 Fq: the constants over 12 words (R = 2^384) and its traits --
// They come last so that the BN254 constants keep their constant-bank
// offsets: declared before B3_G2_WORDS, they moved that array and cost a
// G2 kernel two registers (ptxas, sm_90a, CUDA 12.9).
static __constant__ uint32_t P381_WORDS[12] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
    0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
static __constant__ uint32_t NINV381 = 0xfffcfffdu;
static __constant__ uint32_t ONE381_WORDS[12] = {
    0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau, 0x5f489857u,
    0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};

template <>
struct Field<FQ_BLS> {
  static constexpr int NW = 12;
  __device__ __forceinline__ static uint32_t p(int i) { return P381_WORDS[i]; }
  __device__ __forceinline__ static uint32_t ninv() { return NINV381; }
  __device__ __forceinline__ static uint32_t one(int i) { return ONE381_WORDS[i]; }
};

// -- host code: each source's kernels, for CUDA's occupancy query --

// a kernel, its launch's block size and dynamic shared memory
struct KernelSlot {
  const char* name;
  const void* fn;
  int threads;
  size_t smem;
};

// kernel i of `table`: its name, and the blocks of it an SM holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); returns that query's
// error code, -1 past the last kernel
template <size_t N>
inline int occupancy_of(const KernelSlot (&table)[N], int i, const char** name, int* blocks) {
  if (i < 0 || (size_t)i >= N) return -1;
  *name = table[i].name;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, table[i].fn, table[i].threads, table[i].smem);
}

}  // namespace hk
