// Field kernels: batched Montgomery multiply and batched modular inversion.
//
// mont_mul replaces fields/pallas_field.py::mont_mul_pallas (_kernel, :40);
// fermat_inv replaces fields/pallas_field.py::fermat_inv_pallas
// (_fermat_kernel, :187). Both Pallas builders are generic in the limb
// count; here each kernel is a template on the field (field.cuh::Field),
// instantiated for BN254 Fq and Fr (8 words, 16 limbs) and for BLS12-381 Fq
// (12 words, 24 limbs). One thread owns one lane.
//
// What bounds them on an H100: mont_mul moves 12 NW bytes per lane in
// each of its three (n, 2 NW) int32 limb rows (half of every word is the zero
// upper 16 bits of a limb): 192 B per product at 8 words for ~264 32-bit
// multiplies, 288 B at 12 words for ~588, so at full occupancy it is bound
// by bytes, not by the integer pipes. The design keeps the framework's limb
// layout at the boundary so that callers need no relayout; a packed layout
// would halve the bytes and is left to a later change. A row is NW/2
// 16-byte loads (the wrapper passes 16-byte aligned rows, copying a view
// that is not): with 2 NW 4-byte loads a row, 64 bytes apart across a warp,
// the kernel took 0.215 ms at 2^20 BN254 lanes, with 16-byte loads 0.080
// (~2.4 TB/s, 75% of the bytes bound; one H100 80GB HBM3, 700 W,
// benches/torch_aff_ab.py).
//
// fermat_inv keeps the Pallas kernel's name and function (a^-1 in Montgomery
// form, canonical, inv(0) = 0), but no longer runs a Fermat chain: a^(p-2)
// took 362-379 (BN254) or 608 (BLS12-381) dependent CIOS products per lane,
// so at the <= 1024 roots of the batch_inv tree it then fed it was bound by
// the latency of that chain (~0.37 ms a BN254 call, ~60x its op bound). It
// now runs Bernstein-Yang "safegcd" divsteps (D. J. Bernstein and B.-Y.
// Yang, "Fast constant-time gcd computation and modular inversion", TCHES
// 2019; the layout follows libsecp256k1's modinv32):
// - (f, g) = (p, x) and (d, e) = (0, R^2 mod p) in signed 30-bit limbs
//   (limbs 0..L-2 in [0, 2^30), the top one signed; L = 9 at 8 words, 13 at
//   12), with d x = f R^2 and e x = g R^2 (mod p) throughout;
// - batches of 30 divsteps on the low 32 bits of f and g (branch-free
//   selects, from delta = 1) give a 2x2 matrix t with 2^30 (f', g') =
//   t (f, g); t is applied to (f, g) exactly and to (d, e) modulo p, with
//   the multiple of p that makes the low 30 bits vanish, so the division by
//   2^30 is exact and no power of 2 is left over;
// - a fixed count of InvShape<F>::BATCHES batches for every lane
//   (warp-uniform, no early exit): 25 x 30 = 750 divsteps at 254 bits and
//   37 x 30 = 1,110 at 381, at least Bernstein-Yang's bound
//   floor((49 d + 57) / 17) (Theorem 11.2, d >= 46): 735 and 1,101. Then g = 0 and f = +-1, so d = +-R^2/x,
//   brought into [0, p) by normalize(). x = 0 keeps d = 0 (f ends at p).
// A batch of 30 divsteps with its 10 L 32x32->64 multiply-adds compiles to
// 864 SASS instructions at 8 words and 975 at 12 (sm_90a), ~21,900 and
// ~36,500 a lane; one thread a lane in blocks of INV_THREADS = 64.
// batch_inv gives it every lane: the affine pairs' roots, one a warp of
// chains (641 for the most launched add of the 2^20 MSM, 22,961 for a
// level-1 round; csrc/curve.cu). Measured on one H100 80GB HBM3
// (700 W; benches/torch_aff_ab.py): 0.029 ms at 1024 BN254 lanes, where the
// ~5,300-operation dependent chain sets the time (~57 cycles a divstep),
// 0.247 ms at 2^18 lanes and 0.050 ms at 1024 BLS12-381 lanes (the Fermat
// chain: 0.37, 2.7 and 1.3 ms). At 2^18 lanes the function's bound
// (Montgomery's trick: 3 products a lane, 0.012 ms) is ~5% of that time,
// since every lane inverts on its own; the kernel's SASS at the instruction
// rate of 128 a SM a clock takes 0.171 ms, ~70% of it.
#include <cuda_runtime.h>

#include "field.cuh"

using namespace hk;

namespace {

constexpr int THREADS = 256;
constexpr int INV_THREADS = 64;
constexpr int32_t M30 = (1 << 30) - 1;

// signed 30-bit limbs of the modulus and of R^2 mod p (the start of e), per
// field id (rows of BN254 padded with zeros), and p^-1 mod 2^30
static __constant__ int32_t INV_P30[3][13] = {
    {0x187cfd47, 0x3082305b, 0x071ca8d3, 0x205aa45a, 0x01585d97, 0x0116da06, 0x1a029b85, 0x139cb84c,
     0x00003064},
    {0x30000001, 0x0f87d64f, 0x1b970914, 0x0cfa121e, 0x01585d28, 0x0116da06, 0x1a029b85, 0x139cb84c,
     0x00003064},
    {0x3fffaaab, 0x27fbffff, 0x153ffffb, 0x2affffac, 0x30f6241e, 0x034a83da, 0x112bf673, 0x12e13ce1,
     0x2cd76477, 0x1ed90d2e, 0x29a4b1ba, 0x3a8e5ff9, 0x001a0111},
};
static __constant__ int32_t INV_R2_30[3][13] = {
    {0x138afa89, 0x0cb3f16d, 0x04501fbf, 0x39c64475, 0x017ff6b5, 0x2c7bfc29, 0x0351f47a, 0x27dc72ae,
     0x000006d8},
    {0x2e216da7, 0x2ee39916, 0x35c59e31, 0x3f8eac78, 0x3b808553, 0x260cf54e, 0x244a58c4, 0x342c5fd3,
     0x00000216},
    {0x1c341746, 0x137c7cd0, 0x1d104f1f, 0x1db9a982, 0x15b6d50a, 0x151db132, 0x183c08de, 0x222a64e7,
     0x152d67eb, 0x3a16d466, 0x3aa9a793, 0x3964b2b8, 0x0011988f},
};
static __constant__ uint32_t INV_PINV30[3] = {0x1b799c77u, 0x10000001u, 0x00030003u};

// limbs and batches of 30 divsteps per field id
template <int F>
struct InvShape {
  static constexpr int L = Field<F>::NW == 8 ? 9 : 13;
  static constexpr int BATCHES = Field<F>::NW == 8 ? 25 : 37;
};

struct Trans {
  int32_t u, v, q, r;
};

__device__ __forceinline__ int64_t mulw(int32_t a, int32_t b) { return (int64_t)a * b; }

// 30 divsteps on the low bits of f and g from delta; returns the new delta.
// Invariant: u f0 + v g0 = 2^s f, q f0 + r g0 = 2^s g after s steps.
__device__ __forceinline__ int32_t divsteps_30(int32_t delta, uint32_t f, uint32_t g, Trans& t) {
  uint32_t u = 1, v = 0, q = 0, r = 1;
#pragma unroll
  for (int s = 0; s < 30; s++) {
    const bool odd = g & 1u, swap = odd && delta > 0;
    // a swap: (delta, f, g, u, v, q, r) <- (-delta, g, -f, q, r, -u, -v)
    const uint32_t f0 = f, u0 = u, v0 = v;
    f = swap ? g : f;
    u = swap ? q : u;
    v = swap ? r : v;
    g = swap ? 0u - f0 : g;
    q = swap ? 0u - u0 : q;
    r = swap ? 0u - v0 : r;
    delta = swap ? -delta : delta;
    if (odd) {  // then g odd: (g, q, r) += (f, u, v)
      g += f;
      q += u;
      r += v;
    }
    g >>= 1;
    u <<= 1;
    v <<= 1;
    delta += 1;
  }
  t = Trans{(int32_t)u, (int32_t)v, (int32_t)q, (int32_t)r};
  return delta;
}

// (f, g) <- t (f, g) / 2^30, exactly
template <int L>
__device__ __forceinline__ void update_fg(int32_t* f, int32_t* g, const Trans& t) {
  int64_t cf = mulw(t.u, f[0]) + mulw(t.v, g[0]);
  int64_t cg = mulw(t.q, f[0]) + mulw(t.r, g[0]);
  cf >>= 30;
  cg >>= 30;
#pragma unroll
  for (int k = 1; k < L; k++) {
    cf += mulw(t.u, f[k]) + mulw(t.v, g[k]);
    cg += mulw(t.q, f[k]) + mulw(t.r, g[k]);
    f[k - 1] = (int32_t)cf & M30;
    cf >>= 30;
    g[k - 1] = (int32_t)cg & M30;
    cg >>= 30;
  }
  f[L - 1] = (int32_t)cf;
  g[L - 1] = (int32_t)cg;
}

// (d, e) <- (t (d, e) + p (md, me)) / 2^30 with md, me making the low 30
// bits zero; d, e stay in (-2p, p) (libsecp256k1's modinv32_update_de_30)
template <int F, int L>
__device__ __forceinline__ void update_de(int32_t* d, int32_t* e, const Trans& t) {
  int32_t sd = d[L - 1] >> 31, se = e[L - 1] >> 31;
  int32_t md = (t.u & sd) + (t.v & se), me = (t.q & sd) + (t.r & se);
  int64_t cd = mulw(t.u, d[0]) + mulw(t.v, e[0]);
  int64_t ce = mulw(t.q, d[0]) + mulw(t.r, e[0]);
  md -= (int32_t)((INV_PINV30[F] * (uint32_t)cd + (uint32_t)md) & M30);
  me -= (int32_t)((INV_PINV30[F] * (uint32_t)ce + (uint32_t)me) & M30);
  cd += mulw(INV_P30[F][0], md);
  ce += mulw(INV_P30[F][0], me);
  cd >>= 30;
  ce >>= 30;
#pragma unroll
  for (int k = 1; k < L; k++) {
    cd += mulw(t.u, d[k]) + mulw(t.v, e[k]) + mulw(INV_P30[F][k], md);
    ce += mulw(t.q, d[k]) + mulw(t.r, e[k]) + mulw(INV_P30[F][k], me);
    d[k - 1] = (int32_t)cd & M30;
    cd >>= 30;
    e[k - 1] = (int32_t)ce & M30;
    ce >>= 30;
  }
  d[L - 1] = (int32_t)cd;
  e[L - 1] = (int32_t)ce;
}

template <int L>
__device__ __forceinline__ void carry30(int32_t* r) {
#pragma unroll
  for (int k = 0; k < L - 1; k++) {
    r[k + 1] += r[k] >> 30;
    r[k] &= M30;
  }
}

// r in (-2p, p) -> sign(f) r in [0, p) (libsecp256k1's modinv32_normalize_30)
template <int F, int L>
__device__ __forceinline__ void normalize(int32_t* r, int32_t sign) {
  int32_t add = r[L - 1] >> 31, neg = sign >> 31;
#pragma unroll
  for (int k = 0; k < L; k++) r[k] = ((r[k] + (INV_P30[F][k] & add)) ^ neg) - neg;
  carry30<L>(r);
  add = r[L - 1] >> 31;
#pragma unroll
  for (int k = 0; k < L; k++) r[k] += INV_P30[F][k] & add;
  carry30<L>(r);
}

// NW words -> L signed 30-bit limbs of a value below 2^(32 NW), and back
// (limbs 0..L-2 in [0, 2^30), the top one non-negative and small)
template <int NW, int L>
__device__ __forceinline__ void to_s30(const FeN<NW>& x, int32_t* r) {
#pragma unroll
  for (int k = 0; k < L; k++) {
    const int j = 30 * k / 32, s = 30 * k % 32;
    uint32_t w = j < NW ? x.w[j] >> s : 0u;
    if (s > 2 && j + 1 < NW) w |= x.w[j + 1] << (32 - s);
    r[k] = (int32_t)(w & M30);
  }
}

template <int NW, int L>
__device__ __forceinline__ FeN<NW> from_s30(const int32_t* r) {
  FeN<NW> x;
#pragma unroll
  for (int j = 0; j < NW; j++) {
    const int k = 32 * j / 30, s = 32 * j % 30;
    uint32_t w = (uint32_t)r[k] >> s;
    if (k + 1 < L) w |= (uint32_t)r[k + 1] << (30 - s);
    if (k + 2 < L && s > 28) w |= (uint32_t)r[k + 2] << (60 - s);
    x.w[j] = w;
  }
  return x;
}

// rows by 16-byte loads and stores (every pointer 16-byte aligned)
template <int F>
__global__ void mont_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                                int32_t* __restrict__ out, long long n, long long nb) {
  constexpr int NW = Field<F>::NW;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  FeF<F> x = load_limbs16<NW>(a + i * 2 * NW);
  FeF<F> y = load_limbs16<NW>(b + (i % nb) * 2 * NW);
  store_limbs16(out + i * 2 * NW, fe_mul<F>(x, y));
}

// a^-1 R^2 for the Montgomery form x = a R of each lane, by divsteps (see
// the note at the top); inv(0) = 0
template <int F>
__global__ void fermat_inv_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out,
                                  long long n) {
  constexpr int NW = Field<F>::NW, L = InvShape<F>::L;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int32_t f[L], g[L], d[L], e[L];
  to_s30<NW, L>(load_limbs<NW>(a + i * 2 * NW), g);
#pragma unroll
  for (int k = 0; k < L; k++) {
    f[k] = INV_P30[F][k];
    d[k] = 0;
    e[k] = INV_R2_30[F][k];
  }
  int32_t delta = 1;
#pragma unroll 1
  for (int b = 0; b < InvShape<F>::BATCHES; b++) {
    Trans t;
    delta = divsteps_30(delta, (uint32_t)f[0], (uint32_t)g[0], t);
    update_de<F, L>(d, e, t);
    update_fg<L>(f, g, t);
  }
  normalize<F, L>(d, f[L - 1]);
  store_limbs(out + i * 2 * NW, from_s30<NW, L>(d));
}

unsigned blocks_for(long long n, int threads = THREADS) { return (unsigned)((n + threads - 1) / threads); }

// every kernel at its launch's block size, for the occupancy query
const KernelSlot KERNELS[] = {
    {"mont_mul_kernel<0>", (const void*)mont_mul_kernel<FQ>, THREADS, 0},
    {"mont_mul_kernel<1>", (const void*)mont_mul_kernel<FR>, THREADS, 0},
    {"mont_mul_kernel<2>", (const void*)mont_mul_kernel<FQ_BLS>, THREADS, 0},
    {"fermat_inv_kernel<0>", (const void*)fermat_inv_kernel<FQ>, INV_THREADS, 0},
    {"fermat_inv_kernel<1>", (const void*)fermat_inv_kernel<FR>, INV_THREADS, 0},
    {"fermat_inv_kernel<2>", (const void*)fermat_inv_kernel<FQ_BLS>, INV_THREADS, 0},
};

}  // namespace

// kernel i's name and resident blocks an SM (field.cuh::occupancy_of)
extern "C" int hk_field_occupancy(int i, const char** name, int* blocks) {
  return occupancy_of(KERNELS, i, name, blocks);
}

// out[i] = a[i] * b[i % nb] * R^-1 mod p over n lanes of 2 NW limbs, 16-byte
// aligned rows; an unknown field id launches nothing and returns cudaErrorInvalidValue
extern "C" int hk_mont_mul(int field, const void* a, const void* b, void* out, long long n,
                           long long nb, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  auto pa = (const int32_t*)a;
  auto pb = (const int32_t*)b;
  auto po = (int32_t*)out;
  switch (field) {
    case FQ:
      mont_mul_kernel<FQ><<<blocks_for(n), THREADS, 0, s>>>(pa, pb, po, n, nb);
      break;
    case FR:
      mont_mul_kernel<FR><<<blocks_for(n), THREADS, 0, s>>>(pa, pb, po, n, nb);
      break;
    case FQ_BLS:
      mont_mul_kernel<FQ_BLS><<<blocks_for(n), THREADS, 0, s>>>(pa, pb, po, n, nb);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// out[i] = a[i]^-1 (Montgomery form, canonical; inv(0) = 0) over n lanes of
// canonical inputs; an unknown field id launches nothing and returns
// cudaErrorInvalidValue
extern "C" int hk_fermat_inv(int field, const void* a, void* out, long long n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  auto pa = (const int32_t*)a;
  auto po = (int32_t*)out;
  const unsigned blocks = blocks_for(n, INV_THREADS);
  switch (field) {
    case FQ:
      fermat_inv_kernel<FQ><<<blocks, INV_THREADS, 0, s>>>(pa, po, n);
      break;
    case FR:
      fermat_inv_kernel<FR><<<blocks, INV_THREADS, 0, s>>>(pa, po, n);
      break;
    case FQ_BLS:
      fermat_inv_kernel<FQ_BLS><<<blocks, INV_THREADS, 0, s>>>(pa, po, n);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
