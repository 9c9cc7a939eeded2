// BN254 G2 kernels of the G2 MSM: complete projective mixed add, add and
// double over Fq2 (Renes-Costello-Batina 2015, algorithms 8, 7 and 9, a=0,
// b3 = 9/(9+u)).
//
// pmadd_rcb_g2_kernel replaces curves/pallas_curve.py::_pmadd_rcb_g2_kernel
// (:1115, formulas _pmadd_rcb_g2_tiles :1031), padd_rcb_g2_kernel replaces
// _padd_rcb_g2_kernel (:1130, _padd_rcb_g2_tiles :1059), pdbl_rcb_g2_kernel
// replaces _pdbl_rcb_g2_kernel (:1148, _pdbl_rcb_g2_tiles :1083); all three
// ran through the one pallas_call of pallas_curve.py::_build (:1250) on
// (n, 32) u32 rows. Here every coordinate is an (n, 2, 16) int32 limb row.
//
// What bounds them on an H100: per lane, a mixed add is 13 Fq2 products
// against 1 KB of traffic (5 coordinates in, 3 out, 128 B each); an add is
// 14 Fq2 products against 1.1 KB and a double 7 products and 2 squares
// against 768 B. With Karatsuba (3 8x8-word products an Fq2 product, 128
// 32-bit multiplies each) and one Montgomery reduction (136) a component of
// each result, a sum of two products reduced once, the function needs 39
// wide products and 20 reductions a mixed add (~7.7K multiplies), 42 and 22
// an add (~8.4K), 25 and 16 a double (~5.4K): at ~8 multiplies per byte
// they are bound by integer multiply throughput, not by bytes, once enough
// lanes are resident and their dependent multiply-add chains are hidden.
//
// All three run two threads a lane, thread k making the c_k half of every
// Fq2 value: pmadd_rcb_g2 and padd_rcb_g2 (the G2 MSM's level 1, collapse
// and suffix scan, on up to ~735K lanes) and pdbl_rcb_g2 (the G2 Horner's
// doublings, one lane a launch). Their earlier design, one thread a lane
// with the whole formula unrolled over Fq2 values, took 176-255 registers
// (the adds spilled 172 and 12 bytes), so 8-11 warps fitted on an SM: too
// few to hide the dependent multiply-add chains; and at one lane it left
// the second thread's half of the work on the first.
// - An Fq2 product's half is a sum of two 8x8-word products in a 16-word
//   accumulator and one Montgomery reduction (lazy reduction): thread 0
//   makes c0 = a0 b0 + a1 (p - b1), thread 1 c1 = a0 b1 + a1 b0. RCB's
//   closing sums of two Fq2 products (x3 = t3 t1 - t4 y3, y3, z3) are one
//   4-term sum and one reduction. Every term is a product of values below p
//   (a negated operand is p - b), so a sum stays below 4 p^2 < p 2^256 and
//   its reduction below 2p: one conditional subtraction makes it
//   canonical. Canonical values are unique, so the limbs equal the plain
//   Karatsuba formulas' bit for bit. A mixed add is 26 such products and 10
//   reductions a thread, an add 28 and 11, a double 18 and 8 (its closing
//   y3 = t2 z3 + t0 y3 one 4-term sum): ~9.4K, ~10.2K and ~6.8K multiplies
//   a lane, ~1.2-1.26 times what Karatsuba needs (schoolbook's 4 wide
//   products an Fq2 product, traded for threads that never wait on each
//   other).
// - The 32x32-bit products accumulate on the PTX carry chains of
//   field.cuh (mac_wide: rows of 8 products, each as two chains of
//   mad.lo.cc / madc.hi.cc; redc_wide), which every kernel's fe_mul shares.
// - The operands live in shared memory, not in registers: a block stages
//   its 64 lanes' input rows there with coalesced 16-byte loads (two 16-bit
//   limbs packed into each 32-bit word), and the temporaries of the closing
//   products replace them once both threads of a lane have read them
//   (__syncwarp). A thread reads either half of any operand just before it
//   multiplies it (volatile loads), so no thread leaves early and nothing
//   is exchanged through registers. 8 coordinates of 64 lanes are 32 KB a
//   block (the double's 7, 28 KB).
// - Kept: 128 threads a block under __launch_bounds__(128, 3), 112
//   (pmadd) and 110 (padd) registers, no spills (ptxas, sm_90a, CUDA 12.9):
//   3 blocks, 12 warps, an SM. On an H100 (700 W), in turns with the
//   one-thread bodies in one call: at 2^18 lanes 0.27 ms against 1.73
//   (mixed add) and 0.37 against 1.75 (add); at the G2 MSM's 734,740
//   level-1 lanes 0.73 against 4.83 and 1.03 against 4.79: ~45% and ~35% of
//   the multiply bound above at either width. On field.cuh's shared chains
//   (fe_sqr, one reduction) 0.244 and 0.270 ms at 2^18 lanes
//   (benches/torch_aff_ab.py).
//   Tried and left, all on C carries: this design (142 registers;
//   0.48-0.53 and 0.64-0.68 ms at 2^18), held to 128 registers (4 blocks)
//   or in blocks of 64 or 32 threads (5-16% slower, padd spills), and the
//   temporaries exchanged by __shfl_xor_sync instead of shared memory (156
//   and 168 registers uncapped, spills at 128); PERF.md, section 6.
//   pdbl_rcb_g2 on the same design replaced a one-thread body (176
//   registers, 0.621 ms at 2^18 lanes): PERF.md, section 6.
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

using namespace hk;

namespace {

constexpr int PAIR_THREADS = 128;  // two threads a lane
constexpr int PAIR_MIN_BLOCKS = 3;
constexpr int PAIR_LANES = PAIR_THREADS / 2;
constexpr int COORD_WORDS = PAIR_THREADS * 8;  // one coordinate of a block's lanes, packed words
constexpr int SLOTS = 8;  // coordinates a block keeps in shared memory: 32 KB
constexpr int DBL_SLOTS = 7;  // the doubling's: 28 KB

// -- two threads a lane: the per-thread half of the Fq2 arithmetic --
//
// A block's shared memory is SLOTS coordinates of its 64 lanes as packed
// words: the word w of lane l, component k, of slot c at sm[c][l*16 + k*8 +
// w], so thread t = 2l + k finds its own half at t*8 and its partner's at
// (t^1)*8. The inputs are staged there; once both threads of a lane have
// read them (__syncwarp) the temporaries of the closing products take their
// place, so a thread reads its partner's half of a computed value as it
// reads an input.

__device__ __forceinline__ Fe fe_neg(const Fe& a) { return fe_sub<FQ>(fe_zero(), a); }

using Slots = uint32_t (*)[COORD_WORDS];

// thread t's half (lane t / 2, component t % 2) of a slot. The load is
// volatile and clobbers memory, so that every use reads shared memory again
// (no half stays in registers between its uses) and no store moves past it.
__device__ __forceinline__ Fe half(const uint32_t* sm, int t) {
  unsigned a = (unsigned)__cvta_generic_to_shared(sm + 8 * t);
  Fe r;
  asm volatile("ld.volatile.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(r.w[0]), "=r"(r.w[1]), "=r"(r.w[2]), "=r"(r.w[3]) : "r"(a) : "memory");
  asm volatile("ld.volatile.shared.v4.u32 {%0, %1, %2, %3}, [%4+16];"
               : "=r"(r.w[4]), "=r"(r.w[5]), "=r"(r.w[6]), "=r"(r.w[7]) : "r"(a) : "memory");
  return r;
}

__device__ __forceinline__ void put_half(uint32_t* sm, int t, const Fe& v) {
  uint4* d4 = reinterpret_cast<uint4*>(sm) + 2 * t;
  d4[0] = make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
  d4[1] = make_uint4(v.w[4], v.w[5], v.w[6], v.w[7]);
}

// an Fq2 operand in the slots: slot a, or the sum of slots a and b
struct Op {
  int a, b = -1;
};

__device__ __forceinline__ Fe ld(Slots sm, Op x, int idx) {
  Fe v = half(sm[x.a], idx);
  return x.b < 0 ? v : fe_add<FQ>(v, half(sm[x.b], idx));
}

// T += the k-th component of x y (of -x y when neg), from the slots:
// c0 = x0 y0 + x1 (p - y1), c1 = x0 y1 + x1 y0
__device__ __forceinline__ void mac_f2(uint32_t T[16], Slots sm, int t, Op x, Op y, bool neg = false) {
  const int k = t & 1;
  Fe b = ld(sm, y, t);
  mac_wide(T, ld(sm, x, t & ~1), neg ? fe_neg(b) : b);
  Fe bo = ld(sm, y, t ^ 1);
  mac_wide(T, ld(sm, x, t | 1), fe_select((k == 0) != neg, fe_neg(bo), bo));
}

// the k-th component of x y
__device__ __forceinline__ Fe f2_mul_half(Slots sm, int t, Op x, Op y) {
  uint32_t T[16] = {0};
  mac_f2(T, sm, t, x, y);
  return redc_wide<FQ>(T);
}

// the k-th component of x b3 = x 9/(9+u), b3's halves from constant memory
__device__ __forceinline__ Fe mul_b3_half(Slots sm, int t, Op x) {
  const int k = t & 1;
  Fe b, bo;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    b.w[i] = B3_G2_WORDS[k][i];
    bo.w[i] = B3_G2_WORDS[k ^ 1][i];
  }
  uint32_t T[16] = {0};
  mac_wide(T, ld(sm, x, t & ~1), b);
  mac_wide(T, ld(sm, x, t | 1), k == 0 ? fe_neg(bo) : bo);
  return redc_wide<FQ>(T);
}

struct Half3 {
  Fe x, y, z;
};

// the closing products shared by algorithms 7 and 8, with one reduction a
// coordinate, from the slots where both kernels leave their temporaries: t0
// = 3 X1 X2 (slot 0), t1 = Y1 Y2 - b3 Z1 Z2 (1), y3 times b3 (2), z3 = Y1 Y2
// + b3 Z1 Z2 (3), t3 (6) and t4 (7)
__device__ __forceinline__ Half3 rcb_close(Slots sm, int t) {
  const Op t0{0}, t1{1}, y3{2}, z3{3}, t3{6}, t4{7};
  Half3 r;
  uint32_t T[16] = {0};
  mac_f2(T, sm, t, t3, t1);
  mac_f2(T, sm, t, t4, y3, true);
  r.x = redc_wide<FQ>(T);  // t3 t1 - t4 y3
  uint32_t U[16] = {0};
  mac_f2(U, sm, t, t1, z3);
  mac_f2(U, sm, t, y3, t0);
  r.y = redc_wide<FQ>(U);  // t1 z3 + y3 t0
  uint32_t V[16] = {0};
  mac_f2(V, sm, t, z3, t4);
  mac_f2(V, sm, t, t0, t3);
  r.z = redc_wide<FQ>(V);  // z3 t4 + t0 t3
  return r;
}

// slots 0-3 of the closing, once both threads of the lane have read what
// they replace; t1 - t2 and t1 + t2 are t1 and z3
__device__ __forceinline__ void put_close(Slots sm, int t, const Fe& t0, const Fe& t1, const Fe& t2,
                                          const Fe& y3) {
  put_half(sm[0], t, t0);
  put_half(sm[1], t, fe_sub<FQ>(t1, t2));
  put_half(sm[2], t, y3);
  put_half(sm[3], t, fe_add<FQ>(t1, t2));
  __syncwarp();
}

// RCB15 Algorithm 8 (a=0, Z2=1) on this thread's halves; slots 0-4 hold the
// staged x, y, z, ax, ay. t3 and t4 go to their slots as soon as they are
// made, y3 through slot 5 (b3 y3 needs the partner's half). Returns whether
// the operand is the (0,0) sentinel, whose lane keeps P (the caller reloads
// it).
__device__ __forceinline__ bool pmadd_half(Slots sm, int t, Half3& r) {
  const Op x{0}, y{1}, z{2}, ax{3}, ay{4};
  bool inf = fe_is_zero(half(sm[4], t)) && fe_is_zero(half(sm[4], t ^ 1));
  Fe t0 = f2_mul_half(sm, t, x, ax);
  Fe t1 = f2_mul_half(sm, t, y, ay);
  put_half(sm[6], t, fe_sub<FQ>(f2_mul_half(sm, t, Op{3, 4}, Op{0, 1}), fe_add<FQ>(t0, t1)));  // t3
  put_half(sm[7], t, fe_add<FQ>(f2_mul_half(sm, t, ay, z), half(sm[1], t)));                    // t4
  put_half(sm[5], t, fe_add<FQ>(f2_mul_half(sm, t, ax, z), half(sm[0], t)));                    // y3
  Fe t2 = mul_b3_half(sm, t, z);
  t0 = fe_add<FQ>(fe_add<FQ>(t0, t0), t0);
  __syncwarp();
  put_close(sm, t, t0, t1, t2, mul_b3_half(sm, t, Op{5}));
  r = rcb_close(sm, t);
  return inf;
}

// RCB15 Algorithm 7 (a=0) on this thread's halves; slots 0-5 hold the staged
// x1, y1, z1, x2, y2, z2. t3 and t4 go to their slots as soon as they are
// made, t2 and y3 through slots 4 and 5 (b3 t2 and b3 y3 need the
// partner's halves).
__device__ __forceinline__ void padd_half(Slots sm, int t, Half3& r) {
  Fe t0 = f2_mul_half(sm, t, Op{0}, Op{3});
  Fe t1 = f2_mul_half(sm, t, Op{1}, Op{4});
  put_half(sm[6], t, fe_sub<FQ>(f2_mul_half(sm, t, Op{0, 1}, Op{3, 4}), fe_add<FQ>(t0, t1)));  // t3
  Fe t2 = f2_mul_half(sm, t, Op{2}, Op{5});
  put_half(sm[7], t, fe_sub<FQ>(f2_mul_half(sm, t, Op{1, 2}, Op{4, 5}), fe_add<FQ>(t1, t2)));  // t4
  Fe y3 = fe_sub<FQ>(f2_mul_half(sm, t, Op{0, 2}, Op{3, 5}), fe_add<FQ>(t0, t2));
  t0 = fe_add<FQ>(fe_add<FQ>(t0, t0), t0);
  __syncwarp();
  put_half(sm[4], t, t2);
  put_half(sm[5], t, y3);
  __syncwarp();
  t2 = mul_b3_half(sm, t, Op{4});
  put_close(sm, t, t0, t1, t2, mul_b3_half(sm, t, Op{5}));
  r = rcb_close(sm, t);
}

// RCB15 Algorithm 9 (a=0) on this thread's halves; slots 0-2 hold the staged
// x, y, z. Y^2, YZ, Z^2 and XY read only the inputs; Z^2, YZ, XY and z3 =
// 8 Y^2 go to slots 3-6 (b3 Z^2 and the closing products need the
// partner's halves), then t2 = b3 Z^2, y3 = Y^2 + t2 and t0 = Y^2 - 3 t2
// to slots 0-2 once both threads have read the inputs. The closing y3 =
// t2 z3 + t0 y3 is one 4-term sum and one reduction.
__device__ __forceinline__ void pdbl_half(Slots sm, int t, Half3& r) {
  const Op x{0}, y{1}, z{2};
  Fe t0 = f2_mul_half(sm, t, y, y);
  put_half(sm[3], t, f2_mul_half(sm, t, z, z));
  put_half(sm[4], t, f2_mul_half(sm, t, y, z));
  put_half(sm[5], t, f2_mul_half(sm, t, x, y));
  Fe z3 = fe_add<FQ>(t0, t0);
  z3 = fe_add<FQ>(z3, z3);
  put_half(sm[6], t, fe_add<FQ>(z3, z3));
  __syncwarp();
  const Fe t2 = mul_b3_half(sm, t, Op{3});
  put_half(sm[0], t, t2);
  put_half(sm[1], t, fe_add<FQ>(t0, t2));
  put_half(sm[2], t, fe_sub<FQ>(t0, fe_add<FQ>(fe_add<FQ>(t2, t2), t2)));
  __syncwarp();
  const Op t2s{0}, y3{1}, t0s{2}, t1{4}, xy{5}, z3s{6};
  uint32_t T[16] = {0};
  mac_f2(T, sm, t, t2s, z3s);
  mac_f2(T, sm, t, t0s, y3);
  r.y = redc_wide<FQ>(T);  // t2 z3 + t0 y3
  r.z = f2_mul_half(sm, t, t1, z3s);
  const Fe x3 = f2_mul_half(sm, t, t0s, xy);
  r.x = fe_add<FQ>(x3, x3);
}

// one coordinate of the block's lanes, (PAIR_LANES, 2, 16) limbs, into a
// slot as packed words: 16-byte loads on consecutive addresses; missing
// lanes of the last block read as 0
__device__ __forceinline__ void stage_in(uint32_t* sm, const int32_t* src, long long lane0, long long n) {
  const int4* s4 = reinterpret_cast<const int4*>(src + lane0 * 32);
  uint2* d2 = reinterpret_cast<uint2*>(sm);
#pragma unroll
  for (int q = 0; q < 4; q++) {
    int idx = threadIdx.x + q * PAIR_THREADS;  // 16-byte chunk idx: 4 limbs of lane idx / 8
    uint2 w = make_uint2(0u, 0u);
    if (lane0 + idx / 8 < n) {
      int4 v = s4[idx];
      w.x = (uint32_t)v.x | ((uint32_t)v.y << 16);
      w.y = (uint32_t)v.z | ((uint32_t)v.w << 16);
    }
    d2[idx] = w;
  }
}

__device__ __forceinline__ void stage_out(int32_t* dst, const uint32_t* sm, long long lane0, long long n) {
  int4* d4 = reinterpret_cast<int4*>(dst + lane0 * 32);
  const uint2* s2 = reinterpret_cast<const uint2*>(sm);
#pragma unroll
  for (int q = 0; q < 4; q++) {
    int idx = threadIdx.x + q * PAIR_THREADS;
    if (lane0 + idx / 8 < n) {
      uint2 w = s2[idx];
      d4[idx] = make_int4((int)(w.x & 0xffffu), (int)(w.x >> 16), (int)(w.y & 0xffffu), (int)(w.y >> 16));
    }
  }
}

// thread t's half of lane `lane`'s (2, 16) limb row, from device memory
__device__ __forceinline__ Fe global_half(const int32_t* src, long long lane, int t) {
  const int4* s4 = reinterpret_cast<const int4*>(src + lane * 32 + (t & 1) * 16);
  Fe r;
#pragma unroll
  for (int q = 0; q < 4; q++) {
    int4 v = s4[q];
    r.w[2 * q] = (uint32_t)v.x | ((uint32_t)v.y << 16);
    r.w[2 * q + 1] = (uint32_t)v.z | ((uint32_t)v.w << 16);
  }
  return r;
}

// the block's output halves back to (n, 2, 16) limb rows through slots 0-2
__device__ __forceinline__ void write_out(Slots sm, int32_t* ox, int32_t* oy, int32_t* oz, const Half3& r,
                                          long long lane0, long long n) {
  const int t = threadIdx.x;
  __syncthreads();
  put_half(sm[0], t, r.x);
  put_half(sm[1], t, r.y);
  put_half(sm[2], t, r.z);
  __syncthreads();
  stage_out(ox, sm[0], lane0, n);
  stage_out(oy, sm[1], lane0, n);
  stage_out(oz, sm[2], lane0, n);
}

__global__ void __launch_bounds__(PAIR_THREADS, PAIR_MIN_BLOCKS)
    pmadd_rcb_g2_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                        const int32_t* __restrict__ z, const int32_t* __restrict__ ax,
                        const int32_t* __restrict__ ay, int32_t* __restrict__ ox,
                        int32_t* __restrict__ oy, int32_t* __restrict__ oz, long long n) {
  __shared__ __align__(16) uint32_t sm[SLOTS][COORD_WORDS];
  const long long lane0 = (long long)blockIdx.x * PAIR_LANES;
  stage_in(sm[0], x, lane0, n);
  stage_in(sm[1], y, lane0, n);
  stage_in(sm[2], z, lane0, n);
  stage_in(sm[3], ax, lane0, n);
  stage_in(sm[4], ay, lane0, n);
  __syncthreads();
  const int t = threadIdx.x;
  Half3 r;
  const long long lane = lane0 + t / 2;
  if (pmadd_half(sm, t, r) && lane < n) r = Half3{global_half(x, lane, t), global_half(y, lane, t),
                                                  global_half(z, lane, t)};
  write_out(sm, ox, oy, oz, r, lane0, n);
}

__global__ void __launch_bounds__(PAIR_THREADS, PAIR_MIN_BLOCKS)
    padd_rcb_g2_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
                       const int32_t* __restrict__ z1, const int32_t* __restrict__ x2,
                       const int32_t* __restrict__ y2, const int32_t* __restrict__ z2,
                       int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                       int32_t* __restrict__ oz, long long n) {
  __shared__ __align__(16) uint32_t sm[SLOTS][COORD_WORDS];
  const long long lane0 = (long long)blockIdx.x * PAIR_LANES;
  stage_in(sm[0], x1, lane0, n);
  stage_in(sm[1], y1, lane0, n);
  stage_in(sm[2], z1, lane0, n);
  stage_in(sm[3], x2, lane0, n);
  stage_in(sm[4], y2, lane0, n);
  stage_in(sm[5], z2, lane0, n);
  __syncthreads();
  Half3 r;
  padd_half(sm, threadIdx.x, r);
  write_out(sm, ox, oy, oz, r, lane0, n);
}

__global__ void __launch_bounds__(PAIR_THREADS, PAIR_MIN_BLOCKS)
    pdbl_rcb_g2_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                       const int32_t* __restrict__ z, int32_t* __restrict__ ox,
                       int32_t* __restrict__ oy, int32_t* __restrict__ oz, long long n) {
  __shared__ __align__(16) uint32_t sm[DBL_SLOTS][COORD_WORDS];
  const long long lane0 = (long long)blockIdx.x * PAIR_LANES;
  stage_in(sm[0], x, lane0, n);
  stage_in(sm[1], y, lane0, n);
  stage_in(sm[2], z, lane0, n);
  __syncthreads();
  Half3 r;
  pdbl_half(sm, threadIdx.x, r);
  write_out(sm, ox, oy, oz, r, lane0, n);
}

unsigned blocks_for(long long n, int lanes) { return (unsigned)((n + lanes - 1) / lanes); }

// every kernel (its shared memory static), for the occupancy query
const KernelSlot KERNELS[] = {
    {"pmadd_rcb_g2_kernel", (const void*)pmadd_rcb_g2_kernel, PAIR_THREADS, 0},
    {"padd_rcb_g2_kernel", (const void*)padd_rcb_g2_kernel, PAIR_THREADS, 0},
    {"pdbl_rcb_g2_kernel", (const void*)pdbl_rcb_g2_kernel, PAIR_THREADS, 0},
};

}  // namespace

// kernel i's name and resident blocks an SM (field.cuh::occupancy_of)
extern "C" int hk_curve_g2_occupancy(int i, const char** name, int* blocks) {
  return occupancy_of(KERNELS, i, name, blocks);
}

// n lanes of (2, 16) limb rows per coordinate, 16-byte aligned; outputs
// must not alias inputs
extern "C" int hk_pmadd_rcb_g2(const void* x, const void* y, const void* z, const void* ax,
                               const void* ay, void* ox, void* oy, void* oz, long long n,
                               void* stream) {
  pmadd_rcb_g2_kernel<<<blocks_for(n, PAIR_LANES), PAIR_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)y, (const int32_t*)z, (const int32_t*)ax,
      (const int32_t*)ay, (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, n);
  return (int)cudaGetLastError();
}

extern "C" int hk_padd_rcb_g2(const void* x1, const void* y1, const void* z1, const void* x2,
                              const void* y2, const void* z2, void* ox, void* oy, void* oz,
                              long long n, void* stream) {
  padd_rcb_g2_kernel<<<blocks_for(n, PAIR_LANES), PAIR_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x1, (const int32_t*)y1, (const int32_t*)z1, (const int32_t*)x2,
      (const int32_t*)y2, (const int32_t*)z2, (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, n);
  return (int)cudaGetLastError();
}

extern "C" int hk_pdbl_rcb_g2(const void* x, const void* y, const void* z, void* ox, void* oy,
                              void* oz, long long n, void* stream) {
  pdbl_rcb_g2_kernel<<<blocks_for(n, PAIR_LANES), PAIR_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)y, (const int32_t*)z, (int32_t*)ox, (int32_t*)oy,
      (int32_t*)oz, n);
  return (int)cudaGetLastError();
}
