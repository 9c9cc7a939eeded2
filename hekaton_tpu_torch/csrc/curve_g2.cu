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
// and suffix scan, on up to ~735K lanes) and pdbl_rcb_g2 (no main path
// launches it: the G2 MSM's window Horner runs in horner_g2_kernel, below,
// one launch a fold). Their earlier design, one thread a lane
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

// -- the G2 window Horner fold: one warp over Fq2 ------------------------------
//
// horner_g2_kernel replaces the G2 MSM's window combine, the fori_loop of
// proj.dbl / proj.add in hekaton_tpu/msm/pippenger.py:1145-1153 (on the TPU
// the XLA Fq2 formulas at one lane: PallasProjG2Ops takes Pallas only from
// 128 lanes). The port ran it as one-lane pdbl_rcb_g2 / padd_rcb_g2
// launches, (W-1)(c+1) of them a fold. It is a chain of dependent point ops
// on one lane: bound by the chain's latency, not by bytes or multiplies.
//
// One warp walks it, as horner_kernel (curve.cu) does on G1. The unit of a
// lane is one half of an Fq2 product, c_k = a0 b_k + a1 (k ? b0 : p - b1):
// two wide products and one reduction (csrc/curve_g2.cu's mac_f2 design),
// lane 2i + k making component k of product i of a level. The sums between
// levels are made on every lane, for its own component (Fq2 additions work
// component by component), so each lane adds one component, not two.
//
// b3 = 9/(9+u) is a full Fq2 constant, so b3 Z^2 (the double) and b3 Z1 Z2,
// b3 y3 (the add) would each need a level of their own. Here they need none:
// - the accumulator carries BZ = b3 Z beside X, Y, Z, so the double's
//   level 1 makes t2 = b3 Z^2 as Z BZ, and its level 2 makes the next BZ
//   = (Y BZ) z3 beside Z3 = (Y Z) z3;
// - each window sum Q is multiplied by b3 once, before the chain (Q_BX,
//   Q_BY, Q_BZ, Q_BBZ = b3^2 Z2, and 3 X2, 3 b3 X2), so the add's level 1
//   makes t0 = 3 X1 X2, b3 Z1 Z2, b3 (X1 Z2 + X2 Z1) and b3 z3, b3 t0 (for
//   the next BZ) as products of the accumulator and those values, and its
//   level 2 makes X3, Y3, Z3 and BZ3 = (b3 z3) t4 + (b3 t0) t3.
// So a point op is two levels of products, as on G1 (schedule below: a
// double 5 + 5 products, an add 12 + 8, at most 24 lanes), and between
// them short sums: a double 7 and 2, an add 6 and 4 (G1's horner_dbl and
// horner_add also run mul9's additions). A sum of two products is two
// lanes and one addition, not one lane of four wide products: a level's
// latency is its slowest lane's.
//
// Shared memory: the HG2_NSLOT working values (2,880 bytes, static) and the
// window table, HG2_WVALS values a window (576 bytes), dynamic: W <=
// HG2_MAX_W = 398 fills the 227 KB a block may have (232,448 bytes, after
// cudaFuncSetAttribute). Every G2 MSM has W = ceil(254 / c) <= 127 windows
// for c >= 2 (73 KB).

constexpr int HG2_THREADS = 32;

namespace hg2 {
// The fold's Fq2 values, 16 words each (component k's word j at 8 k + j): the
// accumulator X, Y, Z, BZ = b3 Z, then each product and sum of the schedule
// below, a slot of its own; Q_* are the window sum's values of the add
// (win[], HG2_WVALS a window).
enum Slot : int {
  X, Y, Z, BZ,
  D_YY, D_YZ, D_T2, D_XY, D_BYZ, D_Z3A, D_Z3B, D_Z3, D_Y3, D_T2A, D_T2B, D_T0, D_A, D_B, D_C,
  A_T0, A_T1, A_T2, A_XQY, A_YQX, A_YQZ, A_ZQY, A_XQBZ, A_ZQBX, A_YQBY, A_ZQBBZ, A_BT0,
  A_T3, A_T4, A_Y3, A_BZ3, A_Z3, A_T1M, A_X3A, A_X3B, A_Y3A, A_Y3B, A_Z3A, A_Z3B, A_BZA, A_BZB,
  NSLOT,
  Q_X = 64, Q_Y, Q_Z, Q_3X, Q_BX, Q_BY, Q_BZ, Q_BBZ, Q_3BX, Q_END
};
}  // namespace hg2

constexpr int HG2_NSLOT = hg2::NSLOT;
constexpr int HG2_WVALS = hg2::Q_END - hg2::Q_X;
constexpr int HG2_MAX_W = 398;
static_assert(HG2_MAX_W * HG2_WVALS * 64 + HG2_NSLOT * 64 <= 232448 &&
                  (HG2_MAX_W + 1) * HG2_WVALS * 64 + HG2_NSLOT * 64 > 232448,
              "the window table and the working values in the 227 KB of a block");

// The schedule, RCB15 algorithms 9 and 7 (a=0, b3 = 9/(9+u)): per point op a
// level of products, its sums, a level, its sums. MUL(a, b, out): out = a b,
// product i of a level on lanes 2i and 2i+1. ADD / SUB(out, a, b): out = a +
// b or a - b, on every lane, in order.
// The double: t0 = Y^2, t2 = b3 Z^2; X3 = 2 t0' XY, Y3 = t2 8t0 + t0' (t0 +
// t2), Z3 = YZ 8t0 with t0' = t0 - 3 t2; BZ3 = (Y BZ) 8t0.
#define HG2_DBL_L1(MUL) MUL(Y, Y, D_YY) MUL(Y, Z, D_YZ) MUL(Z, BZ, D_T2) MUL(X, Y, D_XY) MUL(Y, BZ, D_BYZ)
#define HG2_DBL_S1(ADD, SUB)                                                                                \
  ADD(D_Z3A, D_YY, D_YY) ADD(D_Z3B, D_Z3A, D_Z3A) ADD(D_Z3, D_Z3B, D_Z3B) ADD(D_Y3, D_YY, D_T2)            \
  ADD(D_T2A, D_T2, D_T2) ADD(D_T2B, D_T2A, D_T2) SUB(D_T0, D_YY, D_T2B)
#define HG2_DBL_L2(MUL) \
  MUL(D_T2, D_Z3, D_A) MUL(D_T0, D_Y3, D_B) MUL(D_YZ, D_Z3, Z) MUL(D_T0, D_XY, D_C) MUL(D_BYZ, D_Z3, BZ)
#define HG2_DBL_S2(ADD, SUB) ADD(Y, D_A, D_B) ADD(X, D_C, D_C)
// The add of window sum Q: t0 = 3 X1 X2, t1 = Y1 Y2, t2 = b3 Z1 Z2, t3 = X1 Y2
// + Y1 X2, t4 = Y1 Z2 + Z1 Y2, y3 = b3 (X1 Z2 + Z1 X2), z3 = t1 + t2, t1' =
// t1 - t2; X3 = t3 t1' - t4 y3, Y3 = t1' z3 + y3 t0, Z3 = z3 t4 + t0 t3, BZ3
// = (b3 z3) t4 + (b3 t0) t3.
#define HG2_ADD_L1(MUL)                                                                                    \
  MUL(X, Q_3X, A_T0) MUL(Y, Q_Y, A_T1) MUL(Z, Q_BZ, A_T2) MUL(X, Q_Y, A_XQY) MUL(Y, Q_X, A_YQX)             \
  MUL(Y, Q_Z, A_YQZ) MUL(Z, Q_Y, A_ZQY) MUL(X, Q_BZ, A_XQBZ) MUL(Z, Q_BX, A_ZQBX) MUL(Y, Q_BY, A_YQBY)      \
  MUL(Z, Q_BBZ, A_ZQBBZ) MUL(X, Q_3BX, A_BT0)
#define HG2_ADD_S1(ADD, SUB)                                                                               \
  ADD(A_T3, A_XQY, A_YQX) ADD(A_T4, A_YQZ, A_ZQY) ADD(A_Y3, A_XQBZ, A_ZQBX) ADD(A_BZ3, A_YQBY, A_ZQBBZ)    \
  ADD(A_Z3, A_T1, A_T2) SUB(A_T1M, A_T1, A_T2)
#define HG2_ADD_L2(MUL)                                                                                    \
  MUL(A_T3, A_T1M, A_X3A) MUL(A_T4, A_Y3, A_X3B) MUL(A_T1M, A_Z3, A_Y3A) MUL(A_Y3, A_T0, A_Y3B)            \
  MUL(A_Z3, A_T4, A_Z3A) MUL(A_T0, A_T3, A_Z3B) MUL(A_BZ3, A_T4, A_BZA) MUL(A_BT0, A_T3, A_BZB)
#define HG2_ADD_S2(ADD, SUB) SUB(X, A_X3A, A_X3B) ADD(Y, A_Y3A, A_Y3B) ADD(Z, A_Z3A, A_Z3B) ADD(BZ, A_BZA, A_BZB)

__device__ __forceinline__ Fe get8(const uint32_t* s) {
  const uint4* q = reinterpret_cast<const uint4*>(s);
  const uint4 a = q[0], b = q[1];
  Fe r;
  r.w[0] = a.x, r.w[1] = a.y, r.w[2] = a.z, r.w[3] = a.w;
  r.w[4] = b.x, r.w[5] = b.y, r.w[6] = b.z, r.w[7] = b.w;
  return r;
}

__device__ __forceinline__ void put8(uint32_t* s, const Fe& v) {
  uint4* d = reinterpret_cast<uint4*>(s);
  d[0] = make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
  d[1] = make_uint4(v.w[4], v.w[5], v.w[6], v.w[7]);
}

// component k of a b, from a's components and b_k, b_(1-k)
__device__ __forceinline__ Fe f2_half(const Fe& a0, const Fe& a1, const Fe& bk, const Fe& bo, int k) {
  uint32_t T[16] = {0};
  mac_wide(T, a0, bk);
  mac_wide(T, a1, fe_select(k == 0, fe_neg(bo), bo));
  return redc_wide<FQ>(T);
}

// component k of b3 a
__device__ __forceinline__ Fe b3_half(const Fe& a0, const Fe& a1, int k) {
  Fe bk, bo;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    bk.w[i] = B3_G2_WORDS[k][i];
    bo.w[i] = B3_G2_WORDS[k ^ 1][i];
  }
  return f2_half(a0, a1, bk, bo, k);
}

// a product of a level: its operand slots and the slot it fills (-1: none)
struct F2Mul {
  int a, b, out;
};

#define HG2_PICK(A_, B_, O_) \
  if (i++ == j) m = F2Mul{A_, B_, O_};

// product j of a level's schedule (a lane past the level's width fills no slot)
#define HG2_PRODUCT_OF(LEVEL, PAIR) \
  [](int j) {                       \
    using namespace hg2;            \
    F2Mul m{X, X, -1};              \
    int i = 0;                      \
    LEVEL(HG2_PICK)                 \
    return m;                       \
  }(PAIR)

// one level of products: lane 2i + k makes component k of product m (its
// lane pair's) from the working values and, at slots Q_*, the window sum q
__device__ __forceinline__ void hg2_level(uint32_t* work, const uint32_t* q, F2Mul m) {
  const int k = threadIdx.x & 1;
  const uint32_t* a = m.a >= hg2::Q_X ? q + (m.a - hg2::Q_X) * 16 : work + m.a * 16;
  const uint32_t* b = m.b >= hg2::Q_X ? q + (m.b - hg2::Q_X) * 16 : work + m.b * 16;
  const Fe r = f2_half(get8(a), get8(a + 8), get8(b + 8 * k), get8(b + 8 * (k ^ 1)), k);
  if (m.out >= 0) put8(work + m.out * 16 + 8 * k, r);
  __syncwarp();
}

// the sums between levels, on every lane for its component: the working
// values in registers (the loads no sum reads are dead), each sum stored
#define HG2_ADD(O_, A_, B_)                 \
  v[O_] = fe_add<FQ>(v[A_], v[B_]);         \
  put8(work + (O_) * 16 + 8 * k, v[O_]);
#define HG2_SUB(O_, A_, B_)                 \
  v[O_] = fe_sub<FQ>(v[A_], v[B_]);         \
  put8(work + (O_) * 16 + 8 * k, v[O_]);
#define HG2_SUMS(STEPS)                                                                  \
  {                                                                                      \
    using namespace hg2;                                                                 \
    const int k = threadIdx.x & 1;                                                       \
    Fe v[HG2_NSLOT];                                                                     \
    _Pragma("unroll") for (int s = 0; s < HG2_NSLOT; s++) v[s] = get8(work + s * 16 + 8 * k); \
    STEPS(HG2_ADD, HG2_SUB)                                                              \
    __syncwarp();                                                                        \
  }

// (W, 2, 16) limb rows of window sums, 16-byte aligned -> one (2, 16) limb
// row a coordinate: from window W-1 down, c doublings, then the add of the
// next window sum
__global__ void __launch_bounds__(HG2_THREADS)
    horner_g2_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y, const int32_t* __restrict__ z,
                     int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz, int W, int c) {
  using namespace hg2;
  extern __shared__ __align__(16) uint32_t win[];  // value v of window w at win[(w HG2_WVALS + v) 16]
  __shared__ __align__(16) uint32_t work[HG2_NSLOT * 16];
  const int k = threadIdx.x & 1;
  // the window table: lane 2w' + k makes component k of window w's values
  for (int i = threadIdx.x; i < 2 * W; i += HG2_THREADS) {
    const int w = i >> 1;
    uint32_t* q = win + w * HG2_WVALS * 16 + 8 * k;
    const Fe x0 = load_limbs16(x + w * 32), x1 = load_limbs16(x + w * 32 + 16);
    const Fe y0 = load_limbs16(y + w * 32), y1 = load_limbs16(y + w * 32 + 16);
    const Fe z0 = load_limbs16(z + w * 32), z1 = load_limbs16(z + w * 32 + 16);
    const Fe xk = k ? x1 : x0, bx = b3_half(x0, x1, k);
    put8(q + (Q_X - Q_X) * 16, xk);
    put8(q + (Q_Y - Q_X) * 16, k ? y1 : y0);
    put8(q + (Q_Z - Q_X) * 16, k ? z1 : z0);
    put8(q + (Q_3X - Q_X) * 16, fe_add<FQ>(fe_add<FQ>(xk, xk), xk));
    put8(q + (Q_BX - Q_X) * 16, bx);
    put8(q + (Q_BY - Q_X) * 16, b3_half(y0, y1, k));
    put8(q + (Q_BZ - Q_X) * 16, b3_half(z0, z1, k));
    put8(q + (Q_3BX - Q_X) * 16, fe_add<FQ>(fe_add<FQ>(bx, bx), bx));
  }
  __syncwarp();
  for (int i = threadIdx.x; i < 2 * W; i += HG2_THREADS) {
    uint32_t* q = win + (i >> 1) * HG2_WVALS * 16;
    put8(q + (Q_BBZ - Q_X) * 16 + 8 * k, b3_half(get8(q + (Q_BZ - Q_X) * 16), get8(q + (Q_BZ - Q_X) * 16 + 8), k));
  }
  __syncwarp();
  // the accumulator: window W-1's X, Y, Z and b3 Z
  const uint32_t* top = win + (W - 1) * HG2_WVALS * 16;
  for (int i = threadIdx.x; i < 4 * 16; i += HG2_THREADS) {
    const int v = i / 16;  // X, Y, Z, BZ
    work[i] = top[(v == BZ ? Q_BZ - Q_X : v) * 16 + i % 16];
  }
  __syncwarp();
  const int j = threadIdx.x >> 1;
  const F2Mul d1 = HG2_PRODUCT_OF(HG2_DBL_L1, j), d2 = HG2_PRODUCT_OF(HG2_DBL_L2, j);
  const F2Mul a1 = HG2_PRODUCT_OF(HG2_ADD_L1, j), a2 = HG2_PRODUCT_OF(HG2_ADD_L2, j);
#pragma unroll 1
  for (int w = W - 2; w >= 0; w--) {
#pragma unroll 1
    for (int d = 0; d < c; d++) {
      hg2_level(work, win, d1);
      HG2_SUMS(HG2_DBL_S1)
      hg2_level(work, win, d2);
      HG2_SUMS(HG2_DBL_S2)
    }
    const uint32_t* q = win + w * HG2_WVALS * 16;
    hg2_level(work, q, a1);
    HG2_SUMS(HG2_ADD_S1)
    hg2_level(work, q, a2);
    HG2_SUMS(HG2_ADD_S2)
  }
  if (threadIdx.x < 2) {
    store_limbs16(ox + 16 * k, get8(work + X * 16 + 8 * k));
    store_limbs16(oy + 16 * k, get8(work + Y * 16 + 8 * k));
    store_limbs16(oz + 16 * k, get8(work + Z * 16 + 8 * k));
  }
}

unsigned blocks_for(long long n, int lanes) { return (unsigned)((n + lanes - 1) / lanes); }

// every kernel (horner_g2_kernel with W = 20 window sums), for the occupancy query
const KernelSlot KERNELS[] = {
    {"pmadd_rcb_g2_kernel", (const void*)pmadd_rcb_g2_kernel, PAIR_THREADS, 0},
    {"padd_rcb_g2_kernel", (const void*)padd_rcb_g2_kernel, PAIR_THREADS, 0},
    {"pdbl_rcb_g2_kernel", (const void*)pdbl_rcb_g2_kernel, PAIR_THREADS, 0},
    {"horner_g2_kernel", (const void*)horner_g2_kernel, HG2_THREADS, 20 * HG2_WVALS * 16 * sizeof(uint32_t)},
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

// the most window sums hk_horner_g2 takes
extern "C" int hk_horner_g2_max_w() { return HG2_MAX_W; }

// (W, 2, 16) limb rows per coordinate, 16-byte aligned, 1 <= W <= HG2_MAX_W,
// c >= 0 -> one (2, 16) row per coordinate
extern "C" int hk_horner_g2(const void* x, const void* y, const void* z, void* ox, void* oy, void* oz, int W,
                            int c, void* stream) {
  if (W < 1 || W > HG2_MAX_W || c < 0) return (int)cudaErrorInvalidValue;
  const int smem = W * HG2_WVALS * 16 * (int)sizeof(uint32_t);
  const cudaError_t e = cudaFuncSetAttribute(horner_g2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  horner_g2_kernel<<<1, HG2_THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)y, (const int32_t*)z, (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, W, c);
  return (int)cudaGetLastError();
}
