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
// What bounds them on an H100: per lane, a mixed add is 13 Fq2 products (39
// Fq Montgomery products, ~10K 32-bit multiplies) against 1 KB of traffic
// (5 coordinates in, 3 out, 128 B each); an add is 14 Fq2 products (42)
// against 1.1 KB and a double 7 products and 2 squares (25, f2_sqr) against
// 768 B. At ~10 multiplies per byte they are
// bound by integer multiply throughput, not by bytes, once enough lanes are
// resident.
//
// Design: one thread per lane running the straight-line formulas of
// curves/proj.py in registers, as the horner kernel runs the G1 ones. The
// state is heavy: an Fq2 projective point and an affine operand are 80
// 32-bit words before the temporaries (t0..t4 and the outputs, another 80),
// so register pressure bounds occupancy; `-Xptxas -v` (cuda_lib.build)
// reports each kernel's registers and spills, and chip_smoke.py prints
// them. THREADS = 128 with __launch_bounds__ lets ptxas use up to 255
// registers a thread. Splitting the formula across threads, or keeping the
// operands in shared memory, is left to a later change.
#include <cuda_runtime.h>

#include "field.cuh"

using namespace hk;

namespace {

constexpr int THREADS = 128;

struct Proj2 {
  Fe2 x, y, z;
};

__device__ __forceinline__ Fe2 mul_b3(const Fe2& a) { return f2_mul(a, f2_b3()); }

// RCB15 Algorithm 8 (a=0, Z2=1); the affine (0,0) sentinel keeps P
__device__ Proj2 pmadd_rcb(const Proj2& p, const Fe2& ax, const Fe2& ay) {
  Fe2 t0 = f2_mul(p.x, ax);
  Fe2 t1 = f2_mul(p.y, ay);
  Fe2 t3 = f2_mul(f2_add(ax, ay), f2_add(p.x, p.y));
  t3 = f2_sub(t3, f2_add(t0, t1));
  Fe2 t4 = f2_add(f2_mul(ay, p.z), p.y);
  Fe2 y3 = f2_add(f2_mul(ax, p.z), p.x);
  Fe2 x3 = f2_add(t0, t0);
  t0 = f2_add(x3, t0);
  Fe2 t2 = mul_b3(p.z);
  Fe2 z3 = f2_add(t1, t2);
  t1 = f2_sub(t1, t2);
  y3 = mul_b3(y3);
  Proj2 r;
  r.x = f2_sub(f2_mul(t3, t1), f2_mul(t4, y3));
  r.y = f2_add(f2_mul(t1, z3), f2_mul(y3, t0));
  r.z = f2_add(f2_mul(z3, t4), f2_mul(t0, t3));
  return f2_is_zero(ay) ? p : r;
}

// RCB15 Algorithm 7 (a=0)
__device__ Proj2 padd_rcb(const Proj2& p, const Proj2& q) {
  Fe2 t0 = f2_mul(p.x, q.x);
  Fe2 t1 = f2_mul(p.y, q.y);
  Fe2 t2 = f2_mul(p.z, q.z);
  Fe2 t3 = f2_mul(f2_add(p.x, p.y), f2_add(q.x, q.y));
  t3 = f2_sub(t3, f2_add(t0, t1));
  Fe2 t4 = f2_mul(f2_add(p.y, p.z), f2_add(q.y, q.z));
  t4 = f2_sub(t4, f2_add(t1, t2));
  Fe2 y3 = f2_mul(f2_add(p.x, p.z), f2_add(q.x, q.z));
  y3 = f2_sub(y3, f2_add(t0, t2));
  Fe2 x3 = f2_add(t0, t0);
  t0 = f2_add(x3, t0);
  t2 = mul_b3(t2);
  Fe2 z3 = f2_add(t1, t2);
  t1 = f2_sub(t1, t2);
  y3 = mul_b3(y3);
  Proj2 r;
  r.x = f2_sub(f2_mul(t3, t1), f2_mul(t4, y3));
  r.y = f2_add(f2_mul(t1, z3), f2_mul(y3, t0));
  r.z = f2_add(f2_mul(z3, t4), f2_mul(t0, t3));
  return r;
}

// RCB15 Algorithm 9 (a=0)
__device__ Proj2 pdbl_rcb(const Proj2& p) {
  Fe2 t0 = f2_sqr(p.y);
  Fe2 z3 = f2_add(t0, t0);
  z3 = f2_add(z3, z3);
  z3 = f2_add(z3, z3);
  Fe2 t1 = f2_mul(p.y, p.z);
  Fe2 t2 = mul_b3(f2_sqr(p.z));
  Fe2 x3 = f2_mul(t2, z3);
  Fe2 y3 = f2_add(t0, t2);
  z3 = f2_mul(t1, z3);
  t1 = f2_add(t2, t2);
  t2 = f2_add(t1, t2);
  t0 = f2_sub(t0, t2);
  y3 = f2_mul(t0, y3);
  y3 = f2_add(x3, y3);
  t1 = f2_mul(p.x, p.y);
  x3 = f2_mul(t0, t1);
  x3 = f2_add(x3, x3);
  return Proj2{x3, y3, z3};
}

__device__ __forceinline__ Proj2 load_proj2(const int32_t* x, const int32_t* y, const int32_t* z,
                                            long long i) {
  return Proj2{load_limbs2(x + i * 32), load_limbs2(y + i * 32), load_limbs2(z + i * 32)};
}

__device__ __forceinline__ void store_proj2(int32_t* x, int32_t* y, int32_t* z, long long i,
                                            const Proj2& p) {
  store_limbs2(x + i * 32, p.x);
  store_limbs2(y + i * 32, p.y);
  store_limbs2(z + i * 32, p.z);
}

__global__ void __launch_bounds__(THREADS)
    pmadd_rcb_g2_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                        const int32_t* __restrict__ z, const int32_t* __restrict__ ax,
                        const int32_t* __restrict__ ay, int32_t* __restrict__ ox,
                        int32_t* __restrict__ oy, int32_t* __restrict__ oz, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Proj2 r = pmadd_rcb(load_proj2(x, y, z, i), load_limbs2(ax + i * 32), load_limbs2(ay + i * 32));
  store_proj2(ox, oy, oz, i, r);
}

__global__ void __launch_bounds__(THREADS)
    padd_rcb_g2_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
                       const int32_t* __restrict__ z1, const int32_t* __restrict__ x2,
                       const int32_t* __restrict__ y2, const int32_t* __restrict__ z2,
                       int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                       int32_t* __restrict__ oz, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  store_proj2(ox, oy, oz, i, padd_rcb(load_proj2(x1, y1, z1, i), load_proj2(x2, y2, z2, i)));
}

__global__ void __launch_bounds__(THREADS)
    pdbl_rcb_g2_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                       const int32_t* __restrict__ z, int32_t* __restrict__ ox,
                       int32_t* __restrict__ oy, int32_t* __restrict__ oz, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  store_proj2(ox, oy, oz, i, pdbl_rcb(load_proj2(x, y, z, i)));
}

unsigned blocks_for(long long n) { return (unsigned)((n + THREADS - 1) / THREADS); }

}  // namespace

// n lanes of (2, 16) limb rows per coordinate; outputs must not alias inputs
extern "C" int hk_pmadd_rcb_g2(const void* x, const void* y, const void* z, const void* ax,
                               const void* ay, void* ox, void* oy, void* oz, long long n,
                               void* stream) {
  pmadd_rcb_g2_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)y, (const int32_t*)z, (const int32_t*)ax,
      (const int32_t*)ay, (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, n);
  return (int)cudaGetLastError();
}

extern "C" int hk_padd_rcb_g2(const void* x1, const void* y1, const void* z1, const void* x2,
                              const void* y2, const void* z2, void* ox, void* oy, void* oz,
                              long long n, void* stream) {
  padd_rcb_g2_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x1, (const int32_t*)y1, (const int32_t*)z1, (const int32_t*)x2,
      (const int32_t*)y2, (const int32_t*)z2, (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, n);
  return (int)cudaGetLastError();
}

extern "C" int hk_pdbl_rcb_g2(const void* x, const void* y, const void* z, void* ox, void* oy,
                              void* oz, long long n, void* stream) {
  pdbl_rcb_g2_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)y, (const int32_t*)z, (int32_t*)ox, (int32_t*)oy,
      (int32_t*)oz, n);
  return (int)cudaGetLastError();
}
