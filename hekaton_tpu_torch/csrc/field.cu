// Field kernels: batched Montgomery multiply and batched Fermat inversion.
//
// mont_mul replaces fields/pallas_field.py::mont_mul_pallas (_kernel, :40);
// fermat_inv replaces fields/pallas_field.py::fermat_inv_pallas
// (_fermat_kernel, :187). One thread owns one lane and runs the 8-word CIOS
// loop (field.cuh) in registers.
//
// What bounds them on an H100: mont_mul moves 192 bytes per lane (two
// (n, 16) int32 limb rows in, one out: half of every word is the zero upper
// 16 bits of a limb) for ~300 integer multiply-adds, so at full occupancy it
// is bound by bytes, not by the integer pipes. The design keeps the
// framework's (n, 16) limb layout at the boundary so that callers need no
// relayout; a packed 32-byte layout would halve the bytes and is left to a
// later change. Measured on one H100 80GB HBM3 (700 W): 0.215 ms at 2^20
// lanes, ~0.94 TB/s, a quarter of the card's bytes bound, so the strided
// 64-byte row per thread still costs more than the bytes themselves.
// fermat_inv does ~380 dependent products per lane on 32 bytes; it only
// ever sees the <= 1024 roots of a batch_inv tree, so it is bound by the
// latency of that chain, not by throughput: one thread per root, one launch,
// ~0.35 ms per call on the same card.
#include <cuda_runtime.h>

#include "field.cuh"

using namespace hk;

namespace {

constexpr int THREADS = 256;

template <int F>
__global__ void mont_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                                int32_t* __restrict__ out, long long n, long long nb) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe x = load_limbs(a + i * 16);
  Fe y = load_limbs(b + (i % nb) * 16);
  store_limbs(out + i * 16, fe_mul<F>(x, y));
}

template <int F>
__global__ void fermat_inv_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out,
                                  long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  store_limbs(out + i * 16, fe_inv<F>(load_limbs(a + i * 16)));
}

unsigned blocks_for(long long n) { return (unsigned)((n + THREADS - 1) / THREADS); }

}  // namespace

// out[i] = a[i] * b[i % nb] * R^-1 mod p over n lanes of 16 limbs
extern "C" int hk_mont_mul(int field, const void* a, const void* b, void* out, long long n,
                           long long nb, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  auto pa = (const int32_t*)a;
  auto pb = (const int32_t*)b;
  auto po = (int32_t*)out;
  if (field == FQ)
    mont_mul_kernel<FQ><<<blocks_for(n), THREADS, 0, s>>>(pa, pb, po, n, nb);
  else
    mont_mul_kernel<FR><<<blocks_for(n), THREADS, 0, s>>>(pa, pb, po, n, nb);
  return (int)cudaGetLastError();
}

// out[i] = a[i]^(p-2) (Montgomery form; inv(0) = 0) over n lanes
extern "C" int hk_fermat_inv(int field, const void* a, void* out, long long n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (field == FQ)
    fermat_inv_kernel<FQ><<<blocks_for(n), THREADS, 0, s>>>((const int32_t*)a, (int32_t*)out, n);
  else
    fermat_inv_kernel<FR><<<blocks_for(n), THREADS, 0, s>>>((const int32_t*)a, (int32_t*)out, n);
  return (int)cudaGetLastError();
}
