// Field kernels: batched Montgomery multiply and batched Fermat inversion.
//
// mont_mul replaces fields/pallas_field.py::mont_mul_pallas (_kernel, :40);
// fermat_inv replaces fields/pallas_field.py::fermat_inv_pallas
// (_fermat_kernel, :187). Both Pallas builders are generic in the limb
// count; here each kernel is a template on the field (field.cuh::Field),
// instantiated for BN254 Fq and Fr (8 words, 16 limbs) and for BLS12-381 Fq
// (12 words, 24 limbs). One thread owns one lane and runs the NW-word CIOS
// loop (field.cuh) in registers.
//
// What bounds them on an H100: mont_mul moves 12 NW bytes per lane in
// each of its three (n, 2 NW) int32 limb rows (half of every word is the zero
// upper 16 bits of a limb): 192 B per product at 8 words for ~264 32-bit
// multiplies, 288 B at 12 words for ~588, so at full occupancy it is bound
// by bytes, not by the integer pipes. The design keeps the framework's limb
// layout at the boundary so that callers need no relayout; a packed layout
// would halve the bytes and is left to a later change. Measured on one H100
// 80GB HBM3 (700 W): 0.215 ms at 2^20 BN254 lanes, ~0.94 TB/s, a quarter of
// the card's bytes bound, so the strided row per thread still costs more
// than the bytes themselves. fermat_inv does 362-379 (BN254) or 608
// (BLS12-381) dependent products per lane on 4 NW bytes in and out; on the
// main paths it sees the <= 1024 roots of a batch_inv tree, so it is bound
// by the latency of that chain, not by throughput: one thread per root,
// one launch, ~0.35 ms per BN254 call on the same card.
#include <cuda_runtime.h>

#include "field.cuh"

using namespace hk;

namespace {

constexpr int THREADS = 256;

template <int F>
__global__ void mont_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                                int32_t* __restrict__ out, long long n, long long nb) {
  constexpr int NW = Field<F>::NW;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  FeF<F> x = load_limbs<NW>(a + i * 2 * NW);
  FeF<F> y = load_limbs<NW>(b + (i % nb) * 2 * NW);
  store_limbs(out + i * 2 * NW, fe_mul<F>(x, y));
}

template <int F>
__global__ void fermat_inv_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out,
                                  long long n) {
  constexpr int NW = Field<F>::NW;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  store_limbs(out + i * 2 * NW, fe_inv<F>(load_limbs<NW>(a + i * 2 * NW)));
}

unsigned blocks_for(long long n) { return (unsigned)((n + THREADS - 1) / THREADS); }

}  // namespace

// out[i] = a[i] * b[i % nb] * R^-1 mod p over n lanes of 2 NW limbs; an
// unknown field id launches nothing and returns cudaErrorInvalidValue
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

// out[i] = a[i]^(p-2) (Montgomery form; inv(0) = 0) over n lanes; an
// unknown field id launches nothing and returns cudaErrorInvalidValue
extern "C" int hk_fermat_inv(int field, const void* a, void* out, long long n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  auto pa = (const int32_t*)a;
  auto po = (int32_t*)out;
  switch (field) {
    case FQ:
      fermat_inv_kernel<FQ><<<blocks_for(n), THREADS, 0, s>>>(pa, po, n);
      break;
    case FR:
      fermat_inv_kernel<FR><<<blocks_for(n), THREADS, 0, s>>>(pa, po, n);
      break;
    case FQ_BLS:
      fermat_inv_kernel<FQ_BLS><<<blocks_for(n), THREADS, 0, s>>>(pa, po, n);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
