// K2: one stage of the four-step negacyclic NTT, for Hopper (sm_90a).
//
// Replaces the TPU kernel prefhetch_tpu/ops/ntt_pallas.py _run_step /
// _make_kernel (:169-287). For every polynomial b of the batch, with its
// N = r*m residues viewed as [r, m]:
//
//     v[b, i, j]   = (sum_k x[b, i, k] * W[k, j]) mod q
//     out[b, i, j] = v * tw[i, j] mod q            when twiddles are given
//
// x is int32 (any value; it is reduced to its residue in [0, q) on load), W
// and tw are residues in [0, q) as uint32, tw_shoup[i, j] = floor(tw * 2^32 /
// q). The output is int32, congruent to the formula, in [0, q) when
// `canonical` and in [0, 2q) (below 2^31) otherwise. q is a prime just below
// 2^30 with delta = 2^30 - q < 2^20 (crypto/params.find_ntt_primes).
//
// The TPU kernel splits x and W into four balanced int8 digits and runs 16
// int8 matrix-unit products with a Shoup recombination, because its matrix
// unit multiplies nothing wider. This card multiplies 32 x 32 -> 64 bits in
// one instruction, so the product is taken directly:
//
//   * a product of two residues is below 2^60; eight of them are added into a
//     uint64 (the running value stays below 2^55 + 2^63 < 2^64), then one
//     fold a -> (a & (2^30-1)) + (a >> 30) * delta brings it back below 2^55
//     (2^30 = delta mod q, so the fold keeps the residue);
//   * four folds take any uint64 below 2^30 + 2^27 < 2q;
//   * the twiddle is a Shoup multiply: h = umulhi(v, tw_shoup) differs from
//     floor(v * tw / q) by at most 1 for v < 2^32, so v*tw - h*q, computed in
//     wrapping uint32, lies in [0, 2q);
//   * one conditional subtraction canonicalises.
//
// What bounds it on an H100: at the request's shape (512 polynomials of
// 64 x 64) the function reads and writes 16.8 MB (about 5 us at 3.35 TB/s)
// and does 1.34e8 multiply-adds; on the 32-bit integer pipe with operands
// out of shared memory that is several times the byte time, so this first
// version is bound by integer operations and shared-memory reads, not by
// bytes. The design keeps both low without tensor cores: one block owns one
// polynomial, W and the polynomial sit in shared memory for the whole block
// (each global byte is read once), every thread keeps 4 rows of one output
// column in registers so that a W element read from shared memory feeds 4
// multiply-adds, and the 4 x-values of a row arrive as one 16-byte broadcast
// read. An int8 tensor-core form (mma.sync s8 on digit planes, the TPU
// kernel's own route) is a later step; times are in PERF.md.
//
// Block: 256 threads; thread t owns output column j = t % M of rows
// t / M + (256 / M) * i. Grid: one block per polynomial. Dynamic shared
// memory: W [M, M] then x [r, M], uint32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 4;                       // rows per thread per pass
constexpr uint64_t M30 = (1ull << 30) - 1;

__device__ __forceinline__ uint64_t fold30(uint64_t a, uint64_t delta) {
  return (a & M30) + (a >> 30) * delta;
}

template <int M>
__global__ void __launch_bounds__(THREADS)
ntt4_step_kernel(const int* __restrict__ x, const uint32_t* __restrict__ w,
                 const uint32_t* __restrict__ tw,
                 const uint32_t* __restrict__ tw_shoup, int* __restrict__ out,
                 int r, uint32_t q, int canonical) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* ws = smem;                        // [M][M]
  uint32_t* xs = smem + M * M;                // [r][M]
  const int tid = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * r * M;
  const uint64_t delta = (1u << 30) - q;

  for (int i = tid; i < M * M; i += THREADS) ws[i] = w[i];
  const int sq = (int)q;
  for (int i = tid; i < r * M; i += THREADS) {
    int v = x[base + i] % sq;                 // any int32 -> (-q, q)
    if (v < 0) v += sq;
    xs[i] = (uint32_t)v;
  }
  __syncthreads();

  constexpr int G = THREADS / M;              // row groups
  const int j = tid % M;
  const int g = tid / M;
  for (int row0 = g; row0 < r; row0 += G * ROWS) {
    int row[ROWS];
    const uint32_t* xrow[ROWS];
    uint64_t acc[ROWS];
#pragma unroll
    for (int t = 0; t < ROWS; ++t) {
      row[t] = row0 + t * G;
      // rows past r are computed on a clamped row and never stored
      xrow[t] = xs + (size_t)(row[t] < r ? row[t] : r - 1) * M;
      acc[t] = 0;
    }
    for (int k0 = 0; k0 < M; k0 += 8) {
#pragma unroll
      for (int kk = 0; kk < 8; kk += 4) {
        const int k = k0 + kk;
        const uint32_t w0 = ws[(k + 0) * M + j];
        const uint32_t w1 = ws[(k + 1) * M + j];
        const uint32_t w2 = ws[(k + 2) * M + j];
        const uint32_t w3 = ws[(k + 3) * M + j];
#pragma unroll
        for (int t = 0; t < ROWS; ++t) {
          const uint4 xv = *reinterpret_cast<const uint4*>(xrow[t] + k);
          acc[t] += (uint64_t)xv.x * w0;
          acc[t] += (uint64_t)xv.y * w1;
          acc[t] += (uint64_t)xv.z * w2;
          acc[t] += (uint64_t)xv.w * w3;
        }
      }
#pragma unroll
      for (int t = 0; t < ROWS; ++t) acc[t] = fold30(acc[t], delta);
    }
#pragma unroll
    for (int t = 0; t < ROWS; ++t) {
      if (row[t] >= r) continue;
      uint64_t a = acc[t];
      a = fold30(fold30(fold30(fold30(a, delta), delta), delta), delta);
      uint32_t v = (uint32_t)a;               // < 2^30 + 2^27 < 2q
      const size_t o = (size_t)row[t] * M + j;
      if (tw != nullptr) {
        const uint32_t h = __umulhi(v, tw_shoup[o]);
        v = v * tw[o] - h * q;                // wrapping u32, in [0, 2q)
      }
      if (canonical && v >= q) v -= q;
      out[base + o] = (int)v;
    }
  }
}

template <int M>
int launch(const int* x, const uint32_t* w, const uint32_t* tw,
           const uint32_t* tw_shoup, int* out, int B, int r, uint32_t q,
           int canonical, cudaStream_t stream) {
  const size_t smem = sizeof(uint32_t) * ((size_t)M * M + (size_t)r * M);
  cudaError_t err = cudaFuncSetAttribute(
      ntt4_step_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ntt4_step_kernel<M><<<B, THREADS, smem, stream>>>(x, w, tw, tw_shoup, out,
                                                     r, q, canonical);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (bound with ctypes in ops/ntt4_step.py). tw and tw_shoup are
// both null for a stage without twiddles. Returns the cudaError_t of the
// launch; 0 = launched.
extern "C" int pfh_ntt4_step(const void* x, const void* w, const void* tw,
                             const void* tw_shoup, void* out, int B, int r,
                             int m, unsigned int q, int canonical,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* xi = static_cast<const int*>(x);
  const uint32_t* wi = static_cast<const uint32_t*>(w);
  const uint32_t* ti = static_cast<const uint32_t*>(tw);
  const uint32_t* si = static_cast<const uint32_t*>(tw_shoup);
  int* oi = static_cast<int*>(out);
  switch (m) {
    case 64:
      return launch<64>(xi, wi, ti, si, oi, B, r, q, canonical, s);
    case 128:
      return launch<128>(xi, wi, ti, si, oi, B, r, q, canonical, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
