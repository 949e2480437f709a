// K1: union-tile scan with a fused per-tile minimum, for Hopper (sm_90a).
//
// Replaces the TPU kernel prefhetch_tpu/ops/pallas_scan.py
// _kernel_union_min / pallas_union_scan_min (:216-327). For every union
// tile u (tile id union[u]) and every query q:
//
//     d2[u, q, t] = max(qsq[q] + norms[tile, t] - 2 * <queries[q], payload[tile, t]>, 0)
//     d2[u, q, t] = PAD                    for t >= sizes[tile]
//     dmin[u, q]  = min_t d2[u, q, t]      (f32, taken before the bf16 cast)
//
// d2 is stored bf16, query-major [U, nq, T]; PAD = 3.4e38 rounds to +inf.
// The queries arrive already cast to the payload's type (bf16 or f32) and
// qsq comes from the f32 queries, as in the TPU kernel. Products accumulate
// in f32 (bf16 x bf16 products are exact in f32).
//
// What bounds it on an H100: HBM bytes. At the main-path shape (nq = 64,
// d = 128, T = 512, bf16 payload) each payload byte feeds 64 multiply-adds,
// about 64 flop/byte, far below the card's ridge of about 295 flop/byte.
// The design moves as few bytes as the function allows: one pass over each
// union tile's payload (one block owns a tile's whole T rows for its
// queries), no f32 distance matrix in device memory (the epilogue masks,
// takes the min and rounds to bf16 in registers), a bf16 store, and no
// second pass or atomics for the minimum (a running per-query min in
// registers, reduced across the block's lanes with shuffles at the end).
// Row chunks that lie wholly past the tile's size store PAD and skip the
// product; a size-0 tile (the reserved empty tile, repeated in the union's
// padding) stores PAD rows and a PAD min without touching its payload.
//
// This first version multiplies on the FP32 cores (a 4x4 register tile per
// thread out of shared memory), not the tensor cores; its time against the
// bound is recorded in PERF.md.
//
// Block: 256 threads as 16 (tx, rows) x 16 (ty, queries). Grid:
// (U, ceil(nq / QB)). Each block stages its QB queries and RB payload rows
// in shared memory as f32, KC features at a time, and computes a QB x RB
// block of distances; thread (tx, ty) owns queries ty*4 + i and rows
// tx + 16*j, so consecutive rows go to consecutive threads in the store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QB = 64;          // queries per block
constexpr int RB = 64;          // payload rows per chunk
constexpr int KC = 128;         // features per shared-memory stage
constexpr int KS = KC + 4;      // row stride in floats: conflict-free float4 reads
constexpr int THREADS = 256;
constexpr float PAD = 3.4e38f;  // ops/topk.py PAD_DISTANCE
constexpr size_t SMEM_BYTES = sizeof(float) * (QB + RB) * KS;
static_assert(QB == RB, "stage() stages RB rows, the query block's too");
static_assert(THREADS == 16 * (QB / 4) && RB == 16 * 4,
              "a 16 x 16 thread grid, each thread 4 queries x 4 rows");

// Eight consecutive elements (16-byte aligned) widened to f32.
__device__ __forceinline__ void load8(const __nv_bfloat16* src, float* dst) {
  uint4 v = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* src, float* dst) {
  float4 a = reinterpret_cast<const float4*>(src)[0];
  float4 b = reinterpret_cast<const float4*>(src)[1];
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
}

// Stage rows [row0, row0 + RB) x features [k0, k0 + kl) of a row-major
// [nrows, d] matrix into shared memory as f32 (zeros past nrows).
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, int nrows,
                                      int d, int row0, int k0, int kl,
                                      float* dst) {
  const int per_row = kl / 8;
  for (int e = threadIdx.x; e < RB * per_row; e += THREADS) {
    const int r = e / per_row;
    const int c = (e - r * per_row) * 8;
    float v[8];
    if (row0 + r < nrows) {
      load8(src + (size_t)(row0 + r) * d + k0 + c, v);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = 0.f;
    }
    float4* o = reinterpret_cast<float4*>(dst + r * KS + c);
    o[0] = make_float4(v[0], v[1], v[2], v[3]);
    o[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
union_scan_min_kernel(const T* __restrict__ payload,       // [ntiles+1, Tn, d]
                      const float* __restrict__ norms,     // [ntiles+1, Tn]
                      const int* __restrict__ sizes,       // [ntiles+1]
                      const T* __restrict__ queries,       // [nq, d]
                      const float* __restrict__ qsq,       // [nq]
                      const int* __restrict__ union_ids,   // [U]
                      int nq, int Tn, int d,
                      __nv_bfloat16* __restrict__ d2,      // [U, nq, Tn]
                      float* __restrict__ dmin) {          // [U, nq]
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;             // [QB][KS]
  float* x_s = smem + QB * KS;   // [RB][KS]

  const int u = blockIdx.x;
  const int q0 = blockIdx.y * QB;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int tile = union_ids[u];
  const int size = sizes[tile];
  const T* xt = payload + (size_t)tile * Tn * d;
  const float* nt = norms + (size_t)tile * Tn;
  __nv_bfloat16* out = d2 + (size_t)u * nq * Tn;
  const __nv_bfloat16 pad_b = __float2bfloat16_rn(PAD);  // +inf

  int qi[4];
  float qn[4];
  float run_min[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qi[i] = q0 + ty * 4 + i;
    qn[i] = qi[i] < nq ? qsq[qi[i]] : 0.f;
    run_min[i] = PAD;
  }

  const int nkc = (d + KC - 1) / KC;
  for (int r0 = 0; r0 < Tn; r0 += RB) {
    if (r0 >= size) {
      // every row of this chunk is past the tile's size: PAD, no product
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = r0 + tx + 16 * j;
        if (t >= Tn) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (qi[i] < nq) out[(size_t)qi[i] * Tn + t] = pad_b;
      }
      continue;  // size and r0 are block-uniform: no divergence at barriers
    }
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int kc = 0; kc < nkc; ++kc) {
      const int k0 = kc * KC;
      const int kl = min(KC, d - k0);
      // the query block stays resident across row chunks when d <= KC
      if (nkc > 1 || r0 == 0) stage(queries, nq, d, q0, k0, kl, q_s);
      stage(xt, Tn, d, r0, k0, kl, x_s);
      __syncthreads();
      for (int k = 0; k < kl; k += 4) {
        float4 a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = *reinterpret_cast<const float4*>(q_s + (ty * 4 + i) * KS + k);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          b[j] = *reinterpret_cast<const float4*>(x_s + (tx + 16 * j) * KS + k);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
            acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
            acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
            acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
          }
      }
      __syncthreads();
    }

    // epilogue: norms, clamp, mask, running min in f32, bf16 store
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = r0 + tx + 16 * j;
      if (t >= Tn) continue;
      const float nrm = nt[t];
      const bool valid = t < size;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float v = fmaxf(qn[i] + nrm - 2.f * acc[i][j], 0.f);
        v = valid ? v : PAD;
        run_min[i] = fminf(run_min[i], v);
        if (qi[i] < nq) out[(size_t)qi[i] * Tn + t] = __float2bfloat16_rn(v);
      }
    }
  }

  // per-query min across the 16 row lanes (tx) that share these queries;
  // a warp holds two ty rows of 16 lanes, so the xor stays within a row
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      run_min[i] = fminf(run_min[i],
                         __shfl_xor_sync(0xffffffffu, run_min[i], off));
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (qi[i] < nq) dmin[(size_t)u * nq + qi[i]] = run_min[i];
  }
}

template <typename T>
int launch(const void* payload, const float* norms, const int* sizes,
           const void* queries, const float* qsq, const int* union_ids,
           int U, int nq, int Tn, int d, void* d2, float* dmin,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      union_scan_min_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(U, (nq + QB - 1) / QB);
  union_scan_min_kernel<T><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const T*>(payload), norms, sizes,
      static_cast<const T*>(queries), qsq, union_ids, nq, Tn, d,
      static_cast<__nv_bfloat16*>(d2), dmin);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (bound with ctypes in ops/union_scan_min.py). Returns the
// cudaError_t of the launch; 0 = launched.
extern "C" int pfh_union_scan_min(const void* payload, int payload_bf16,
                                  const float* norms, const int* sizes,
                                  const void* queries, const float* qsq,
                                  const int* union_ids, int U, int nq, int Tn,
                                  int d, void* d2, float* dmin, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (payload_bf16)
    return launch<__nv_bfloat16>(payload, norms, sizes, queries, qsq,
                                 union_ids, U, nq, Tn, d, d2, dmin, s);
  return launch<float>(payload, norms, sizes, queries, qsq, union_ids, U, nq,
                       Tn, d, d2, dmin, s);
}
