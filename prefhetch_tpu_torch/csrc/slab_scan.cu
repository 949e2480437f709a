// K5 and K4: per (query, probed tile) slab distances, for Hopper (sm_90a).
//
// K5 replaces the TPU kernel prefhetch_tpu/ops/pallas_scan.py _kernel /
// pallas_slab_distances (:29-58, :161-213); K4 replaces _kernel_sq8 /
// pallas_slab_distances_sq8 (:61-97, :100-158). For every flat pair
// b = (query qi, probe slot), tile = probe_ids[b], size = sizes[tile]:
//
//     out[b, t] = max(|q|^2 + norms[tile, t] - 2 * cross[t], 0)   t <  size
//     out[b, t] = PAD                                             t >= size
//
//     K5: cross[t] = <payload[tile, t], q>           payload bf16 or f32,
//                                                    widened to f32
//     K4: cross[t] = <code[tile, t] + 1/2, scale*q> + <vmin, q>
//                                                    codes uint8 (SQ8)
//
// Unlike K1 the query is NOT cast to the payload's type: it stays f32, and
// |q|^2 is computed here from it. K4 keeps the TPU kernel's folded affine
// form (not decode-then-dot), so its rounding stays close to the TPU's. A
// size-0 tile (the reserved empty tile that pads probe expansions) writes
// PAD and never reads its payload.
//
// What bounds it on an H100: bytes. Each payload element feeds one
// multiply-add (a [T, d] x [d] matvec), far below the card's ridge. The TPU
// kernel's scalar prefetch is just an index read here: the block of pair b
// reads probe_ids[b] and sizes[tile] and goes to that tile. The design reads
// each valid row once with 16-byte loads (8 bf16, 4 f32 or 16 uint8 values a
// lane), G = d/values-per-load lanes side by side on one row (rounded up to
// a power of two, at most a warp), reduces the row's partial sums with
// shuffles, skips rows past the tile's size, keeps the query in shared
// memory, and stages the block's T results in shared memory so the store is
// one coalesced pass that also reads the norms coalesced. Tiles probed by
// several queries are re-read once per query; the L2 takes most of that.
//
// Grid: one block of 256 threads per pair. Any T, any nq, d a multiple of 8
// (16 for uint8); the wrapper (ops/slab_scan.py) refuses the rest.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float PAD = 3.4e38f;  // ops/topk.py PAD_DISTANCE

// One 16-byte load widened to f32; VEC = values per load.
template <typename T> struct Load16;

template <> struct Load16<__nv_bfloat16> {
  static constexpr int VEC = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

template <> struct Load16<float> {
  static constexpr int VEC = 4;
  static __device__ __forceinline__ void load(const float* p, float* v) {
    float4 raw = *reinterpret_cast<const float4*>(p);
    v[0] = raw.x; v[1] = raw.y; v[2] = raw.z; v[3] = raw.w;
  }
};

// SQ8 codes: the value that enters the product is code + 1/2.
template <> struct Load16<uint8_t> {
  static constexpr int VEC = 16;
  static __device__ __forceinline__ void load(const uint8_t* p, float* v) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[4 * i + j] = (float)((w[i] >> (8 * j)) & 0xffu) + 0.5f;
  }
};

// Sum of v over the block, returned to every thread. red: [WARPS] floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();  // red may still be read from an earlier call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += red[w];
  return s;
}

// The shared body of K5 (SQ8 = false) and K4 (SQ8 = true).
template <typename T, bool SQ8>
__global__ void __launch_bounds__(THREADS)
slab_kernel(const T* __restrict__ payload,       // [ntiles+1, Tn, d]
            const float* __restrict__ norms,     // [ntiles+1, Tn]
            const int* __restrict__ sizes,       // [ntiles+1]
            const float* __restrict__ vmin,      // [d]  (K4 only)
            const float* __restrict__ scale,     // [d]  (K4 only)
            const float* __restrict__ queries,   // [nq, d]
            const int* __restrict__ probe_ids,   // [nq * max_t]
            int max_t, int Tn, int d, int G,
            float* __restrict__ out) {           // [nq * max_t, Tn]
  constexpr int VEC = Load16<T>::VEC;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;            // [d]: q (K5) or scale * q (K4)
  float* red = smem + d;        // [WARPS]
  float* cross_s = red + WARPS; // [Tn]

  const int b = blockIdx.x;
  const int tile = probe_ids[b];
  const int size = min(sizes[tile], Tn);
  float* o = out + (size_t)b * Tn;
  if (size <= 0) {              // block-uniform: the empty tile, no payload read
    for (int t = threadIdx.x; t < Tn; t += THREADS) o[t] = PAD;
    return;
  }

  // the query row: |q|^2 (and <vmin, q>) from the f32 query
  const float* q = queries + (size_t)(b / max_t) * d;
  float p_qsq = 0.f, p_vq = 0.f;
  for (int k = threadIdx.x; k < d; k += THREADS) {
    const float qk = q[k];
    p_qsq = fmaf(qk, qk, p_qsq);
    if (SQ8) {
      p_vq = fmaf(vmin[k], qk, p_vq);
      q_s[k] = qk * scale[k];
    } else {
      q_s[k] = qk;
    }
  }
  const float qsq = block_sum(p_qsq, red);
  const float vq = SQ8 ? block_sum(p_vq, red) : 0.f;
  __syncthreads();              // q_s is complete

  // rows: G lanes side by side on a row, 32 / G rows a warp at a time
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane % G;
  const int rows_per_warp = 32 / G;
  const int chunks = d / VEC;
  const T* xt = payload + (size_t)tile * Tn * d;
  for (int r0 = warp * rows_per_warp; r0 < size; r0 += WARPS * rows_per_warp) {
    const int t = r0 + lane / G;
    const bool active = t < size;  // the whole warp stays for the shuffles
    float acc = 0.f;
    if (active) {
      const T* row = xt + (size_t)t * d;
      for (int c = sub; c < chunks; c += G) {
        float x[VEC];
        Load16<T>::load(row + c * VEC, x);
        const float4* qv = reinterpret_cast<const float4*>(q_s + c * VEC);
#pragma unroll
        for (int i = 0; i < VEC / 4; ++i) {
          const float4 qq = qv[i];
          acc = fmaf(x[4 * i], qq.x, acc);
          acc = fmaf(x[4 * i + 1], qq.y, acc);
          acc = fmaf(x[4 * i + 2], qq.z, acc);
          acc = fmaf(x[4 * i + 3], qq.w, acc);
        }
      }
    }
    for (int off = G >> 1; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (active && sub == 0) cross_s[t] = acc + vq;
  }
  __syncthreads();

  // epilogue: norms, clamp, mask; one coalesced store of the T lanes
  const float* nt = norms + (size_t)tile * Tn;
  for (int t = threadIdx.x; t < Tn; t += THREADS) {
    float v = PAD;
    if (t < size) v = fmaxf(qsq + nt[t] - 2.f * cross_s[t], 0.f);
    o[t] = v;
  }
}

template <typename T, bool SQ8>
int launch(const void* payload, const float* norms, const int* sizes,
           const float* vmin, const float* scale, const float* queries,
           const int* probe_ids, int nq, int max_t, int Tn, int d,
           float* out, cudaStream_t stream) {
  constexpr int VEC = Load16<T>::VEC;
  const int chunks = d / VEC;
  int G = 1;
  while (G < chunks && G < 32) G <<= 1;
  const size_t smem = sizeof(float) * ((size_t)d + WARPS + Tn);
  cudaError_t err = cudaFuncSetAttribute(
      slab_kernel<T, SQ8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  slab_kernel<T, SQ8><<<nq * max_t, THREADS, smem, stream>>>(
      static_cast<const T*>(payload), norms, sizes, vmin, scale, queries,
      probe_ids, max_t, Tn, d, G, out);
  return (int)cudaGetLastError();
}

}  // namespace

// C interfaces (bound with ctypes in ops/slab_scan.py). Each returns the
// cudaError_t of the launch; 0 = launched.

// K5: dense payload, bf16 (payload_bf16 != 0) or f32.
extern "C" int pfh_slab_distances(const void* payload, int payload_bf16,
                                  const float* norms, const int* sizes,
                                  const float* queries, const int* probe_ids,
                                  int nq, int max_t, int Tn, int d, float* out,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (payload_bf16)
    return launch<__nv_bfloat16, false>(payload, norms, sizes, nullptr,
                                        nullptr, queries, probe_ids, nq,
                                        max_t, Tn, d, out, s);
  return launch<float, false>(payload, norms, sizes, nullptr, nullptr,
                              queries, probe_ids, nq, max_t, Tn, d, out, s);
}

// K4: uint8 SQ8 codes with the per-dimension affine (vmin, scale).
extern "C" int pfh_slab_distances_sq8(const void* codes, const float* norms,
                                      const int* sizes, const float* vmin,
                                      const float* scale, const float* queries,
                                      const int* probe_ids, int nq, int max_t,
                                      int Tn, int d, float* out, void* stream) {
  return launch<uint8_t, true>(codes, norms, sizes, vmin, scale, queries,
                               probe_ids, nq, max_t, Tn, d, out,
                               static_cast<cudaStream_t>(stream));
}
