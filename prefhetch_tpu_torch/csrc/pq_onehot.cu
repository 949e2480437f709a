// K3: the PQ-code scan over each query's own probed tiles, with the
// per-(query, list) scalar, the clamp and the mask fused, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel prefhetch_tpu/ops/pallas_scan.py _kernel_pq_onehot
// / pallas_pq_onehot_distances (:330-355, :358-421) together with the
// epilogue that prefhetch_tpu/ops/union_scan.py
// union_pq_scan_distances_pallas (:435-500) runs around it. For every query
// q, probe slot s (tile = tiles[q, s], L = tile_list[tile]) and lane t:
//
//     out[q, s*T + t] = max(cadd[q, L] + sum_m lut(q, L)[m*ksub + codes[tile, t, m]], 0)
//                                              for t < sizes[tile]
//     out[q, s*T + t] = PAD                    otherwise
//     lut(q, L)[i]    = bf16( lutq[q, i] + lutp[L, i] )
//
// lutq and lutp arrive as bf16; their sum is taken in f32 and rounded to
// bf16 (round to nearest even), as the TPU kernel's bf16 add does; the M
// terms are summed in f32.
//
// The TPU kernel scores every query against every tile of the batch's
// union (its matrix unit wants dense blocks and a TPU gathers badly), and
// the JAX stage then keeps each query's own slots: 6.6% of the pairs at the
// SIFT1M operating point. On the card a lookup costs per entry and a gather
// is cheap, so this kernel computes only the (query, probed slot) pairs and
// writes the stage's output [nq, max_t*T] directly: no partial-sum matrix in
// device memory, no second pass for the scalar, the clamp, the mask or the
// extraction.
//
// What bounds it on an H100: the code bytes (each distinct probed tile's
// valid rows, M bytes a row), the tables and the f32 output over HBM, and
// the lookups (nq * slots * T * M two-byte reads out of shared memory,
// random by code, so a warp's 32 reads meet bank conflicts). The design:
//   - a block owns one query and a run of SLOTS consecutive probe slots; a
//     probe's tiles are consecutive in tiles[q] and share a list, so the
//     combined table lut(q, L) (M*ksub bf16, 16 KB at 32 x 256) is staged
//     in shared memory once per list change, with the rounding done while
//     staging: the inner loop is one 2-byte lookup and one f32 add a term;
//   - a thread owns a lane t: its M code bytes come in 16-byte loads (byte
//     loads when M % 16 != 0), a warp reading 32*M contiguous bytes; it
//     adds cadd, clamps, masks and stores with consecutive threads on
//     consecutive t;
//   - slots of a size-0 tile (the empty tile that pads probe rows) and
//     lanes past a tile's size store PAD without lookups or code reads.
//
// Grid: (ceil(max_t / SLOTS), nq). 256 threads. Shared memory: 2 * M*ksub
// bytes (opted in above 48 KB).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int SLOTS = 8;        // probe slots per block
constexpr float PAD = 3.4e38f;  // ops/topk.py PAD_DISTANCE

// lut_s = bf16(lutq_row + lutp_row), MK entries.
__device__ __forceinline__ void stage_table(const __nv_bfloat16* __restrict__ lq,
                                            const __nv_bfloat16* __restrict__ lp,
                                            int MK, __nv_bfloat16* lut_s) {
  if ((MK & 7) == 0) {          // 8 entries a 16-byte load
    for (int i = threadIdx.x * 8; i < MK; i += THREADS * 8) {
      const uint4 a = *reinterpret_cast<const uint4*>(lq + i);
      const uint4 b = *reinterpret_cast<const uint4*>(lp + i);
      const __nv_bfloat162* ha = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* hb = reinterpret_cast<const __nv_bfloat162*>(&b);
      uint4 o;
      __nv_bfloat162* ho = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 fa = __bfloat1622float2(ha[k]);
        const float2 fb = __bfloat1622float2(hb[k]);
        ho[k] = __floats2bfloat162_rn(fa.x + fb.x, fa.y + fb.y);
      }
      *reinterpret_cast<uint4*>(lut_s + i) = o;
    }
  } else {
    for (int i = threadIdx.x; i < MK; i += THREADS)
      lut_s[i] = __float2bfloat16_rn(__bfloat162float(lq[i]) +
                                     __bfloat162float(lp[i]));
  }
}

__global__ void __launch_bounds__(THREADS)
pq_probed_kernel(const uint8_t* __restrict__ codes,        // [ntiles+1, Tn, M]
                 const __nv_bfloat16* __restrict__ lutq,   // [nq, MK]
                 const __nv_bfloat16* __restrict__ lutp,   // [nlist, MK]
                 const float* __restrict__ cadd,           // [nq, nlist]
                 const int* __restrict__ sizes,            // [ntiles+1]
                 const int* __restrict__ tile_list,        // [ntiles+1]
                 const int* __restrict__ tiles,            // [nq, max_t]
                 int max_t, int Tn, int M, int ksub, int nlist,
                 float* __restrict__ out) {                // [nq, max_t*Tn]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* lut_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [MK]
  const int MK = M * ksub;
  const int q = blockIdx.y;
  const int s0 = blockIdx.x * SLOTS;
  const int s1 = min(s0 + SLOTS, max_t);
  const int* tq = tiles + (size_t)q * max_t;
  float* oq = out + (size_t)q * max_t * Tn;

  int cur_list = -1;
  for (int s = s0; s < s1; ++s) {
    const int tile = tq[s];
    const int size = sizes[tile];
    float* o = oq + (size_t)s * Tn;
    if (size == 0) {            // block-uniform: no lookups, no table
      for (int t = threadIdx.x; t < Tn; t += THREADS) o[t] = PAD;
      continue;
    }
    const int list = tile_list[tile];
    if (list != cur_list) {     // block-uniform
      __syncthreads();          // every lane is done with the old table
      stage_table(lutq + (size_t)q * MK, lutp + (size_t)list * MK, MK, lut_s);
      cur_list = list;
      __syncthreads();
    }
    const float c = cadd[(size_t)q * nlist + list];
    const uint8_t* ct = codes + (size_t)tile * Tn * M;
    for (int t = threadIdx.x; t < Tn; t += THREADS) {
      if (t >= size) {
        o[t] = PAD;
        continue;
      }
      const uint8_t* cr = ct + (size_t)t * M;
      float acc = 0.f;
      if ((M & 15) == 0) {      // 16 codes a load
        for (int m0 = 0; m0 < M; m0 += 16) {
          const uint4 raw = *reinterpret_cast<const uint4*>(cr + m0);
          const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
          const __nv_bfloat16* lm = lut_s + m0 * ksub;
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int k = 0; k < 4; ++k)
              acc += __bfloat162float(
                  lm[(4 * i + k) * ksub + ((w[i] >> (8 * k)) & 0xffu)]);
        }
      } else {
        for (int m = 0; m < M; ++m)
          acc += __bfloat162float(lut_s[m * ksub + cr[m]]);
      }
      o[t] = fmaxf(c + acc, 0.f);
    }
  }
}

}  // namespace

// C interface (bound with ctypes in ops/pq_onehot.py). Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int pfh_pq_probed(const void* codes, const void* lutq,
                             const void* lutp, const float* cadd,
                             const int* sizes, const int* tile_list,
                             const int* tiles, int nq, int max_t, int Tn,
                             int M, int ksub, int nlist, float* out,
                             void* stream) {
  const size_t smem = (size_t)M * ksub * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      pq_probed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((max_t + SLOTS - 1) / SLOTS, nq);
  pq_probed_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes),
      static_cast<const __nv_bfloat16*>(lutq),
      static_cast<const __nv_bfloat16*>(lutp), cadd, sizes, tile_list, tiles,
      max_t, Tn, M, ksub, nlist, out);
  return (int)cudaGetLastError();
}
