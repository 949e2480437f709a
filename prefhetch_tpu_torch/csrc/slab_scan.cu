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
// What bounds both on an H100: bytes. Each payload element feeds one
// multiply-add per query that probes its tile, far below the card's ridge.
//
// K5 (slab_kernel): one block of 256 threads per pair. The TPU kernel's
// scalar prefetch is just an index read here: the block of pair b reads
// probe_ids[b] and sizes[tile] and goes to that tile. It reads each valid
// row with 16-byte loads (8 bf16 or 4 f32 values a lane), G = d/values-per-
// load lanes side by side on one row (rounded up to a power of two, at most
// a warp), reduces the row's partial sums with shuffles, skips rows past
// the tile's size, keeps the query in shared memory, and stages the block's
// T results in shared memory so the store is one coalesced pass that also
// reads the norms coalesced. Tiles probed by several queries are re-read
// once per query; the L2 takes most of that. Any T, any nq, d a multiple
// of 8.
//
// K4 (sq8_tiled_kernel): tile-major. One pair per block would read a tile
// once for every query that probes it and convert every code byte to f32
// again each time, and those conversions, not the bytes, set its time. So
// the wrapper sorts the flat pairs by tile id (ops/slab_scan.sq8_schedule,
// a stable torch.sort on the device) and a block takes CHUNK consecutive
// sorted pairs: the pairs of a chunk that share a tile share one read and
// one decode of it (a tile whose run of pairs crosses a chunk boundary is
// read once per chunk; the long run of the empty tile only writes PAD).
// The block stages its pairs' scale*q, |q|^2 and <vmin, q> in shared
// memory; from then on each warp works alone, with no block barrier: it
// takes 8 rows of the tile every 64 and streams them through its own
// cp.async ring; 16 lanes share a row (8 codes a lane, one 8-byte read)
// and a lane takes 4 rows; a code is decoded once, by byte permute into an
// f32 mantissa (2^23 + code) and one subtraction (2^23 - 1/2), giving
// code + 1/2 exactly, and feeds one FMA for each pair of the run (4 pairs'
// sums live at a time); the 16 lanes' sums of 4 rows x 4 pairs are reduced
// by halving exchanges (a step sends half of the values and keeps the
// other half: 15 shuffles, not 4 per value); and the lane that ends with a
// row's sum finishes it (norms, clamp) and stores it, 32 contiguous bytes
// a pair a step. Rows past the size get PAD from the whole block. d a
// multiple of 16.

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

// K5's body, bf16 or f32 payload.
template <typename T>
__global__ void __launch_bounds__(THREADS)
slab_kernel(const T* __restrict__ payload,       // [ntiles+1, Tn, d]
            const float* __restrict__ norms,     // [ntiles+1, Tn]
            const int* __restrict__ sizes,       // [ntiles+1]
            const float* __restrict__ queries,   // [nq, d]
            const int* __restrict__ probe_ids,   // [nq * max_t]
            int max_t, int Tn, int d, int G,
            float* __restrict__ out) {           // [nq * max_t, Tn]
  constexpr int VEC = Load16<T>::VEC;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;            // [d]: q
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

  // the query row and |q|^2 from the f32 query
  const float* q = queries + (size_t)(b / max_t) * d;
  float p_qsq = 0.f;
  for (int k = threadIdx.x; k < d; k += THREADS) {
    const float qk = q[k];
    p_qsq = fmaf(qk, qk, p_qsq);
    q_s[k] = qk;
  }
  const float qsq = block_sum(p_qsq, red);
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
    if (active && sub == 0) cross_s[t] = acc;
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

template <typename T>
int launch(const void* payload, const float* norms, const int* sizes,
           const float* queries, const int* probe_ids, int nq, int max_t,
           int Tn, int d, float* out, cudaStream_t stream) {
  constexpr int VEC = Load16<T>::VEC;
  const int chunks = d / VEC;
  int G = 1;
  while (G < chunks && G < 32) G <<= 1;
  const size_t smem = sizeof(float) * ((size_t)d + WARPS + Tn);
  cudaError_t err = cudaFuncSetAttribute(
      slab_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  slab_kernel<T><<<nq * max_t, THREADS, smem, stream>>>(
      static_cast<const T*>(payload), norms, sizes, queries, probe_ids,
      max_t, Tn, d, G, out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K4

constexpr int CHUNK = 4;       // sorted pairs a block (ops/slab_scan.SQ8_CHUNK)
constexpr int LANES = 16;      // lanes that share a row
constexpr int RPL = 4;         // rows a lane takes at once
constexpr int WROWS = (32 / LANES) * RPL;   // rows a warp takes a step (8)
constexpr int ROWS_STEP = WARPS * WROWS;    // rows the block takes a step
constexpr int NST = 4;         // stages of a warp's cp.async ring
constexpr int GROUP = 4;       // pairs whose sums are live at once

// code + 1/2 of byte k of w, exactly: the float 2^23 + code, minus 2^23 - 1/2
__device__ __forceinline__ float decode(uint32_t w, int k) {
  return __int_as_float(__byte_perm(w, 0x4B000000u, 0x7440 + k))
         - 8388607.5f;
}

// One halving exchange of the reduction over a half-warp's 16 lanes: with
// SPAN > 1 values, the lane keeps the half that its bit `o` selects and
// adds the partner's copy of that half; with one value left, a plain sum.
template <int SPAN>
__device__ __forceinline__ void halve(float* v, int lane, int o, int& idx) {
  if constexpr (SPAN > 1) {
    const bool hi = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < SPAN / 2; ++i) {
      const float keep = hi ? v[i + SPAN / 2] : v[i];
      const float send = hi ? v[i] : v[i + SPAN / 2];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
    if (hi) idx += SPAN / 2;
  } else {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::
               "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::
               "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src));
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// NP pairs (NP <= GROUP) against a warp step's rows in a ring stage: each
// lane decodes its 8 codes (a round of 8 x 16 lanes per 128 dimensions) of
// its RPL rows once and sums them for every pair, then the half-warp's 16
// lanes reduce by halving exchanges. Returns the sum this lane ends with,
// of its half-warp's row idx / NPP and pair idx % NPP; lanes that differ
// only in the low 4 - HALVINGS bits hold copies.
template <int NP>
__device__ __forceinline__ float sq8_group(const uint8_t* rows,
                                           const float* qs, int d,
                                           int chunks, int rounds, int lane,
                                           int& idx) {
  constexpr int NPP = NP <= 1 ? 1 : NP <= 2 ? 2 : 4;
  constexpr int V = RPL * NPP;            // values a lane reduces: [row][pair]
  constexpr int S1 = V > 1 ? V / 2 : 1;    // values left after each halving
  constexpr int S2 = S1 > 1 ? S1 / 2 : 1;
  constexpr int S3 = S2 > 1 ? S2 / 2 : 1;
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
  for (int k = 0; k < rounds; ++k) {
    const int c = (lane & (LANES - 1)) + k * LANES;
    if (c >= chunks) continue;
    float x[RPL][8];
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      const uint2 w = *reinterpret_cast<const uint2*>(rows + i * d + c * 8);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[i][e] = decode(w.x, e);
        x[i][4 + e] = decode(w.y, e);
      }
    }
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const float4 qa = *reinterpret_cast<const float4*>(qs + j * d + c * 8);
      const float4 qb =
          *reinterpret_cast<const float4*>(qs + j * d + c * 8 + 4);
      const float q8[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
      for (int i = 0; i < RPL; ++i)
#pragma unroll
        for (int k = 0; k < 8; ++k)
          acc[i * NPP + j] = fmaf(x[i][k], q8[k], acc[i * NPP + j]);
    }
  }
  idx = 0;                                 // bits 3, 2, 1, 0 of the lane
  halve<V>(acc, lane, 8, idx);
  halve<S1>(acc, lane, 4, idx);
  halve<S2>(acc, lane, 2, idx);
  halve<S3>(acc, lane, 1, idx);
  return acc[0];
}

// The distance of the sum a lane ends with (pair j of the run, row t of
// the tile), stored by one lane of its copies.
template <int NP>
__device__ __forceinline__ void sq8_finish(float v, int idx, int j0, int r,
                                           int size, int Tn, int lane,
                                           const float* nst, const float* qsq,
                                           const float* vq, const int* pair,
                                           float* __restrict__ out) {
  constexpr int NPP = NP <= 1 ? 1 : NP <= 2 ? 2 : 4;
  constexpr int HALVINGS = NPP == 1 ? 2 : NPP == 2 ? 3 : 4;
  const int i = (lane / LANES) * RPL + idx / NPP, j = idx % NPP;
  const int t = r + i;
  if ((lane & ((1 << (4 - HALVINGS)) - 1)) == 0 && j < NP && t < size)
    out[(size_t)pair[j0 + j] * Tn + t] =
        fmaxf(qsq[j0 + j] + nst[i] - 2.f * (v + vq[j0 + j]), 0.f);
}

// One run: NP pairs of the chunk on one tile with rows, this warp's share.
// The warp streams its rows (8 every ROWS_STEP) and their norms through its
// own ring of NST stages (cp.async, NST - 1 steps in flight; __syncwarp, no
// block barrier), scores the pairs GROUP at a time, and the lanes that end
// each reduction store out[pair, t] = max(|q|^2 + norms[t] - 2 (cross +
// <vmin, q>), 0) themselves: 32 contiguous bytes a pair a step.
template <int NP>
__device__ __forceinline__ void sq8_run(const uint8_t* __restrict__ xt,
                                        const float* __restrict__ nt,
                                        int size, int d, int Tn,
                                        const float* qs, const float* qsq,
                                        const float* vq, const int* pair,
                                        uint8_t* ring,
                                        float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int chunks = d / 8;                 // 8-code pieces of a row
  const int rounds = (chunks + LANES - 1) / LANES;
  const int row0 = warp * WROWS;
  const int steps = size > row0 ? (size - row0 + ROWS_STEP - 1) / ROWS_STEP
                                : 0;
  const int stage = WROWS * d + WROWS * 4;  // 8 code rows, their 8 norms
  auto fetch = [&](int s) {                // step s into stage s % NST
    if (s < steps) {
      const int r = row0 + s * ROWS_STEP;
      const int n = min(WROWS, size - r);
      uint8_t* dst = ring + (s % NST) * stage;
      const uint8_t* src = xt + (size_t)r * d;
      for (int i = lane * 16; i < n * d; i += 32 * 16)
        cp_async16(dst + i, src + i);
      if (lane < n) cp_async4(dst + WROWS * d + lane * 4, nt + r + lane);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) fetch(s);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<NST - 2>();
    __syncwarp();                          // step s landed; s - 1 is read
    fetch(s + NST - 1);
    const uint8_t* st = ring + (s % NST) * stage;
    // rows past size hold stale bytes: finite, never stored
    const uint8_t* rows = st + (lane / LANES) * RPL * d;
    const float* nst = reinterpret_cast<const float*>(st + WROWS * d);
    const int r = row0 + s * ROWS_STEP;
    constexpr int NA = NP < GROUP ? NP : GROUP;
    int idx;
    float v = sq8_group<NA>(rows, qs, d, chunks, rounds, lane, idx);
    sq8_finish<NA>(v, idx, 0, r, size, Tn, lane, nst, qsq, vq, pair, out);
    if constexpr (NP > GROUP) {
      v = sq8_group<NP - GROUP>(rows, qs + GROUP * d, d, chunks, rounds,
                                lane, idx);
      sq8_finish<NP - GROUP>(v, idx, GROUP, r, size, Tn, lane, nst, qsq, vq,
                             pair, out);
    }
  }
  cp_async_wait<0>();
  __syncwarp();                            // the ring is free for a next run
}

// sq8_run<n> for a run of n pairs, 1 <= n <= N (only those are compiled)
template <int N>
__device__ __forceinline__ void sq8_dispatch(
    int n, const uint8_t* xt, const float* nt, int size, int d, int Tn,
    const float* qs, const float* qsq, const float* vq, const int* pair,
    uint8_t* ring, float* out) {
  if constexpr (N > 1) {
    if (n < N) {
      sq8_dispatch<N - 1>(n, xt, nt, size, d, Tn, qs, qsq, vq, pair, ring,
                          out);
      return;
    }
  }
  sq8_run<N>(xt, nt, size, d, Tn, qs, qsq, vq, pair, ring, out);
}

__global__ void __launch_bounds__(THREADS, 3)
sq8_tiled_kernel(const uint8_t* __restrict__ codes,  // [ntiles+1, Tn, d]
                 const float* __restrict__ norms,    // [ntiles+1, Tn]
                 const int* __restrict__ sizes,      // [ntiles+1]
                 const float* __restrict__ vmin,     // [d]
                 const float* __restrict__ scale,    // [d]
                 const float* __restrict__ queries,  // [nq, d]
                 const int* __restrict__ probe_ids,  // [P] flat
                 const long long* __restrict__ order,  // [P] sorted by tile
                 int P, int max_t, int Tn, int d,
                 float* __restrict__ out) {          // [P, Tn]
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // [WARPS][NST] stages of 8 code rows [8][d] and their 8 norms
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem)
                  + (size_t)warp * NST * WROWS * (d + 4);
  float* qs = smem + WARPS * NST * WROWS * (d + 4) / 4;  // [CHUNK][d]: scale q
  float* qsq = qs + CHUNK * d;               // [CHUNK]
  float* vq = qsq + CHUNK;                   // [CHUNK]
  int* pair = reinterpret_cast<int*>(vq + CHUNK);   // [CHUNK] flat pair
  int* ptile = pair + CHUNK;                 // [CHUNK] tile
  int* psize = ptile + CHUNK;                // [CHUNK] rows

  const int s0 = blockIdx.x * CHUNK;
  const int np = min(CHUNK, P - s0);
  if (threadIdx.x < np) {
    const int b = (int)order[s0 + threadIdx.x];
    const int t = probe_ids[b];
    pair[threadIdx.x] = b;
    ptile[threadIdx.x] = t;
    psize[threadIdx.x] = min(sizes[t], Tn);
  }
  __syncthreads();
  // each pair's scale * q, |q|^2 and <vmin, q>, a warp a pair
  for (int j = warp; j < np; j += WARPS) {
    if (psize[j] <= 0) continue;             // PAD only: no query needed
    const float* q = queries + (size_t)(pair[j] / max_t) * d;
    float p_qsq = 0.f, p_vq = 0.f;
    for (int k = lane; k < d; k += 32) {
      const float qk = q[k];
      p_qsq = fmaf(qk, qk, p_qsq);
      p_vq = fmaf(vmin[k], qk, p_vq);
      qs[j * d + k] = qk * scale[k];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      p_qsq += __shfl_xor_sync(0xffffffffu, p_qsq, off);
      p_vq += __shfl_xor_sync(0xffffffffu, p_vq, off);
    }
    if (lane == 0) {
      qsq[j] = p_qsq;
      vq[j] = p_vq;
    }
  }
  __syncthreads();

  // runs of one tile among the chunk's pairs (block-uniform); no block
  // barrier from here on: each warp owns its rows and its ring
  for (int j0 = 0; j0 < np;) {
    const int tile = ptile[j0];
    int j1 = j0 + 1;
    while (j1 < np && ptile[j1] == tile) ++j1;
    const int size = psize[j0];
    // PAD past the size (the whole row for an empty tile), coalesced
    for (int j = j0; j < j1; ++j) {
      float* o = out + (size_t)pair[j] * Tn;
      for (int t = max(size, 0) + threadIdx.x; t < Tn; t += THREADS)
        o[t] = PAD;
    }
    if (size > 0) {
      const uint8_t* xt = codes + (size_t)tile * Tn * d;
      const float* nt = norms + (size_t)tile * Tn;
      sq8_dispatch<CHUNK>(j1 - j0, xt, nt, size, d, Tn, qs + j0 * d,
                          qsq + j0, vq + j0, pair + j0, ring, out);
    }
    j0 = j1;
  }
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
    return launch<__nv_bfloat16>(payload, norms, sizes, queries, probe_ids, nq,
                                 max_t, Tn, d, out, s);
  return launch<float>(payload, norms, sizes, queries, probe_ids, nq, max_t,
                       Tn, d, out, s);
}

// K4: uint8 SQ8 codes with the per-dimension affine (vmin, scale), over the
// nq * max_t pairs taken in the order `order` (int64 flat pair indices,
// sorted by their tile probe_ids[order[i]]).
extern "C" int pfh_slab_distances_sq8(const void* codes, const float* norms,
                                      const int* sizes, const float* vmin,
                                      const float* scale, const float* queries,
                                      const int* probe_ids,
                                      const long long* order,
                                      int nq, int max_t, int Tn, int d,
                                      float* out, void* stream) {
  const int P = nq * max_t;
  const size_t smem = (size_t)WARPS * NST * WROWS * (d + 4)
                      + sizeof(float) * (size_t)CHUNK * (d + 2)
                      + sizeof(int) * 3 * CHUNK;
  cudaError_t err = cudaFuncSetAttribute(
      sq8_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  sq8_tiled_kernel<<<(P + CHUNK - 1) / CHUNK, THREADS, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), norms, sizes, vmin, scale, queries,
      probe_ids, order, P, max_t, Tn, d, out);
  return (int)cudaGetLastError();
}
