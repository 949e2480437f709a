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
// Both are tile-major: the wrapper sorts the batch's flat pairs by tile id
// (csrc/tile_schedule.cu, one launch, a stable counting sort) and the pairs
// that share a tile share one read of it.
//
// K4 (sq8_tiled_kernel): one pair per block would read a tile once for
// every query that probes it and convert every code byte to f32 again each
// time, and those conversions, not the bytes, set its time. So a block
// takes CHUNK consecutive sorted pairs: the pairs of a chunk that share a
// tile share one read and one decode of it (a tile whose run of pairs
// crosses a chunk boundary is read once per chunk; the long run of the
// empty tile only writes PAD).
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
//
// K5 (slab_tiled_kernel): the same tile-major walk over a dense payload.
// One block per pair (the first form) read a tile once for every query
// probing it, three times the bytes of its bound on the path's batches.
// Here the schedule also cuts each tile's run of sorted pairs into pieces
// of at most SLAB_CHUNK pairs (SLAB_RUN_ALIGNED: a piece never holds two
// tiles, and a run of up to SLAB_CHUNK pairs is never split, so a tile is
// read ceil(pairs / SLAB_CHUNK) times); a block takes one piece. The grid
// is sized for the most pieces the pairs could make; surplus blocks exit.
// A warp streams its rows and their norms through its own cp.async ring of
// SLAB_NST stages and stores its rows' distances itself; no block
// barrier after the piece's queries are staged. With FMAs a bf16 row costs
// more instructions (widen, FMA per pair, a reduction across lanes) than
// the card can execute in its bytes' time, so the bf16 body puts the cross
// terms on the tensor cores: a warp step is 16 rows, ldmatrix from rows
// padded by 16 zero bytes (conflict-free, and the K tail when d % 16 == 8)
// and mma.sync m16n8k16 with the piece's pairs as the 8 columns. The
// query stays f32 in effect: it is split into three bf16 parts (q = hi +
// mid + lo to f32 rounding), three mma per 16 features into one f32
// accumulator; bf16 x bf16 products are exact. The f32 body (off the main
// path) keeps FMAs as K4 does: 16 lanes share a row, a lane takes 4 rows,
// each value feeds one FMA per pair, halving exchanges reduce. Any T, any
// nq, d a multiple of 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float PAD = 3.4e38f;  // ops/topk.py PAD_DISTANCE

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


// ---------------------------------------------------------------------------
// K5

constexpr int SLAB_CHUNK = 8;            // pairs a piece at most (read by
                                         // ops/slab_scan: pfh_slab_chunk)
constexpr bool SLAB_RUN_ALIGNED = true;  // pieces of one tile; false: a
                                         // block per SLAB_CHUNK sorted pairs
constexpr int SLAB_NST = 2;              // stages of a warp's ring
constexpr int SLAB_SMEM_MAX = 232448;    // bytes a block may opt into
constexpr int SLAB_WARPS = 8;            // warps a block
constexpr int SLAB_BLOCKS = 2;           // blocks an SM (launch bounds)
constexpr int SLAB_THREADS = SLAB_WARPS * 32;
constexpr int MROWS = 16;                // rows of a warp's step (bf16 body)
constexpr int MROWS_STEP = SLAB_WARPS * MROWS;
constexpr int SLAB_ROWS_STEP = SLAB_WARPS * WROWS;  // the f32 body's
constexpr int KG = 8;                    // k-steps of query fragments held
constexpr int SPLITS = 3;                // bf16 parts of the f32 query
static_assert(SLAB_CHUNK <= 8, "a piece's pairs are the 8 columns of an mma");

// -- bf16 body: the cross terms of 16 rows x the piece's pairs per warp
// step on the tensor cores, the f32 query split into three bf16 parts

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"((uint32_t)__cvta_generic_to_shared(p)));
}

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Bytes of one warp's ring stage: 16 rows at a stride of 2d + 16 (the 16
// bytes are zero: they are the K tail of d % 16 == 8, and they put the 8
// rows of an ldmatrix phase on distinct banks), then the rows' norms.
__host__ __device__ __forceinline__ int mma_stage_bytes(int d) {
  return MROWS * (2 * d + 16) + MROWS * 4;
}

// The B fragments of the piece's queries, [k-step][split][lane] as
// m16n8k16 reads them: lane l holds column (pair) l / 4 at k = 2 (l % 4)
// + {0, 1} and + {8, 9}; split 0 is bf16(q), 1 and 2 the bf16 of what each
// part leaves, so the three sum to q within f32 rounding. Pairs past np,
// pairs of size-0 tiles and k past d are 0.
__device__ void mma_query_fragments(const float* __restrict__ queries,
                                    const int* pair, const int* psize,
                                    int np, int max_t, int d, uint2* qf) {
  const int ksteps = (d + 15) / 16;
  for (int e = threadIdx.x; e < ksteps * 32; e += SLAB_THREADS) {
    const int ks = e / 32, l = e % 32, j = l / 4;
    const int k0 = ks * 16 + (l % 4) * 2;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (j < np && psize[j] > 0) {
      const float* q = queries + (size_t)(pair[j] / max_t) * d;
      const int ks4[4] = {k0, k0 + 1, k0 + 8, k0 + 9};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (ks4[i] < d) v[i] = q[ks4[i]];
    }
#pragma unroll
    for (int sp = 0; sp < SPLITS; ++sp) {
      __nv_bfloat16 h[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        h[i] = __float2bfloat16_rn(v[i]);
        v[i] -= __bfloat162float(h[i]);
      }
      uint2 w;
      w.x = (uint32_t)__bfloat16_as_ushort(h[0])
            | ((uint32_t)__bfloat16_as_ushort(h[1]) << 16);
      w.y = (uint32_t)__bfloat16_as_ushort(h[2])
            | ((uint32_t)__bfloat16_as_ushort(h[3]) << 16);
      qf[(ks * SPLITS + sp) * 32 + l] = w;
    }
  }
}

// The query fragments of k-steps kg..kg+KG-1 into registers.
__device__ __forceinline__ void load_fragments(uint32_t (&b)[KG][SPLITS][2],
                                               const uint2* qf, int kg,
                                               int ksteps, int lane) {
#pragma unroll
  for (int ks = 0; ks < KG; ++ks)
#pragma unroll
    for (int sp = 0; sp < SPLITS; ++sp)
      if (kg + ks < ksteps) {
        const uint2 w = qf[((kg + ks) * SPLITS + sp) * 32 + lane];
        b[ks][sp][0] = w.x;
        b[ks][sp][1] = w.y;
      }
}

// One run (pairs j0..j1-1 of the piece) on one tile with rows, this warp's
// share: its 16-row steps (16 every MROWS_STEP) and their norms stream
// through its own ring of SLAB_NST stages (cp.async, SLAB_NST - 1 steps in
// flight; __syncwarp, no block barrier). A step is ldmatrix of the rows
// and, per 16 features, three mma (one per part of the queries) into the
// 16 x 8 cross terms; each lane then finishes and stores its 2 rows x 2
// pairs.
__device__ __forceinline__ void slab_mma_run(
    const __nv_bfloat16* __restrict__ xt, const float* __restrict__ nt,
    int size, int d, int Tn, int j0, int j1, const uint2* qf,
    const float* qsq, const int* pair, uint8_t* ring,
    float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ksteps = (d + 15) / 16;
  const int vecs = d / 8;                   // 16-byte pieces of a row
  const int rs = 2 * d + 16;                // row stride in the stage
  const int stage = mma_stage_bytes(d);
  const int row0 = warp * MROWS;
  const int steps = size > row0 ? (size - row0 + MROWS_STEP - 1) / MROWS_STEP
                                : 0;
  auto fetch = [&](int s, int slot) {        // step s into a ring slot
    if (s < steps) {
      const int r = row0 + s * MROWS_STEP;
      const int n = min(MROWS, size - r);
      uint8_t* st = ring + slot * stage;
      const uint8_t* src = reinterpret_cast<const uint8_t*>(
          xt + (size_t)r * d);
      int row = lane / vecs, c = lane % vecs;
      for (int v = lane; v < n * vecs; v += 32) {
        cp_async16(st + row * rs + c * 16, src + (size_t)v * 16);
        for (c += 32; c >= vecs; c -= vecs) ++row;
      }
      if (lane < n) cp_async4(st + MROWS * rs + lane * 4, nt + r + lane);
    }
    cp_async_commit();
  };
  uint32_t b[KG][SPLITS][2];
  const bool held = ksteps <= KG;          // every k-step's fragments held
  if (held) load_fragments(b, qf, 0, ksteps, lane);
  for (int s = 0; s < SLAB_NST - 1; ++s) fetch(s, s);
  int slot = 0;                             // the slot of step s
  const int g = lane >> 2, jc = (lane & 3) * 2;
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<SLAB_NST - 2>();
    __syncwarp();                          // step s landed; s - 1 is read
    fetch(s + SLAB_NST - 1, slot == 0 ? SLAB_NST - 1 : slot - 1);
    const uint8_t* st = ring + slot * stage;
    const uint8_t* arow = st + (lane & 15) * rs + (lane >> 4) * 16;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    for (int kg = 0; kg < ksteps; kg += KG) {
      if (!held) load_fragments(b, qf, kg, ksteps, lane);
#pragma unroll
      for (int ks = 0; ks < KG; ++ks) {
        if (kg + ks < ksteps) {
          uint32_t a[4];
          ldsm_x4(a, arow + (kg + ks) * 32);
#pragma unroll
          for (int sp = SPLITS - 1; sp >= 0; --sp)
            mma_16816(c, a, b[ks][sp][0], b[ks][sp][1]);
        }
      }
    }
    const float* nrm = reinterpret_cast<const float*>(st + MROWS * rs);
    const int r = row0 + s * MROWS_STEP;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = r + g + 8 * h;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = jc + e;
        if (t < size && j >= j0 && j < j1)
          out[(size_t)pair[j] * Tn + t] =
              fmaxf(qsq[j] + nrm[g + 8 * h] - 2.f * c[2 * h + e], 0.f);
      }
    }
    slot = slot + 1 == SLAB_NST ? 0 : slot + 1;
  }
  cp_async_wait<0>();
  __syncwarp();                            // the ring is free for a next run
}

// -- f32 body (off the main path): FMAs, the f32 query as it is

// NP pairs (NP <= GROUP) against a warp step's 8 rows in a ring stage:
// each lane takes 8 values (a round of 8 x 16 lanes) of its RPL rows and
// sums them for every pair, then the half-warp's 16 lanes reduce by
// halving exchanges. Returns the sum this lane ends with, of its
// half-warp's row idx / NPP and pair idx % NPP.
template <int NP>
__device__ __forceinline__ float slab_group(const float* rows,
                                            const float* qs, int d,
                                            int chunks, int rounds,
                                            int lane, int& idx) {
  constexpr int NPP = NP <= 1 ? 1 : NP <= 2 ? 2 : 4;
  constexpr int V = RPL * NPP;            // values a lane reduces: [row][pair]
  constexpr int S1 = V > 1 ? V / 2 : 1;
  constexpr int S2 = S1 > 1 ? S1 / 2 : 1;
  constexpr int S3 = S2 > 1 ? S2 / 2 : 1;
  float a[V];
#pragma unroll
  for (int i = 0; i < V; ++i) a[i] = 0.f;
  for (int k = 0; k < rounds; ++k) {
    const int c = (lane & (LANES - 1)) + k * LANES;
    if (c >= chunks) continue;
    float4 x[RPL][2];
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      x[i][0] = *reinterpret_cast<const float4*>(rows + i * d + c * 8);
      x[i][1] = *reinterpret_cast<const float4*>(rows + i * d + c * 8 + 4);
    }
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const float4 qa = *reinterpret_cast<const float4*>(qs + j * d + c * 8);
      const float4 qb =
          *reinterpret_cast<const float4*>(qs + j * d + c * 8 + 4);
#pragma unroll
      for (int i = 0; i < RPL; ++i) {
        float& s = a[i * NPP + j];
        s = fmaf(x[i][0].x, qa.x, s); s = fmaf(x[i][0].y, qa.y, s);
        s = fmaf(x[i][0].z, qa.z, s); s = fmaf(x[i][0].w, qa.w, s);
        s = fmaf(x[i][1].x, qb.x, s); s = fmaf(x[i][1].y, qb.y, s);
        s = fmaf(x[i][1].z, qb.z, s); s = fmaf(x[i][1].w, qb.w, s);
      }
    }
  }
  idx = 0;
  halve<V>(a, lane, 8, idx);
  halve<S1>(a, lane, 4, idx);
  halve<S2>(a, lane, 2, idx);
  halve<S3>(a, lane, 1, idx);
  return a[0];
}

// The distance of the sum a lane ends with (pair j of the run, row t of
// the tile), stored by one lane of its copies.
template <int NP>
__device__ __forceinline__ void slab_store(float v, int idx, int j0, int r,
                                           int size, int Tn, int lane,
                                           const float* nrm, const float* qsq,
                                           const int* pair,
                                           float* __restrict__ out) {
  constexpr int NPP = NP <= 1 ? 1 : NP <= 2 ? 2 : 4;
  constexpr int HALVINGS = NPP == 1 ? 2 : NPP == 2 ? 3 : 4;
  const int i = (lane / LANES) * RPL + idx / NPP, j = idx % NPP;
  const int t = r + i;
  const bool owner = (lane & ((1 << (4 - HALVINGS)) - 1)) == 0;
  if (owner && t < size && j < NP)
    out[(size_t)pair[j0 + j] * Tn + t] =
        fmaxf(qsq[j0 + j] + nrm[i] - 2.f * v, 0.f);
}

// One run: NP pairs on one tile with rows, this warp's share, as K4's
// sq8_run walks it: 8 rows every SLAB_ROWS_STEP through the warp's own
// ring of SLAB_NST stages, the pairs GROUP at a time.
template <int NP>
__device__ __forceinline__ void slab_run(const float* __restrict__ xt,
                                         const float* __restrict__ nt,
                                         int size, int d, int Tn,
                                         const float* qs, const float* qsq,
                                         const int* pair, uint8_t* ring,
                                         float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int chunks = d / 8;                 // 8-value pieces of a row
  const int rounds = (chunks + LANES - 1) / LANES;
  const int row_bytes = d * 4;
  const int row0 = warp * WROWS;
  const int steps =
      size > row0 ? (size - row0 + SLAB_ROWS_STEP - 1) / SLAB_ROWS_STEP : 0;
  const int stage = WROWS * (row_bytes + 4);  // 8 rows, their 8 norms
  auto fetch = [&](int s, int slot) {        // step s into a ring slot
    if (s < steps) {
      const int r = row0 + s * SLAB_ROWS_STEP;
      const int n = min(WROWS, size - r);
      uint8_t* st = ring + slot * stage;
      const uint8_t* src = reinterpret_cast<const uint8_t*>(
          xt + (size_t)r * d);
      for (int o = lane * 16; o < n * row_bytes; o += 32 * 16)
        cp_async16(st + o, src + o);
      if (lane < n)
        cp_async4(st + WROWS * row_bytes + lane * 4, nt + r + lane);
    }
    cp_async_commit();
  };
  for (int s = 0; s < SLAB_NST - 1; ++s) fetch(s, s);
  int slot = 0;                             // the slot of step s
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<SLAB_NST - 2>();
    __syncwarp();                          // step s landed; s - 1 is read
    fetch(s + SLAB_NST - 1, slot == 0 ? SLAB_NST - 1 : slot - 1);
    const uint8_t* st = ring + slot * stage;
    // rows past size hold stale bytes: never stored
    const float* rows =
        reinterpret_cast<const float*>(st) + (lane / LANES) * RPL * d;
    const float* nrm = reinterpret_cast<const float*>(st + WROWS * row_bytes);
    const int r = row0 + s * SLAB_ROWS_STEP;
    constexpr int NA = NP < GROUP ? NP : GROUP;
    int idx;
    float v = slab_group<NA>(rows, qs, d, chunks, rounds, lane, idx);
    slab_store<NA>(v, idx, 0, r, size, Tn, lane, nrm, qsq, pair, out);
    if constexpr (NP > GROUP) {
      v = slab_group<NP - GROUP>(rows, qs + GROUP * d, d, chunks, rounds,
                                 lane, idx);
      slab_store<NP - GROUP>(v, idx, GROUP, r, size, Tn, lane, nrm, qsq,
                             pair, out);
    }
    slot = slot + 1 == SLAB_NST ? 0 : slot + 1;
  }
  cp_async_wait<0>();
  __syncwarp();                            // the ring is free for a next run
}

// slab_run<n> for a run of n pairs, 1 <= n <= N (only those compiled)
template <int N>
__device__ __forceinline__ void slab_dispatch(
    int n, const float* xt, const float* nt, int size, int d, int Tn,
    const float* qs, const float* qsq, const int* pair,
    uint8_t* ring, float* out) {
  if constexpr (N > 1) {
    if (n < N) {
      slab_dispatch<N - 1>(n, xt, nt, size, d, Tn, qs, qsq, pair, ring, out);
      return;
    }
  }
  slab_run<N>(xt, nt, size, d, Tn, qs, qsq, pair, ring, out);
}

// Shared memory of a K5 block: each warp's ring of SLAB_NST stages; the
// piece's query fragments (bf16) or queries (f32); each pair's |q|^2 and
// three ints.
size_t slab_smem(int d, bool bf16) {
  const size_t tail = sizeof(float) * SLAB_CHUNK
                      + sizeof(int) * 3 * SLAB_CHUNK;
  if (bf16)
    return (size_t)SLAB_WARPS * SLAB_NST * mma_stage_bytes(d)
           + sizeof(uint2) * (size_t)((d + 15) / 16) * SPLITS * 32 + tail;
  return (size_t)SLAB_WARPS * SLAB_NST * WROWS * (4 * d + 4)
         + sizeof(float) * (size_t)SLAB_CHUNK * d + tail;
}

template <typename T>
__global__ void __launch_bounds__(SLAB_THREADS, SLAB_BLOCKS)
slab_tiled_kernel(const T* __restrict__ payload,     // [ntiles+1, Tn, d]
                  const float* __restrict__ norms,   // [ntiles+1, Tn]
                  const int* __restrict__ sizes,     // [ntiles+1]
                  const float* __restrict__ queries, // [nq, d]
                  const int* __restrict__ probe_ids, // [P] flat
                  const long long* __restrict__ order,  // [P] sorted by tile
                  const int* __restrict__ pieces,    // [1 + 2 grid] or null
                  int P, int max_t, int Tn, int d,
                  float* __restrict__ out) {         // [P, Tn]
  constexpr bool MMA = sizeof(T) == 2;       // bf16: the tensor-core body
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t ring_bytes = (size_t)SLAB_NST * (MMA ? mma_stage_bytes(d)
                                                    : WROWS * (4 * d + 4));
  uint8_t* base = reinterpret_cast<uint8_t*>(smem);
  uint8_t* ring = base + warp * ring_bytes;
  uint8_t* qbuf = base + SLAB_WARPS * ring_bytes;   // fragments or queries
  float* qsq = reinterpret_cast<float*>(
      qbuf + (MMA ? sizeof(uint2) * ((d + 15) / 16) * SPLITS * 32
                  : sizeof(float) * SLAB_CHUNK * d));  // [SLAB_CHUNK]
  int* pair = reinterpret_cast<int*>(qsq + SLAB_CHUNK);  // flat pair
  int* ptile = pair + SLAB_CHUNK;            // tile
  int* psize = ptile + SLAB_CHUNK;           // rows

  int s0, np;
  if constexpr (SLAB_RUN_ALIGNED) {
    if ((int)blockIdx.x >= pieces[0]) return;  // fewer pieces than blocks
    s0 = pieces[1 + 2 * blockIdx.x];
    np = pieces[2 + 2 * blockIdx.x];
  } else {
    s0 = blockIdx.x * SLAB_CHUNK;
    np = min(SLAB_CHUNK, P - s0);
  }
  if (threadIdx.x < np) {
    const int b = (int)order[s0 + threadIdx.x];
    const int t = probe_ids[b];
    pair[threadIdx.x] = b;
    ptile[threadIdx.x] = t;
    psize[threadIdx.x] = min(sizes[t], Tn);
  }
  if constexpr (MMA) {                       // zero the rows' 16-byte tails
    for (int e = threadIdx.x; e < SLAB_WARPS * SLAB_NST * MROWS;
         e += SLAB_THREADS)                  // e = (warp, stage, row)
      *reinterpret_cast<uint4*>(base + e / MROWS * mma_stage_bytes(d)
                                + e % MROWS * (2 * d + 16) + 2 * d) =
          make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  if constexpr (MMA)
    mma_query_fragments(queries, pair, psize, np, max_t, d,
                        reinterpret_cast<uint2*>(qbuf));
  // each pair's |q|^2 (and for the f32 body its q), a warp a pair
  float* qs = reinterpret_cast<float*>(qbuf);
  for (int j = warp; j < np; j += SLAB_WARPS) {
    if (psize[j] <= 0) continue;             // PAD only: no query needed
    const float* q = queries + (size_t)(pair[j] / max_t) * d;
    float p_qsq = 0.f;
    for (int k = lane; k < d; k += 32) {
      const float qk = q[k];
      p_qsq = fmaf(qk, qk, p_qsq);
      if constexpr (!MMA) qs[j * d + k] = qk;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      p_qsq += __shfl_xor_sync(0xffffffffu, p_qsq, off);
    if (lane == 0) qsq[j] = p_qsq;
  }
  __syncthreads();

  // runs of one tile among the piece's pairs (block-uniform); no block
  // barrier from here on: each warp owns its rows and its ring
  for (int j0 = 0; j0 < np;) {
    const int tile = ptile[j0];
    int j1 = j0 + 1;
    while (j1 < np && ptile[j1] == tile) ++j1;
    const int size = psize[j0];
    for (int j = j0; j < j1; ++j) {          // PAD past the size, coalesced
      float* o = out + (size_t)pair[j] * Tn;
      for (int t = max(size, 0) + threadIdx.x; t < Tn; t += SLAB_THREADS)
        o[t] = PAD;
    }
    if (size > 0) {
      const T* xt = payload + (size_t)tile * Tn * d;
      const float* nt = norms + (size_t)tile * Tn;
      if constexpr (MMA)
        slab_mma_run(xt, nt, size, d, Tn, j0, j1,
                     reinterpret_cast<const uint2*>(qbuf), qsq, pair, ring,
                     out);
      else
        slab_dispatch<SLAB_CHUNK>(j1 - j0, xt, nt, size, d, Tn, qs + j0 * d,
                                  qsq + j0, pair + j0, ring, out);
    }
    j0 = j1;
  }
}

template <typename T>
int launch_slab(const void* payload, const float* norms, const int* sizes,
                const float* queries, const int* probe_ids,
                const long long* order, const int* pieces, int blocks,
                int P, int max_t, int Tn, int d, float* out,
                cudaStream_t stream) {
  constexpr bool bf16 = sizeof(T) == 2;
  const size_t smem = slab_smem(d, bf16);
  if (smem > SLAB_SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (SLAB_RUN_ALIGNED != (pieces != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      slab_tiled_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  slab_tiled_kernel<T><<<blocks, SLAB_THREADS, smem, stream>>>(
      static_cast<const T*>(payload), norms, sizes, queries, probe_ids, order,
      pieces, P, max_t, Tn, d, out);
  return (int)cudaGetLastError();
}

}  // namespace

// C interfaces (bound with ctypes in ops/slab_scan.py). Each launch returns
// the cudaError_t of the launch; 0 = launched.

// K5's piece: at most this many sorted pairs a block ...
extern "C" int pfh_slab_chunk(void) { return SLAB_CHUNK; }
// ... and 1 when a piece holds one tile's pairs only (the pieces come from
// the schedule), 0 when a block takes the next SLAB_CHUNK sorted pairs.
extern "C" int pfh_slab_run_aligned(void) { return SLAB_RUN_ALIGNED; }

// K5: dense payload, bf16 (payload_bf16 != 0) or f32, over the nq * max_t
// pairs in the order `order` (int64 flat pair indices, sorted by their tile
// probe_ids[order[i]]); `pieces` (run-aligned only, else null) as
// csrc/tile_schedule.cu writes it, with room for `blocks` pieces; `blocks`
// = the grid.
extern "C" int pfh_slab_distances(const void* payload, int payload_bf16,
                                  const float* norms, const int* sizes,
                                  const float* queries, const int* probe_ids,
                                  const long long* order, const int* pieces,
                                  int blocks, int nq, int max_t, int Tn,
                                  int d, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int P = nq * max_t;
  if (payload_bf16)
    return launch_slab<__nv_bfloat16>(payload, norms, sizes, queries,
                                      probe_ids, order, pieces, blocks, P,
                                      max_t, Tn, d, out, s);
  return launch_slab<float>(payload, norms, sizes, queries, probe_ids, order,
                            pieces, blocks, P, max_t, Tn, d, out, s);
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
