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
// about 64 flop/byte, far below the card's ridge of about 295 flop/byte on
// the tensor cores; on the FP32 cores (67 TFLOP/s) the same product would
// need twice the byte time. So the bf16 body puts the product on the tensor
// cores and spends its design on streaming the bytes:
//   - one pass over each union tile's valid payload rows: a block owns a
//     tile's whole T rows for 64 queries; rows past the tile's size are
//     never read, and a size-0 tile (the reserved empty tile, repeated in
//     the union's padding) stores PAD rows and a PAD min without touching
//     its payload;
//   - operands stay bf16 in shared memory: the 64-query block [64 x d] is
//     loaded once per block, and payload chunks of 64 rows x 128 features
//     (whole 256-byte rows at d = 128: 16 KB of contiguous memory) stream
//     through a ring of NST = 2 stages filled by cp.async, so the next
//     chunk's bytes are in flight while this one multiplies (69 KB a block
//     at d = 128, three blocks an SM); the K tail past d is zero-filled by
//     the copy itself (d need only be a multiple of 8, the 16-byte copy's
//     unit);
//   - the product is mma.sync m16n8k16 bf16 with f32 accumulation, fed by
//     ldmatrix from XOR-swizzled rows (no bank conflicts); 8 warps as
//     2 (32 queries) x 4 (16 rows) over each 64 x 64 output chunk;
//   - the epilogue stays in registers (norms, clamp, PAD mask, running f32
//     minimum per query), then the bf16 chunk is staged through one of two
//     shared-memory tiles so it leaves in 16-byte coalesced stores along t
//     (bf16 pairs stored straight from registers were slower on the card),
//     issued after the next ring barrier: the stores need no barrier of
//     their own; the minimum is reduced with shuffles within a quad and
//     through shared memory across the 4 row warps at the end: no f32
//     matrix in device memory, no second pass, no atomics.
// Row chunks that lie wholly past the tile's size store PAD and skip the
// product and the loads.
//
// The f32-payload body (off the main path) multiplies on the FP32 cores: a
// 4x4 register tile per thread out of shared memory, f32 operands staged
// synchronously, one block per (tile, 64 queries).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QB = 64;          // queries per block
constexpr int RB = 64;          // payload rows per chunk
constexpr int THREADS = 256;
constexpr float PAD = 3.4e38f;  // ops/topk.py PAD_DISTANCE

// ---------------------------------------------------------------------------
// bf16 body: tensor cores, cp.async ring
// ---------------------------------------------------------------------------

constexpr int KC = 128;                     // features per chunk (256 bytes)
constexpr int KV = KC / 8;                  // 16-byte vectors a chunk row
constexpr int NST = 2;                      // ring stages
constexpr int OBUF = 2;                     // output staging tiles
constexpr int MIN_BLOCKS = 3;               // blocks an SM at d <= KC
constexpr int CHUNK_ELEMS = RB * KC;        // one [64 x KC] bf16 chunk
constexpr int OS = RB + 8;                  // output staging row stride
constexpr int O_ELEMS = QB * OS;            // one staging tile
constexpr size_t CHUNK_BYTES = sizeof(__nv_bfloat16) * CHUNK_ELEMS;
static_assert(QB == 64 && RB == 64 && THREADS == 256,
              "8 warps as 2 x 32 queries by 4 x 16 rows of a 64-row chunk");
static_assert(KV % 8 == 0 && (RB * KV) % THREADS == 0,
              "the swizzle permutes groups of 8 vectors");

// Shared memory of the bf16 body for nkc feature chunks: the resident query
// block, the ring, the output staging tiles, the per-warp minima.
__host__ __device__ constexpr size_t bf16_smem_bytes(int nkc) {
  return CHUNK_BYTES * (nkc + NST) + sizeof(__nv_bfloat16) * OBUF * O_ELEMS +
         sizeof(float) * 4 * QB;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes = 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
               "r"(smem_u32(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Element offset of (row, 16-byte vector c) in a [64 x KC] bf16 chunk:
// vector c lives at c ^ (row & 7), so the 8 rows that one ldmatrix phase
// reads fall on 8 different bank groups.
__device__ __forceinline__ int swz(int row, int c) {
  return row * KC + ((c ^ (row & 7)) << 3);
}

// Copy rows [row0, row0 + 64) x features [k0, k0 + KC) of a row-major
// [*, d] bf16 matrix into a swizzled chunk; rows at or past nvalid and
// features at or past d are zero-filled without reading.
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* __restrict__ src,
                                           int nvalid, int d, int row0, int k0,
                                           __nv_bfloat16* dst) {
#pragma unroll
  for (int i = 0; i < RB * KV / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int r = e / KV;
    const int c = e % KV;
    const int col = k0 + c * 8;
    const bool ok = row0 + r < nvalid && col < d;
    const __nv_bfloat16* s = ok ? src + (size_t)(row0 + r) * d + col : src;
    cp_async16(dst + swz(r, c), s, ok ? 16 : 0);
  }
}

// Store a staged [64 queries x 64 rows] bf16 tile to rows [r0, r0 + 64) of
// the block's queries: 16-byte stores along t when T % 8 == 0.
__device__ __forceinline__ void store_tile(const __nv_bfloat16* o_s,
                                           __nv_bfloat16* __restrict__ out,
                                           int q0, int nq, int Tn, int r0,
                                           bool vec_store) {
  if (vec_store) {
    for (int e = threadIdx.x; e < QB * (RB / 8); e += THREADS) {
      const int ql = e >> 3;
      const int t = r0 + (e & 7) * 8;
      if (q0 + ql < nq && t < Tn)
        *reinterpret_cast<uint4*>(out + (size_t)(q0 + ql) * Tn + t) =
            *reinterpret_cast<const uint4*>(o_s + ql * OS + (e & 7) * 8);
    }
  } else {
    for (int e = threadIdx.x; e < QB * RB; e += THREADS) {
      const int ql = e / RB;
      const int t = r0 + e % RB;
      if (q0 + ql < nq && t < Tn)
        out[(size_t)(q0 + ql) * Tn + t] = o_s[ql * OS + e % RB];
    }
  }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
union_scan_min_bf16_kernel(const __nv_bfloat16* __restrict__ payload,  // [ntiles+1, Tn, d]
                           const float* __restrict__ norms,            // [ntiles+1, Tn]
                           const int* __restrict__ sizes,              // [ntiles+1]
                           const __nv_bfloat16* __restrict__ queries,  // [nq, d]
                           const float* __restrict__ qsq,              // [nq]
                           const int* __restrict__ union_ids,          // [U]
                           int nq, int Tn, int d,
                           __nv_bfloat16* __restrict__ d2,             // [U, nq, Tn]
                           float* __restrict__ dmin) {                 // [U, nq]
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int nkc = (d + KC - 1) / KC;
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [nkc][64xKC]
  __nv_bfloat16* ring = q_s + (size_t)nkc * CHUNK_ELEMS;            // [NST][64xKC]
  __nv_bfloat16* o_s = ring + (size_t)NST * CHUNK_ELEMS;            // [OBUF][64][OS]
  float* red = reinterpret_cast<float*>(o_s + OBUF * O_ELEMS);      // [4][64]

  const int u = blockIdx.x;
  const int q0 = blockIdx.y * QB;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wq = warp & 1;      // queries wq*32 .. +32
  const int wr = warp >> 1;     // rows wr*16 .. +16 of a chunk
  const int tile = union_ids[u];
  const int size = sizes[tile];
  const __nv_bfloat16* xt = payload + (size_t)tile * Tn * d;
  const float* nt = norms + (size_t)tile * Tn;
  __nv_bfloat16* out = d2 + (size_t)u * nq * Tn;
  const bool vec_store = (Tn & 7) == 0;
  const int nchunks = (Tn + RB - 1) / RB;
  const int nlive = (size + RB - 1) / RB;   // chunks holding a valid row
  const int jobs = nlive * nkc;             // (row chunk, feature chunk)

  // the query block, every feature chunk, in the first copy group
  if (jobs > 0) {
    const __nv_bfloat16* qb = queries + (size_t)q0 * d;
    for (int kc = 0; kc < nkc; ++kc)
      load_chunk(qb, nq - q0, d, 0, kc * KC, q_s + (size_t)kc * CHUNK_ELEMS);
  }
#pragma unroll
  for (int j = 0; j < NST - 1; ++j) {
    if (j < jobs)
      load_chunk(xt, size, d, (j / nkc) * RB, (j % nkc) * KC,
                 ring + (size_t)j * CHUNK_ELEMS);
    cp_async_commit();
  }

  // this thread's 4 query rows: (mi, h) -> wq*32 + mi*16 + h*8 + lane/4
  float qn[2][2], run_min[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = q0 + wq * 32 + mi * 16 + h * 8 + (lane >> 2);
      qn[mi][h] = q < nq ? qsq[q] : 0.f;
      run_min[mi][h] = PAD;
    }

  float acc[2][2][4];
  int staged = -1;              // row chunk whose bf16 tile waits in o_s
  for (int j = 0; j < jobs; ++j) {
    cp_async_wait<NST - 2>();
    __syncthreads();            // chunk j landed; chunk j-1's slot is free;
                                // the staged tile is whole
    {
      const int jn = j + NST - 1;
      if (jn < jobs)
        load_chunk(xt, size, d, (jn / nkc) * RB, (jn % nkc) * KC,
                   ring + (size_t)(jn % NST) * CHUNK_ELEMS);
      cp_async_commit();
    }
    if (staged >= 0) {
      store_tile(o_s + (staged % OBUF) * O_ELEMS, out, q0, nq, Tn,
                 staged * RB, vec_store);
      staged = -1;
      // with one feature chunk and one staging tile the next epilogue is
      // this iteration's: it may write o_s only when every thread is done
      // reading it
      if (nkc == 1 && OBUF == 1) __syncthreads();
    }
    const int kc = j % nkc;
    if (kc == 0) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    }
    const __nv_bfloat16* xs = ring + (size_t)(j % NST) * CHUNK_ELEMS;
    const __nv_bfloat16* qs = q_s + (size_t)kc * CHUNK_ELEMS;
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      uint32_t a[2][4], b[4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int row = wq * 32 + mi * 16 + (lane & 15);
        ldmatrix_x4(a[mi], qs + swz(row, kk * 2 + (lane >> 4)));
      }
      {
        const int row = wr * 16 + (lane & 7) + ((lane >> 4) << 3);
        ldmatrix_x4(b, xs + swz(row, kk * 2 + ((lane >> 3) & 1)));
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma_bf16(acc[mi][0], a[mi], b[0], b[1]);
        mma_bf16(acc[mi][1], a[mi], b[2], b[3]);
      }
    }
    if (kc != nkc - 1) continue;

    // epilogue of row chunk r0: norms, clamp, mask, running min, bf16 tile
    const int r0 = (j / nkc) * RB;
    __nv_bfloat16* ot = o_s + ((j / nkc) % OBUF) * O_ELEMS;
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) {
      const int rl = wr * 16 + ni * 8 + (lane & 3) * 2;
      const int t = r0 + rl;
      const float n0 = t < size ? nt[t] : 0.f;
      const float n1 = t + 1 < size ? nt[t + 1] : 0.f;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0 = fmaxf(qn[mi][h] + n0 - 2.f * acc[mi][ni][2 * h], 0.f);
          float v1 = fmaxf(qn[mi][h] + n1 - 2.f * acc[mi][ni][2 * h + 1], 0.f);
          v0 = t < size ? v0 : PAD;
          v1 = t + 1 < size ? v1 : PAD;
          run_min[mi][h] = fminf(run_min[mi][h], fminf(v0, v1));
          const int ql = wq * 32 + mi * 16 + h * 8 + (lane >> 2);
          *reinterpret_cast<__nv_bfloat162*>(ot + ql * OS + rl) =
              __floats2bfloat162_rn(v0, v1);
        }
    }
    // stored after the next barrier: the loop's top, or the one below
    staged = j / nkc;
  }
  cp_async_wait<0>();

  // chunks wholly past the size (all of a size-0 tile): PAD, no product
  const __nv_bfloat16 pad_b = __float2bfloat16_rn(PAD);   // +inf
  if (nlive < nchunks) {
    if (vec_store) {
      __nv_bfloat162 p2 = __halves2bfloat162(pad_b, pad_b);
      const uint32_t pw = *reinterpret_cast<uint32_t*>(&p2);
      const uint4 pad4 = make_uint4(pw, pw, pw, pw);
      const int per_q = (Tn - nlive * RB) / 8;
      for (int e = tid; e < QB * per_q; e += THREADS) {
        const int ql = e / per_q;
        const int t = nlive * RB + (e % per_q) * 8;
        if (q0 + ql < nq)
          *reinterpret_cast<uint4*>(out + (size_t)(q0 + ql) * Tn + t) = pad4;
      }
    } else {
      const int per_q = Tn - nlive * RB;
      for (int e = tid; e < QB * per_q; e += THREADS) {
        const int ql = e / per_q;
        if (q0 + ql < nq)
          out[(size_t)(q0 + ql) * Tn + nlive * RB + e % per_q] = pad_b;
      }
    }
  }

  // per-query min: across the quad that shares a row, then the 4 row warps
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m = run_min[mi][h];
      m = fminf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fminf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      if ((lane & 3) == 0)
        red[wr * QB + wq * 32 + mi * 16 + h * 8 + (lane >> 2)] = m;
    }
  __syncthreads();              // the minima and the last staged tile
  if (staged >= 0)
    store_tile(o_s + (staged % OBUF) * O_ELEMS, out, q0, nq, Tn, staged * RB,
               vec_store);
  if (tid < QB && q0 + tid < nq) {
    const float m = fminf(fminf(red[tid], red[QB + tid]),
                          fminf(red[2 * QB + tid], red[3 * QB + tid]));
    dmin[(size_t)u * nq + q0 + tid] = m;
  }
}

// ---------------------------------------------------------------------------
// f32 body: FP32 cores, 4x4 register tile per thread
// ---------------------------------------------------------------------------

constexpr int KF = 128;         // features per shared-memory stage
constexpr int KS = KF + 4;      // row stride in floats: conflict-free float4 reads
constexpr size_t F32_SMEM_BYTES = sizeof(float) * (QB + RB) * KS;

// Stage rows [row0, row0 + RB) x features [k0, k0 + kl) of a row-major
// [nrows, d] f32 matrix into shared memory (zeros past nrows).
__device__ __forceinline__ void stage_f32(const float* __restrict__ src,
                                          int nrows, int d, int row0, int k0,
                                          int kl, float* dst) {
  const int per_row = kl / 4;
  for (int e = threadIdx.x; e < RB * per_row; e += THREADS) {
    const int r = e / per_row;
    const int c = (e - r * per_row) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < nrows)
      v = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * d + k0 + c);
    *reinterpret_cast<float4*>(dst + r * KS + c) = v;
  }
}

__global__ void __launch_bounds__(THREADS)
union_scan_min_f32_kernel(const float* __restrict__ payload,       // [ntiles+1, Tn, d]
                          const float* __restrict__ norms,         // [ntiles+1, Tn]
                          const int* __restrict__ sizes,           // [ntiles+1]
                          const float* __restrict__ queries,       // [nq, d]
                          const float* __restrict__ qsq,           // [nq]
                          const int* __restrict__ union_ids,       // [U]
                          int nq, int Tn, int d,
                          __nv_bfloat16* __restrict__ d2,          // [U, nq, Tn]
                          float* __restrict__ dmin) {              // [U, nq]
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;             // [QB][KS]
  float* x_s = smem + QB * KS;   // [RB][KS]

  // thread (tx, ty) owns queries ty*4 + i and rows tx + 16*j, so
  // consecutive rows go to consecutive threads in the store
  const int u = blockIdx.x;
  const int q0 = blockIdx.y * QB;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int tile = union_ids[u];
  const int size = sizes[tile];
  const float* xt = payload + (size_t)tile * Tn * d;
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

  const int nkc = (d + KF - 1) / KF;
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
      const int k0 = kc * KF;
      const int kl = min(KF, d - k0);
      // the query block stays resident across row chunks when d <= KF
      if (nkc > 1 || r0 == 0) stage_f32(queries, nq, d, q0, k0, kl, q_s);
      stage_f32(xt, Tn, d, r0, k0, kl, x_s);
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

}  // namespace

// C interface (bound with ctypes in ops/union_scan_min.py). Returns the
// cudaError_t of the launch; 0 = launched.
extern "C" int pfh_union_scan_min(const void* payload, int payload_bf16,
                                  const float* norms, const int* sizes,
                                  const void* queries, const float* qsq,
                                  const int* union_ids, int U, int nq, int Tn,
                                  int d, void* d2, float* dmin, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(U, (nq + QB - 1) / QB);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(d2);
  cudaError_t err;
  if (payload_bf16) {
    const int smem = (int)bf16_smem_bytes((d + KC - 1) / KC);
    err = cudaFuncSetAttribute(union_scan_min_bf16_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    union_scan_min_bf16_kernel<<<grid, THREADS, smem, s>>>(
        static_cast<const __nv_bfloat16*>(payload), norms, sizes,
        static_cast<const __nv_bfloat16*>(queries), qsq, union_ids, nq, Tn, d,
        out, dmin);
  } else {
    err = cudaFuncSetAttribute(union_scan_min_f32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)F32_SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    union_scan_min_f32_kernel<<<grid, THREADS, F32_SMEM_BYTES, s>>>(
        static_cast<const float*>(payload), norms, sizes,
        static_cast<const float*>(queries), qsq, union_ids, nq, Tn, d, out,
        dmin);
  }
  return (int)cudaGetLastError();
}

// Shared memory the bf16 body needs at feature width d (the wrapper refuses
// a d whose query block and ring do not fit a block).
extern "C" int pfh_union_scan_min_bf16_smem(int d) {
  return (int)bf16_smem_bytes((d + KC - 1) / KC);
}
