// K3: partial PQ asymmetric-distance sums over union code tiles, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel prefhetch_tpu/ops/pallas_scan.py _kernel_pq_onehot
// / pallas_pq_onehot_distances (:330-355, :358-421). For every query q,
// union slot u (tile = union[u], list = tile_list[tile]) and lane t:
//
//     out[q, u*T + t] = sum_m lut(q, list)[m*ksub + codes[tile, t, m]]
//     lut(q, list)[i] = bf16( lutq[q, i] + lutp[list, i] )
//
// lutq and lutp arrive as bf16; their sum is taken in f32 and rounded to
// bf16 (round to nearest even), as the TPU kernel's bf16 add does; the M
// terms are summed in f32. The kernel does not mask: lanes past a tile's
// size hold whatever their (zero) codes give, and the caller adds the
// per-(query, list) scalar, clamps and masks (ops/union_scan.py).
//
// The TPU kernel builds a [T, M*ksub] one-hot and multiplies it with the LUT
// on the matrix unit, because a TPU gathers badly. Here the same function is
// a table lookup out of shared memory. What bounds it on an H100: shared-
// memory lookups (nq * U * T * M of them), not bytes. The design cuts the
// lookups' instruction count and the table staging:
//   - a block owns QB queries and keeps their LUT part resident for its
//     whole life, interleaved [M*ksub][QB] bf16, so ONE shared-memory read
//     of 2*QB bytes fetches the entry of all QB queries (16 bytes at QB=8);
//   - the block walks a contiguous range of union slots; the per-list part
//     (lutp[list], M*ksub bf16) is staged only when the list changes, and
//     the tiles of one list are consecutive in a union;
//   - a thread owns one candidate lane t: its M code bytes come straight
//     from device memory with 16-byte loads (a warp reads 32*M contiguous
//     bytes), and its QB sums stay in registers;
//   - each out[q, u*T + t] row segment is written with consecutive threads
//     on consecutive t.
// Reads by random code hit random banks; that cost is measured (PERF.md),
// not solved here.
//
// Grid: (ceil(nq / QB), ny); block (x, y) takes queries [x*QB, x*QB + QB)
// and union slots [y*U/ny, (y+1)*U/ny). 256 threads. Shared memory:
// 2 * M*ksub * (QB + 1) bytes (opted in above 48 KB).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// QB bf16 values moved as one machine word of 2 * QB bytes.
template <int QB> struct Word;
template <> struct Word<8> { typedef uint4 type; };
template <> struct Word<4> { typedef uint2 type; };
template <> struct Word<2> { typedef uint32_t type; };
template <> struct Word<1> { typedef uint16_t type; };

// One (lane, m) term: look the code up for the list part and for all QB
// queries, add, round to bf16, accumulate in f32.
template <int QB>
__device__ __forceinline__ void add_term(const __nv_bfloat16* __restrict__ lutq_s,
                                         const __nv_bfloat16* __restrict__ lutp_s,
                                         int idx, float* acc) {
  typedef typename Word<QB>::type W;
  const float lp = __bfloat162float(lutp_s[idx]);
  const W raw = reinterpret_cast<const W*>(lutq_s)[idx];
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int j = 0; j < QB; ++j)
    acc[j] += __bfloat162float(
        __float2bfloat16_rn(__bfloat162float(e[j]) + lp));
}

template <int QB>
__global__ void __launch_bounds__(THREADS)
pq_onehot_kernel(const uint8_t* __restrict__ codes,         // [ntiles+1, Tn, M]
                 const __nv_bfloat16* __restrict__ lutq,    // [nq, MK]
                 const __nv_bfloat16* __restrict__ lutp,    // [nlist, MK]
                 const int* __restrict__ tile_list,         // [ntiles+1]
                 const int* __restrict__ union_ids,         // [U]
                 int nq, int U, int Tn, int M, int ksub,
                 float* __restrict__ out) {                 // [nq, U*Tn]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int MK = M * ksub;
  __nv_bfloat16* lutq_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [MK][QB]
  __nv_bfloat16* lutp_s = lutq_s + (size_t)MK * QB;                    // [MK]

  const int q0 = blockIdx.x * QB;
  const int u_lo = (int)((long long)U * blockIdx.y / gridDim.y);
  const int u_hi = (int)((long long)U * (blockIdx.y + 1) / gridDim.y);

  // the block's query LUTs, interleaved; rows past nq are zero
  for (int j = 0; j < QB; ++j) {
    const bool real = q0 + j < nq;
    const __nv_bfloat16* src = lutq + (size_t)(real ? q0 + j : 0) * MK;
    for (int i = threadIdx.x; i < MK; i += THREADS)
      lutq_s[(size_t)i * QB + j] = real ? src[i] : __float2bfloat16_rn(0.f);
  }

  int cur_list = -1;
  for (int u = u_lo; u < u_hi; ++u) {
    const int tile = union_ids[u];
    const int list = tile_list[tile];
    if (list != cur_list) {     // block-uniform
      __syncthreads();          // every lane is done with the old list part
      const __nv_bfloat16* src = lutp + (size_t)list * MK;
      for (int i = threadIdx.x; i < MK; i += THREADS) lutp_s[i] = src[i];
      cur_list = list;
      __syncthreads();          // also covers the lutq_s stores above
    }
    const uint8_t* ct = codes + (size_t)tile * Tn * M;
    for (int t = threadIdx.x; t < Tn; t += THREADS) {
      float acc[QB];
#pragma unroll
      for (int j = 0; j < QB; ++j) acc[j] = 0.f;
      const uint8_t* c = ct + (size_t)t * M;
      if ((M & 15) == 0) {      // 16 codes a load
        for (int m0 = 0; m0 < M; m0 += 16) {
          const uint4 raw = *reinterpret_cast<const uint4*>(c + m0);
          const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int k = 0; k < 4; ++k)
              add_term<QB>(lutq_s, lutp_s,
                           (m0 + 4 * i + k) * ksub + ((w[i] >> (8 * k)) & 0xffu),
                           acc);
        }
      } else {
        for (int m = 0; m < M; ++m)
          add_term<QB>(lutq_s, lutp_s, m * ksub + c[m], acc);
      }
#pragma unroll
      for (int j = 0; j < QB; ++j)
        if (q0 + j < nq)
          out[(size_t)(q0 + j) * U * Tn + (size_t)u * Tn + t] = acc[j];
    }
  }
}

template <int QB>
int launch(const uint8_t* codes, const __nv_bfloat16* lutq,
           const __nv_bfloat16* lutp, const int* tile_list,
           const int* union_ids, int nq, int U, int Tn, int M, int ksub,
           int ny, float* out, cudaStream_t stream) {
  const size_t smem = (size_t)M * ksub * 2 * (QB + 1);
  cudaError_t err = cudaFuncSetAttribute(
      pq_onehot_kernel<QB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nq + QB - 1) / QB, ny);
  pq_onehot_kernel<QB><<<grid, THREADS, smem, stream>>>(
      codes, lutq, lutp, tile_list, union_ids, nq, U, Tn, M, ksub, out);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (bound with ctypes in ops/pq_onehot.py). qb in {1, 2, 4, 8} is
// the number of queries a block keeps resident; ny the number of union
// ranges. Returns the cudaError_t of the launch (0 = launched), or -1 for a
// qb this file does not instantiate.
extern "C" int pfh_pq_onehot(const void* codes, const void* lutq,
                             const void* lutp, const int* tile_list,
                             const int* union_ids, int nq, int U, int Tn,
                             int M, int ksub, int qb, int ny, float* out,
                             void* stream) {
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  const __nv_bfloat16* lq = static_cast<const __nv_bfloat16*>(lutq);
  const __nv_bfloat16* lp = static_cast<const __nv_bfloat16*>(lutp);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (qb) {
    case 8: return launch<8>(c, lq, lp, tile_list, union_ids, nq, U, Tn, M,
                             ksub, ny, out, s);
    case 4: return launch<4>(c, lq, lp, tile_list, union_ids, nq, U, Tn, M,
                             ksub, ny, out, s);
    case 2: return launch<2>(c, lq, lp, tile_list, union_ids, nq, U, Tn, M,
                             ksub, ny, out, s);
    case 1: return launch<1>(c, lq, lp, tile_list, union_ids, nq, U, Tn, M,
                             ksub, ny, out, s);
  }
  return -1;
}
