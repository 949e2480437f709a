// K2: the whole four-step negacyclic NTT of a batch of polynomials, one
// launch per transform, on Hopper's int8 tensor cores (sm_90a).
//
// Replaces the TPU kernel prefhetch_tpu/ops/ntt_pallas.py _run_step /
// _make_kernel (:169-287), and the two-call composition ntt4_pallas /
// intt4_pallas around it (:290-311). With N = 64 * N2 (N2 = 64 or 128) and a
// polynomial as a [64, N2] block, every stage is D = P . Q^T mod q,
// D[i][j] = sum_k P[i][k] * Q[j][k], where one of P, Q is the polynomial and
// the other a residue table:
//
//   forward  a: D[j1][k2] = sum_k1 W1f[j1][k1] x[k1][k2]  * f_tw[j1][k2]
//            b: D[j1][j2] = sum_k2 y[j1][k2]  W2[j2][k2]  -> out[j1*N2 + j2]
//   inverse  a: D[j1][k2] = sum_j2 x[j1][j2]  W2i[k2][j2] * g_tw[j1][k2]
//            b: D[k1][k2] = sum_j1 W1g[k1][j1] y[j1][k2]  -> out[k1*N2 + k2]
//
// so the forward output is four-step order and the inverse output natural
// order, the contract of ops/ntt4.py. The integers are exactly the TPU
// kernel's: the input of each stage is folded once (fold30) and split into
// four balanced base-256 int8 digits, the table is held as its four digit
// planes (ops/ntt4_fused.balanced_digits, the port's copy of
// ntt_mxu._balanced_digits_int), and the 16 digit products are recombined
// with the TPU kernel's group scheme, Shoup multiplies and correction
// constant. Stage a's output is lazy, stage b's canonical [0, q). The result
// is bit-equal to the two Pallas stages and to the plain version.
//
// Exactness (k = contraction length, 64 or 128; x digits after fold30 and
// table digits are in [-128, 127], the top digit of each in [-65, 65]
// because both values are below 2^30 + 3 delta):
//   a_s = sum_{d+e=s} sum_k xd * we, one int32 mma accumulator per diagonal s:
//     |a_0| <= k*2^14 = 2^21 (k=128), |a_1| <= 2^22, |a_2| <= 3*2^21,
//     |a_3| <= 2*2^21 + 2*k*128*65 < 3.1*2^21, |a_4| < 2.1*2^21,
//     |a_5| < 1.1*2^21, |a_6| <= k*65*65 < 2^20 — no mma wraps.
//   groups g01 = a0 + 2^8 a1 (< 2^21 + 2^30), g2 = a2, g34 = a3 + 2^8 a4
//     (< 3.1*2^21 + 2.1*2^29 < 2^31), g56 = a5 + 2^8 a6 (< 2^29): each fits
//     int32, so the top-bit flip g ^ 2^31 is the non-negative g + 2^31;
//   sum_s 2^{8s} a_s = g01 + 2^16 g2 + 2^24 g34 + 2^40 g56 is the exact
//     product sum; the flips add 2^31 (1 + 2^16 + 2^24 + 2^40), which corr
//     takes back mod q. fold30 and Shoup (h within 1 of floor(x c / q) for
//     any u32 x) keep every partial below 2^32 (ntt_pallas.py:176-231).
// For k = 64 every bound halves. The mma's are m16n8k32 s8 x s8 -> s32.
//
// What bounds it on an H100: at the request's shape (512 polynomials of
// 64 x 64) the transform reads and writes 16.8 MB (25.2 MB from int64):
// 5.0 us (7.5 us) at 3.35 TB/s; its int8 work is 512 * 2 * 64^3 * 16 =
// 4.3 G multiply-adds, 4.3 us at the int8 tensor-core peak. The design reads
// each input byte once and writes each output byte once: the polynomial, its
// digit planes and the stage-a result never leave shared memory, and both
// transposes of the four-step form are folded into the digit split (forward:
// the load; inverse: the stage-a store). Tables sit in shared memory once
// per block: blocks are persistent and loop over polynomials.
//
// Block: 256 threads, 8 warps; warp w owns rows 16 (w % 4) .. +15 and half
// of the N2 output columns of every stage. Shared memory (bytes, digit rows
// padded by 16 so that ldmatrix reads 8 rows without bank conflicts):
//   T1   4 x 64 x 80          W1f (forward) or W1g (inverse)
//   T2   4 x N2 x (N2 + 16)   W2 (forward) or W2i (inverse)
//   DATA 4 x max(N2 x 80, 64 x (N2 + 16))   the polynomial's digit planes
//   STG  u32 [64][N2 + 8] (forward) or [N2][68] (inverse): stage a's result
// N2 = 64: 79,872 B, two blocks an SM; N2 = 128: 169,984 B, one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int N1 = 64;                 // rows of every stage's output
constexpr int T1_ROW = N1 + 16;        // bytes per digit row, K = 64
constexpr uint32_t M30 = (1u << 30) - 1;

struct Consts {
  uint32_t q, delta;
  uint32_t w2c, w2s, w34c, w34s, w56c, w56s;   // 2^16, 2^24, 2^40 mod q + Shoup
  uint32_t corr;                               // -2^31 (1+2^16+2^24+2^40) mod q
};

template <int N2> struct Layout {
  static constexpr int T2_ROW = N2 + 16;
  static constexpr int DQ_ROW = T1_ROW;        // data as Q: [N2][64]
  static constexpr int DP_ROW = N2 + 16;       // data as P: [64][N2]
  static constexpr int T1_PLANE = N1 * T1_ROW;
  static constexpr int T2_PLANE = N2 * T2_ROW;
  static constexpr int DQ_PLANE = N2 * DQ_ROW;
  static constexpr int DP_PLANE = N1 * DP_ROW;
  static constexpr int DATA_PLANE = DQ_PLANE > DP_PLANE ? DQ_PLANE : DP_PLANE;
  static constexpr int STG_F = N2 + 8;         // forward staging row (words)
  static constexpr int STG_I = N1 + 4;         // inverse staging row (words)
  static constexpr int STG_WORDS =
      N1 * STG_F > N2 * STG_I ? N1 * STG_F : N2 * STG_I;
  static constexpr int T1_OFF = 0;
  static constexpr int T2_OFF = T1_OFF + 4 * T1_PLANE;
  static constexpr int DATA_OFF = T2_OFF + 4 * T2_PLANE;
  static constexpr int STG_OFF = DATA_OFF + 4 * DATA_PLANE;
  static constexpr int SMEM = STG_OFF + 4 * STG_WORDS;
};

__device__ __forceinline__ uint32_t fold30(uint32_t x, uint32_t delta) {
  return (x & M30) + (x >> 30) * delta;
}

// x * c mod q in [0, 2q) for any u32 x, c < q, cs = floor(c 2^32 / q)
__device__ __forceinline__ uint32_t shoup(uint32_t x, uint32_t c, uint32_t cs,
                                          uint32_t q) {
  return x * c - __umulhi(x, cs) * q;
}

// The four balanced base-256 digits of fold30(v), one byte each, placed at
// byte `slot` of dig[0..3] (the TPU kernel's split, ntt_pallas.py:192-198).
__device__ __forceinline__ void split4(uint32_t v, uint32_t delta, int slot,
                                       uint32_t (&dig)[4]) {
  int cur = (int)fold30(v, delta);
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const int r = ((cur + 128) & 255) - 128;
    dig[d] |= (uint32_t)(r & 255) << (8 * slot);
    cur = (cur - r) >> 8;
  }
}

// The TPU kernel's recombination of the seven diagonal sums
// (ntt_pallas.py:204-231): a value congruent to sum_s 2^{8s} a_s, below
// 2^30 + 3 delta.
__device__ __forceinline__ uint32_t recombine(const int (&a)[7],
                                              const Consts& c) {
  const uint32_t top = 0x80000000u;
  const uint32_t g01 = (uint32_t)a[0] + ((uint32_t)a[1] << 8);
  const uint32_t g2 = (uint32_t)a[2];
  const uint32_t g34 = (uint32_t)a[3] + ((uint32_t)a[4] << 8);
  const uint32_t g56 = (uint32_t)a[5] + ((uint32_t)a[6] << 8);
  const uint32_t r01 = fold30(g01 ^ top, c.delta);
  const uint32_t r2 = shoup(g2 ^ top, c.w2c, c.w2s, c.q);
  const uint32_t r34 = shoup(g34 ^ top, c.w34c, c.w34s, c.q);
  const uint32_t r56 = shoup(g56 ^ top, c.w56c, c.w56s, c.q);
  const uint32_t t = fold30(r2 + r34, c.delta);
  const uint32_t t2 = fold30(r56 + c.corr, c.delta);
  return fold30(t + t2 + r01, c.delta);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a) : "memory");
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One stage, D[64][N2] = P[64][K] . Q[N2][K]^T on digit planes, for this
// warp's 16 rows and N2/2 columns. epi(row, col, v0, v1) gets the
// recombined values of (row, col) and (row, col + 1).
template <int K, int N2, class Epi>
__device__ __forceinline__ void stage(const uint8_t* P, int p_row, int p_plane,
                                      const uint8_t* Q, int q_row, int q_plane,
                                      const Consts& c, Epi epi) {
  constexpr int KS = K / 32;            // k-steps of an m16n8k32
  constexpr int NF = N2 / 16;           // 8-column fragments of a warp
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = (warp & 3) * 16;
  const int col0 = (warp >> 2) * (N2 / 2);

  // A fragments of the warp's 16 rows, every digit and k-step, kept
  uint32_t af[4][KS][4];
  {
    const int r = row0 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int kb = (lane >> 4) * 16;
#pragma unroll
    for (int d = 0; d < 4; ++d)
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldsm_x4(af[d][ks], P + d * p_plane + r * p_row + ks * 32 + kb);
  }
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll 1
  for (int nf = 0; nf < NF; ++nf) {
    const int n0 = col0 + nf * 8;
    uint32_t bf[4][KS][2];
    {
      const int n = n0 + (lane & 7);
      const int kb = (lane >> 3) * 16;
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int k2 = 0; k2 < KS / 2; ++k2) {
          uint32_t t[4];
          ldsm_x4(t, Q + e * q_plane + n * q_row + k2 * 64 + kb);
          bf[e][2 * k2][0] = t[0];
          bf[e][2 * k2][1] = t[1];
          bf[e][2 * k2 + 1][0] = t[2];
          bf[e][2 * k2 + 1][1] = t[3];
        }
    }
    int acc[7][4];
#pragma unroll
    for (int s = 0; s < 7; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[s][i] = 0;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int d = 0; d < 4; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mma_s8(acc[d + e], af[d][ks], bf[e][ks][0], bf[e][ks][1]);
    uint32_t v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int a[7];
#pragma unroll
      for (int s = 0; s < 7; ++s) a[s] = acc[s][i];
      v[i] = recombine(a, c);
    }
    const int col = n0 + 2 * tig;
    epi(row0 + g, col, v[0], v[1]);
    epi(row0 + g + 8, col, v[2], v[3]);
  }
}

__device__ __forceinline__ uint32_t canon(uint32_t v, uint32_t q) {
  v = v >= q ? v - q : v;
  return v >= q ? v - q : v;
}

// A u32 congruent mod q to the int32 s: s itself, or s + 3q if negative,
// which lies in [3q - 2^31, 3q) within [0, 2^32) (2^31 < 3q < 2^32 for
// 2^30 - 2^20 < q < 2^30), so fold30 takes it like any u32. The plain
// version's torch.remainder gives the same residue.
__device__ __forceinline__ uint32_t lift(int s, uint32_t q) {
  return (uint32_t)s + (s < 0 ? 3u * q : 0u);
}

// x[i], int32 or int64 taken by its low 32 bits as .to(torch.int32) does,
// lifted to a non-negative u32 of its residue class
__device__ __forceinline__ uint32_t load_x(const void* x, bool x64, size_t i,
                                           uint32_t q) {
  return lift(x64 ? (int)__ldg(static_cast<const long long*>(x) + i)
                  : __ldg(static_cast<const int*>(x) + i),
              q);
}

// Copy a [4][rows][K] int8 table from global memory into padded rows.
__device__ __forceinline__ void load_table(uint8_t* dst, int dst_row,
                                           const uint8_t* src, int rows,
                                           int K) {
  const int chunks = K / 16;
  const int total = 4 * rows * chunks;
  for (int i = threadIdx.x; i < total; i += THREADS) {
    const int ch = i % chunks, r = (i / chunks) % rows, d = i / (chunks * rows);
    *reinterpret_cast<uint4*>(dst + (d * rows + r) * dst_row + ch * 16) =
        __ldg(reinterpret_cast<const uint4*>(src) + i);
  }
}

template <int N2, bool INV>
__global__ void __launch_bounds__(THREADS, N2 == 64 ? 2 : 1)
ntt4_kernel(const void* __restrict__ x, int x64,
            const uint8_t* __restrict__ t1g,   // [4][64][64]  digit planes
            const uint8_t* __restrict__ t2g,   // [4][N2][N2]
            const uint4* __restrict__ twg,     // [64][N2/2] (tw, tw, s, s)
            int* __restrict__ out, int B, Consts c) {
  using L = Layout<N2>;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* T1 = smem + L::T1_OFF;
  uint8_t* T2 = smem + L::T2_OFF;
  uint8_t* DATA = smem + L::DATA_OFF;
  uint32_t* STG = reinterpret_cast<uint32_t*>(smem + L::STG_OFF);
  constexpr int N = N1 * N2;
  const int tid = threadIdx.x;

  load_table(T1, T1_ROW, t1g, N1, N1);
  load_table(T2, L::T2_ROW, t2g, N2, N2);

  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const size_t base = (size_t)b * N;
    __syncthreads();        // tables loaded; the last polynomial is done
    // -- split 1: the input, folded and split into digit planes ----------
    if (!INV) {
      // x[k1][k2] -> DATA as Q[k2][k1]: the first transpose. A thread takes
      // four k1 rows of one column, so each digit plane gets one word.
      for (int i = tid; i < (N1 / 4) * N2; i += THREADS) {
        const int c_lo = i & 7, grp = (i >> 3) & 15, c_hi = i >> 7;
        const int col = c_hi * 8 + c_lo;
        uint32_t dig[4] = {0, 0, 0, 0};
#pragma unroll
        for (int s = 0; s < 4; ++s)
          split4(load_x(x, x64, base + (size_t)(4 * grp + s) * N2 + col,
                        c.q),
                 c.delta, s, dig);
#pragma unroll
        for (int d = 0; d < 4; ++d)
          *reinterpret_cast<uint32_t*>(DATA + d * L::DQ_PLANE
                                       + col * L::DQ_ROW + 4 * grp) = dig[d];
      }
    } else {
      // x[j1][j2] -> DATA as P[j1][j2], four consecutive values a thread
      for (int i = tid; i < N1 * (N2 / 4); i += THREADS) {
        const int r = i / (N2 / 4), k4 = i % (N2 / 4);
        const size_t o = base + (size_t)r * N2 + 4 * k4;
        uint32_t dig[4] = {0, 0, 0, 0};
        if (x64) {
          const longlong2* p = reinterpret_cast<const longlong2*>(
              static_cast<const long long*>(x) + o);
          const longlong2 u = __ldg(p), w = __ldg(p + 1);
          split4(lift((int)u.x, c.q), c.delta, 0, dig);
          split4(lift((int)u.y, c.q), c.delta, 1, dig);
          split4(lift((int)w.x, c.q), c.delta, 2, dig);
          split4(lift((int)w.y, c.q), c.delta, 3, dig);
        } else {
          const int4 u = __ldg(reinterpret_cast<const int4*>(
              static_cast<const int*>(x) + o));
          split4(lift(u.x, c.q), c.delta, 0, dig);
          split4(lift(u.y, c.q), c.delta, 1, dig);
          split4(lift(u.z, c.q), c.delta, 2, dig);
          split4(lift(u.w, c.q), c.delta, 3, dig);
        }
#pragma unroll
        for (int d = 0; d < 4; ++d)
          *reinterpret_cast<uint32_t*>(DATA + d * L::DP_PLANE
                                       + r * L::DP_ROW + 4 * k4) = dig[d];
      }
    }
    __syncthreads();
    // -- stage a: product, recombination, Shoup twiddle (lazy [0, 2q)) ---
    auto twiddle = [&](int row, int col, uint32_t& v0, uint32_t& v1) {
      const uint4 t = __ldg(twg + (row * N2 + col) / 2);
      v0 = shoup(v0, t.x, t.z, c.q);
      v1 = shoup(v1, t.y, t.w, c.q);
    };
    if (!INV) {
      stage<N1, N2>(T1, T1_ROW, L::T1_PLANE, DATA, L::DQ_ROW, L::DQ_PLANE, c,
                    [&](int row, int col, uint32_t v0, uint32_t v1) {
                      twiddle(row, col, v0, v1);
                      *reinterpret_cast<uint2*>(STG + row * L::STG_F + col) =
                          make_uint2(v0, v1);
                    });
    } else {
      // stored transposed, [k2][j1]: the inverse's transpose
      stage<N2, N2>(DATA, L::DP_ROW, L::DP_PLANE, T2, L::T2_ROW, L::T2_PLANE,
                    c, [&](int row, int col, uint32_t v0, uint32_t v1) {
                      twiddle(row, col, v0, v1);
                      STG[col * L::STG_I + row] = v0;
                      STG[(col + 1) * L::STG_I + row] = v1;
                    });
    }
    __syncthreads();
    // -- split 2: stage a's result, folded and split again ---------------
    if (!INV) {
      for (int i = tid; i < N1 * (N2 / 4); i += THREADS) {
        const int r = i / (N2 / 4), k4 = i % (N2 / 4);
        const uint4 u = *reinterpret_cast<const uint4*>(STG + r * L::STG_F
                                                        + 4 * k4);
        uint32_t dig[4] = {0, 0, 0, 0};
        split4(u.x, c.delta, 0, dig);
        split4(u.y, c.delta, 1, dig);
        split4(u.z, c.delta, 2, dig);
        split4(u.w, c.delta, 3, dig);
#pragma unroll
        for (int d = 0; d < 4; ++d)
          *reinterpret_cast<uint32_t*>(DATA + d * L::DP_PLANE
                                       + r * L::DP_ROW + 4 * k4) = dig[d];
      }
    } else {
      for (int i = tid; i < N2 * (N1 / 4); i += THREADS) {
        const int r = i / (N1 / 4), k4 = i % (N1 / 4);
        const uint4 u = *reinterpret_cast<const uint4*>(STG + r * L::STG_I
                                                        + 4 * k4);
        uint32_t dig[4] = {0, 0, 0, 0};
        split4(u.x, c.delta, 0, dig);
        split4(u.y, c.delta, 1, dig);
        split4(u.z, c.delta, 2, dig);
        split4(u.w, c.delta, 3, dig);
#pragma unroll
        for (int d = 0; d < 4; ++d)
          *reinterpret_cast<uint32_t*>(DATA + d * L::DQ_PLANE
                                       + r * L::DQ_ROW + 4 * k4) = dig[d];
      }
    }
    __syncthreads();
    // -- stage b: product, recombination, canonical store ----------------
    auto store = [&](int row, int col, uint32_t v0, uint32_t v1) {
      *reinterpret_cast<int2*>(out + base + (size_t)row * N2 + col) =
          make_int2((int)canon(v0, c.q), (int)canon(v1, c.q));
    };
    if (!INV)
      stage<N2, N2>(DATA, L::DP_ROW, L::DP_PLANE, T2, L::T2_ROW, L::T2_PLANE,
                    c, store);
    else
      stage<N1, N2>(T1, T1_ROW, L::T1_PLANE, DATA, L::DQ_ROW, L::DQ_PLANE, c,
                    store);
  }
}

template <int N2, bool INV>
int launch(const void* x, int x64, const void* t1, const void* t2,
           const void* tw, void* out, int B, const Consts& c,
           cudaStream_t stream) {
  auto kern = ntt4_kernel<N2, INV>;
  const int smem = Layout<N2>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, THREADS, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = B < sms * per_sm ? B : sms * per_sm;
  kern<<<grid, THREADS, smem, stream>>>(
      x, x64, static_cast<const uint8_t*>(t1), static_cast<const uint8_t*>(t2),
      static_cast<const uint4*>(tw), static_cast<int*>(out), B, c);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (bound with ctypes in ops/ntt4_fused.py). x: [B, 64 * n2]
// int32 (x_is_int64 = 0) or int64 (its low 32 bits, as .to(torch.int32)
// keeps them), any value, taken as its residue mod q; contiguous; t1, t2:
// the digit planes of the 64 x 64 and n2 x n2 tables; tw: the stage-a
// twiddles with their Shoup companions, [64][n2 / 2] x (tw[c], tw[c+1],
// tws[c], tws[c+1]) uint32; out: [B, 64 * n2] int32. consts: q, delta,
// 2^16, 2^24, 2^40 mod q with
// their Shoup companions, and the correction constant (9 uint32). Returns
// the cudaError_t of the launch; 0 = launched.
extern "C" int pfh_ntt4_transform(const void* x, int x_is_int64,
                                  const void* t1, const void* t2,
                                  const void* tw, void* out, int B, int n2,
                                  int inverse, const unsigned int* consts,
                                  void* stream) {
  Consts c;
  c.q = consts[0];
  c.delta = consts[1];
  c.w2c = consts[2];
  c.w2s = consts[3];
  c.w34c = consts[4];
  c.w34s = consts[5];
  c.w56c = consts[6];
  c.w56s = consts[7];
  c.corr = consts[8];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n2 == 64)
    return inverse ? launch<64, true>(x, x_is_int64, t1, t2, tw, out, B, c, s)
                   : launch<64, false>(x, x_is_int64, t1, t2, tw, out, B, c, s);
  if (n2 == 128)
    return inverse
               ? launch<128, true>(x, x_is_int64, t1, t2, tw, out, B, c, s)
               : launch<128, false>(x, x_is_int64, t1, t2, tw, out, B, c, s);
  return (int)cudaErrorInvalidValue;
}
