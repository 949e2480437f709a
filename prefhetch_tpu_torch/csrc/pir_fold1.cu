// The PIR dim-1 fold on Hopper (sm_90a): every selector set of a program
// folded against one pass over the packed database, its sums in registers
// from the first database row to the last.
//
// Replaces no TPU kernel: the JAX program's fold is a lax.scan of modmuls
// (prefhetch_tpu/engine/pir_device.py:454-479), and the port ran it as
// 177 launches of an int64 addcmul_ that read and rewrote a 2.55 GB
// accumulator each. For each limb l and NTT coefficient n it computes
//
//   out[s, c, j, l, n] = sum_i sel[s, i, c, l, n] * db[i, j, l, n]  mod q_l
//
// sel [S, rows, 2, L, N] and db [rows, g2, L, N] int32 canonical residues
// (any outer strides, inner dims contiguous), out [S, 2, g2, L, N] int32
// canonical. Every coefficient n is an independent small modular matrix
// product C[(s, c), j] = sum_i A[(s, c), i] B[i, j], with n innermost in
// every operand.
//
// What bounds it on an H100: at the 100-row fetch (S = 110, rows = g2 =
// 177, L = 2, N = 4096) 56.5 G multiply-adds of 30-bit residues into 64-bit
// sums, one mad.wide.u32 each (IMAD.WIDE.U32), bound by how fast those
// issue: this loop with its loads taken out ran at 3.3 T a second (~17 ms,
// about 12.5 a clock an SM). Its bytes (the database once, each selector
// read and each sum written once: 3.6 GB) take 1.07 ms at 3.35 TB/s. The
// design:
//   - a thread owns one (l, n) and a register tile of 2*SETS (set,
//     component) rows x COLS columns of u64 sums, so a row i costs it
//     2*SETS + COLS loads for 2*SETS*COLS products; a warp is 32
//     consecutive n, so every load and store is one coalesced 128 B line;
//     8 x 4 sums take 126 registers, four blocks an SM (8 x 8 took 252,
//     two blocks, and ran 20% slower; 4 x 8 and 6 x 4 fell between);
//   - the loads of row i+1 are issued before the products of row i;
//   - every SPAN rows each sum is folded lazily, x = hi 2^32 + lo ->
//     hi c + lo (c = 2^32 mod q), twice: any u64 drops below 2^60 + 2^32
//     (q < 2^30), so SPAN = 14 more products below 2^60 cannot wrap
//     (15 * 2^60 + 2^32 < 2^64); one % q a sum at the end;
//   - a block is 2 x 2 warps: two set tiles by two column tiles of the
//     same 32 coefficients, so each load is shared by two warps in L1; the
//     blocks of one 32-coefficient chunk are consecutive in the grid and
//     run together, so the re-reads of the selectors (once a column tile)
//     and of the database (once a set tile) are L2 hits;
//   - ragged S and g2 edges are clamped to the last set or column (loads
//     stay in bounds, no branch in the loop) and masked at the store; a
//     warp whose tile lies wholly past the edge returns at once.
//
// Grid: (set pairs x column pairs, N / 32, L). 128 threads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 32;       // consecutive coefficients n, one a thread
constexpr int SETS = 4;         // selector sets a thread: 2 * SETS rows
constexpr int ROWS = 2 * SETS;  // (set, component) rows a thread
constexpr int COLS = 4;         // database columns j a thread
constexpr int WARPS = 4;        // 2 set tiles x 2 column tiles a block
constexpr int SPAN = 14;        // products summed between lazy folds
constexpr int MAX_LIMBS = 8;

struct Moduli {
  uint32_t q[MAX_LIMBS];
  uint32_t c[MAX_LIMBS];        // 2^32 mod q
};

// congruent to x mod q: hi * 2^32 + lo == hi * c + lo
__device__ __forceinline__ uint64_t fold(uint64_t x, uint32_t c) {
  return (uint64_t)(uint32_t)(x >> 32) * c + (uint32_t)x;
}

__device__ __forceinline__ void load_row(const uint32_t* const (&sp)[SETS],
                                         const uint32_t* dp,
                                         const int (&jo)[COLS], int LN,
                                         uint32_t (&x)[ROWS],
                                         uint32_t (&y)[COLS]) {
#pragma unroll
  for (int a = 0; a < SETS; ++a) {
    x[2 * a] = __ldg(sp[a]);
    x[2 * a + 1] = __ldg(sp[a] + LN);
  }
#pragma unroll
  for (int b = 0; b < COLS; ++b) y[b] = __ldg(dp + jo[b]);
}

__global__ void __launch_bounds__(LANES * WARPS, 4)
fold1_kernel(const uint32_t* __restrict__ sel,
             const uint32_t* __restrict__ db, uint32_t* __restrict__ out,
             int S, int rows, int g2, int L, int N, long long set_stride,
             long long sel_row_stride, long long db_row_stride,
             int col_pairs, Moduli mod) {
  const int warp = threadIdx.y;
  const int s0 = (2 * (blockIdx.x / col_pairs) + (warp & 1)) * SETS;
  const int j0 = (2 * (blockIdx.x % col_pairs) + (warp >> 1)) * COLS;
  if (s0 >= S || j0 >= g2) return;
  const int l = blockIdx.z;
  const int ln = l * N + blockIdx.y * LANES + threadIdx.x;
  const int LN = L * N;
  const uint32_t q = mod.q[l], c = mod.c[l];

  const uint32_t* sp[SETS];
#pragma unroll
  for (int a = 0; a < SETS; ++a)
    sp[a] = sel + (long long)min(s0 + a, S - 1) * set_stride + ln;
  int jo[COLS];
#pragma unroll
  for (int b = 0; b < COLS; ++b) jo[b] = min(j0 + b, g2 - 1) * LN;
  const uint32_t* dp = db + ln;

  uint64_t acc[ROWS][COLS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int b = 0; b < COLS; ++b) acc[r][b] = 0;

  uint32_t x[ROWS], y[COLS];
  load_row(sp, dp, jo, LN, x, y);
  int left = SPAN;
  for (int i = 0; i < rows; ++i) {
    if (i + 1 < rows) {         // else reload the last row, unused
#pragma unroll
      for (int a = 0; a < SETS; ++a) sp[a] += sel_row_stride;
      dp += db_row_stride;
    }
    uint32_t xn[ROWS], yn[COLS];
    load_row(sp, dp, jo, LN, xn, yn);
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int b = 0; b < COLS; ++b) acc[r][b] += (uint64_t)x[r] * y[b];
    if (--left == 0) {
      left = SPAN;
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int b = 0; b < COLS; ++b)
          acc[r][b] = fold(fold(acc[r][b], c), c);
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) x[r] = xn[r];
#pragma unroll
    for (int b = 0; b < COLS; ++b) y[b] = yn[b];
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int s = s0 + r / 2;
    if (s >= S) break;
    uint32_t* o = out + ((size_t)(2 * s + r % 2) * g2 + j0) * LN + ln;
#pragma unroll
    for (int b = 0; b < COLS; ++b)
      if (j0 + b < g2)
        o[(size_t)b * LN] = (uint32_t)(fold(fold(acc[r][b], c), c) % q);
  }
}

}  // namespace

// C interface (bound with ctypes in ops/pir_fold.py). Strides in elements;
// qs holds L moduli below 2^30. Returns the cudaError_t of the launch
// (0 = launched).
extern "C" int pfh_pir_fold1(const void* sel, const void* db, void* out,
                             int S, int rows, int g2, int L, int N,
                             long long set_stride, long long sel_row_stride,
                             long long db_row_stride, const unsigned int* qs,
                             void* stream) {
  if (L < 1 || L > MAX_LIMBS || N % LANES != 0 || S < 1 || rows < 1 ||
      g2 < 1)
    return (int)cudaErrorInvalidValue;
  Moduli mod;
  for (int l = 0; l < L; ++l) {
    mod.q[l] = qs[l];
    mod.c[l] = (uint32_t)((1ull << 32) % qs[l]);
  }
  const int set_pairs = ((S + SETS - 1) / SETS + 1) / 2;
  const int col_pairs = ((g2 + COLS - 1) / COLS + 1) / 2;
  dim3 grid(set_pairs * col_pairs, N / LANES, L);
  dim3 block(LANES, WARPS);
  fold1_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(sel), static_cast<const uint32_t*>(db),
      static_cast<uint32_t*>(out), S, rows, g2, L, N, set_stride,
      sel_row_stride, db_row_stride, col_pairs, mod);
  return (int)cudaGetLastError();
}
