// The rotation step's modular arithmetic on Hopper (sm_90a): the three
// kernels of one hybrid key switch around K2's transforms (ops/key_switch.py,
// called by engine/hecompute.py rotate_add).
//
// Replaces no TPU kernel: the JAX key switch is jnp (prefhetch_tpu/engine/
// hecompute.py, pir_device.py, ckks_device.py), and the port ran it as ~88
// eager int64 PyTorch operations a round, each writing and reading back an
// int64 intermediate: the digit planes' stack, two [M, n_comp, N] int64
// products a prime, their sums, a cat, the centred division by the special
// prime with four int64 % a limb, two stacks and the final adds. A round of
// one key set is now, with l active primes, q_e the l + 1 primes of the
// extension basis (the special prime p = q_l last) and σ the round's signed
// automorphism (out[k] = ±y[perm[k]], negated where neg[k] and y != 0):
//
//   digits: D[m, i·nd + j] = (σ(y1)[m, i] >> j·bits) & (2^bits - 1),
//           int32, in the [M·n_comp, N] layout K2's forward takes;
//   for each e: K2 forward of D mod q_e (unchanged), then
//   mac:    s[m]     = Σ_c D[m, c] · kb[c, e]  mod q_e,
//           s[M + m] = Σ_c D[m, c] · ka[c, e]  mod q_e, int32 [2M, N];
//           K2 inverse of s (unchanged);
//   finish: ks_h[i] = (a_h[i] - centred(a_h[l])) · p^-1  mod q_i for the
//           inverses a_0 = rows [0, M), a_1 = rows [M, 2M) of each prime;
//           z0 = x0 + σ(y0) + ks_0,  z1 = x1 + ks_1  mod q_i, in x's
//           storage dtype (int32 for PIR, int64 for the packed and CKKS
//           programs: the template parameter T).
//
// Every operand is a canonical residue below 2^30. What bounds these kernels
// on an H100 is bytes: each reads its operands once and writes its results
// once, int32 (~0.65 MB a PIR ciphertext-round outside K2). The design:
//   - digits and finish: a block per (ciphertext, limb) row; the row of y is
//     read coalesced into shared memory and the automorphism gathers from
//     there, so the gather costs no scattered device-memory reads;
//   - mac: a thread owns one coefficient of MT ciphertexts, its 2·MT sums
//     in registers as u64, and reads each key value once for the MT; every
//     product of residues below 2^30 is below 2^60, so SPAN = 14 products
//     sit on a sum folded twice (x = hi 2^32 + lo -> hi c + lo, c = 2^32
//     mod q: below 2^60 + 2^32 + 2^30) without wrapping (15 · 2^60 + 2^33 <
//     2^64); each sum leaves reduced once by Barrett (mu = floor(2^64 / q):
//     x - umulhi(x, mu) q lies in [0, 2q));
//   - finish: the centred division by p with exact 32-bit arithmetic, no
//     float and no 64-bit %: t = a + (v > p/2 ? p - v : pad - v) (pad = the
//     least multiple of q_i not below p) is congruent to a - centred(v) and
//     below 2^32, and t · p^-1 mod q_i is one Shoup multiply (w = floor(p^-1
//     2^32 / q_i)); the sums < 3 q_i < 2^32 take conditional subtractions.
//
// Grids: digits and finish M·l blocks of THREADS; mac ceil(M / MT) ·
// ceil(N / THREADS) blocks of THREADS.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MT = 4;           // ciphertexts a thread of the mac
constexpr int SPAN = 14;        // products summed between lazy folds
constexpr int MAX_PRIMES = 8;   // extension primes (l + 1) at most
constexpr int MAX_N = 8192;     // a row of int64 in 64 KB of shared memory

struct DigitConsts {
  uint32_t q[MAX_PRIMES];
};

struct MacConsts {
  uint64_t mu;                  // floor(2^64 / q)
  uint32_t q;
  uint32_t c;                   // 2^32 mod q
};

struct FinishConsts {
  const uint32_t* part[MAX_PRIMES];  // the l + 1 inverses, [2M, N] each
  uint32_t q[MAX_PRIMES];
  uint32_t inv[MAX_PRIMES];     // p^-1 mod q_i
  uint32_t shoup[MAX_PRIMES];   // floor(inv 2^32 / q_i)
  uint32_t pad[MAX_PRIMES];     // the least multiple of q_i not below p
  uint32_t p;
  uint32_t p_half;              // floor(p / 2)
};

// congruent to x mod q: hi * 2^32 + lo == hi * c + lo
__device__ __forceinline__ uint64_t fold(uint64_t x, uint32_t c) {
  return (uint64_t)(uint32_t)(x >> 32) * c + (uint32_t)x;
}

__device__ __forceinline__ uint32_t barrett(uint64_t x, uint32_t q,
                                            uint64_t mu) {
  const uint64_t r = x - __umul64hi(x, mu) * q;
  return (uint32_t)(r >= q ? r - q : r);
}

// (a - centred(v)) · p^-1 mod q, centred(v) the residue of v mod p in
// (-p/2, p/2]
__device__ __forceinline__ uint32_t divide(uint32_t a, uint32_t v,
                                           const FinishConsts& c, int i) {
  const uint32_t t = a + (v > c.p_half ? c.p - v : c.pad[i] - v);
  const uint32_t r = t * c.inv[i] - __umulhi(t, c.shoup[i]) * c.q[i];
  return r >= c.q[i] ? r - c.q[i] : r;
}

// the signed automorphism of one residue, gathered from the row in shared
// memory
template <typename T>
__device__ __forceinline__ T signed_at(const T* row, const long long* perm,
                                       const bool* neg, int k, T q) {
  const T v = row[__ldg(perm + k)];
  return (neg[k] && v != 0) ? q - v : v;
}

template <typename T>
__device__ __forceinline__ void load_row(T* row, const T* src, int N) {
  for (int k = threadIdx.x; k < N; k += THREADS) row[k] = src[k];
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
digits_kernel(const T* __restrict__ y, const long long* __restrict__ perm,
              const bool* __restrict__ neg, uint32_t* __restrict__ out,
              int l, int N, int bits, int n_digits, DigitConsts c) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* row = reinterpret_cast<T*>(smem);
  const long long mi = blockIdx.x;          // m·l + i
  load_row(row, y + mi * N, N);
  const T q = (T)c.q[mi % l];
  const T mask = (T)((1u << bits) - 1);
  // rows (m·l + i)·nd + j = m·n_comp + i·nd + j
  uint32_t* o = out + mi * n_digits * N;
  for (int k = threadIdx.x; k < N; k += THREADS) {
    const T s = signed_at(row, perm, neg, k, q);
    for (int j = 0; j < n_digits; ++j)
      o[(long long)j * N + k] = (uint32_t)((s >> (j * bits)) & mask);
  }
}

__global__ void __launch_bounds__(THREADS)
mac_kernel(const uint32_t* __restrict__ d, const uint32_t* __restrict__ kb,
           const uint32_t* __restrict__ ka, long long kb_stride,
           long long ka_stride, uint32_t* __restrict__ out, int M,
           int n_comp, int N, int chunks, MacConsts c) {
  const int k = (blockIdx.x % chunks) * THREADS + threadIdx.x;
  const int m0 = (blockIdx.x / chunks) * MT;
  if (k >= N) return;
  const uint32_t* dp[MT];
#pragma unroll
  for (int j = 0; j < MT; ++j)              // ragged edge: clamped, masked
    dp[j] = d + (long long)min(m0 + j, M - 1) * n_comp * N + k;
  uint64_t sb[MT], sa[MT];
#pragma unroll
  for (int j = 0; j < MT; ++j) sb[j] = sa[j] = 0;
  int left = SPAN;
  for (int cc = 0; cc < n_comp; ++cc) {
    const uint32_t b = __ldg(kb + cc * kb_stride + k);
    const uint32_t a = __ldg(ka + cc * ka_stride + k);
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      const uint32_t x = __ldg(dp[j] + (long long)cc * N);
      sb[j] += (uint64_t)x * b;
      sa[j] += (uint64_t)x * a;
    }
    if (--left == 0) {
      left = SPAN;
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        sb[j] = fold(fold(sb[j], c.c), c.c);
        sa[j] = fold(fold(sa[j], c.c), c.c);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < MT; ++j) {
    const long long m = m0 + j;
    if (m >= M) break;
    out[m * N + k] = barrett(sb[j], c.q, c.mu);
    out[(M + m) * N + k] = barrett(sa[j], c.q, c.mu);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
finish_kernel(const T* __restrict__ x0, const T* __restrict__ x1,
              const T* __restrict__ y0, const long long* __restrict__ perm,
              const bool* __restrict__ neg, T* __restrict__ z0,
              T* __restrict__ z1, int M, int l, int N, FinishConsts c) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* row = reinterpret_cast<T*>(smem);
  const long long mi = blockIdx.x;          // m·l + i
  const int i = (int)(mi % l);
  const long long m = mi / l;
  load_row(row, y0 + mi * N, N);
  const uint32_t q = c.q[i];
  const uint32_t* a0 = c.part[i] + m * N;
  const uint32_t* a1 = c.part[i] + (M + m) * N;
  const uint32_t* v0 = c.part[l] + m * N;
  const uint32_t* v1 = c.part[l] + (M + m) * N;
  const long long at = mi * N;
  for (int k = threadIdx.x; k < N; k += THREADS) {
    const uint32_t g = (uint32_t)signed_at(row, perm, neg, k, (T)q);
    uint32_t s0 = (uint32_t)x0[at + k] + g;
    s0 = s0 >= q ? s0 - q : s0;
    s0 += divide(a0[k], v0[k], c, i);
    s0 = s0 >= q ? s0 - q : s0;
    uint32_t s1 = (uint32_t)x1[at + k] + divide(a1[k], v1[k], c, i);
    s1 = s1 >= q ? s1 - q : s1;
    z0[at + k] = (T)s0;
    z1[at + k] = (T)s1;
  }
}

// dynamic shared memory above the default 48 KB is granted per kernel
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T>
int launch_digits(const void* y, const void* perm, const void* neg,
                  void* out, int M, int l, int N, int bits, int n_digits,
                  const DigitConsts& c, cudaStream_t stream) {
  const size_t smem = (size_t)N * sizeof(T);
  cudaError_t err = allow_smem(digits_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  digits_kernel<T><<<(unsigned)M * l, THREADS, smem, stream>>>(
      static_cast<const T*>(y), static_cast<const long long*>(perm),
      static_cast<const bool*>(neg), static_cast<uint32_t*>(out), l, N, bits,
      n_digits, c);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_finish(const void* x0, const void* x1, const void* y0,
                  const void* perm, const void* neg, void* z0, void* z1,
                  int M, int l, int N, const FinishConsts& c,
                  cudaStream_t stream) {
  const size_t smem = (size_t)N * sizeof(T);
  cudaError_t err = allow_smem(finish_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  finish_kernel<T><<<(unsigned)M * l, THREADS, smem, stream>>>(
      static_cast<const T*>(x0), static_cast<const T*>(x1),
      static_cast<const T*>(y0), static_cast<const long long*>(perm),
      static_cast<const bool*>(neg), static_cast<T*>(z0),
      static_cast<T*>(z1), M, l, N, c);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (bound with ctypes in ops/key_switch.py). Moduli below 2^30,
// 1 <= l < MAX_PRIMES, 1 <= N <= MAX_N, 1 <= bits <= 30; wide says the
// storage dtype is int64 (else int32); perm int64 and neg bool [N]. Each
// returns the cudaError_t of its launch (0 = launched).
extern "C" int pfh_ks_digits(const void* y, int wide, const void* perm,
                             const void* neg, void* out, int M, int l, int N,
                             int bits, const unsigned int* qs, void* stream) {
  if (M < 1 || l < 1 || l >= MAX_PRIMES || N < 1 || N > MAX_N || bits < 1 ||
      bits > 30)
    return (int)cudaErrorInvalidValue;
  DigitConsts c;
  for (int i = 0; i < l; ++i) c.q[i] = qs[i];
  const int n_digits = (30 + bits - 1) / bits;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return wide ? launch_digits<int64_t>(y, perm, neg, out, M, l, N, bits,
                                       n_digits, c, s)
              : launch_digits<int32_t>(y, perm, neg, out, M, l, N, bits,
                                       n_digits, c, s);
}

// kb, ka: n_comp rows of N, rows kb_stride / ka_stride elements apart; q's
// constants c = 2^32 mod q and mu = floor(2^64 / q)
extern "C" int pfh_ks_mac(const void* d, const void* kb, const void* ka,
                          long long kb_stride, long long ka_stride, void* out,
                          int M, int n_comp, int N, unsigned int q,
                          unsigned int c, unsigned long long mu,
                          void* stream) {
  if (M < 1 || n_comp < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const MacConsts mc{mu, q, c};
  const int chunks = (N + THREADS - 1) / THREADS;
  const long long blocks = (long long)((M + MT - 1) / MT) * chunks;
  mac_kernel<<<(unsigned)blocks, THREADS, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(d), static_cast<const uint32_t*>(kb),
      static_cast<const uint32_t*>(ka), kb_stride, ka_stride,
      static_cast<uint32_t*>(out), M, n_comp, N, chunks, mc);
  return (int)cudaGetLastError();
}

// parts: the l + 1 inverses [2M, N] int32; consts [4][l]: q_i, p^-1 mod q_i,
// its Shoup constant, pad_i; p the special prime
extern "C" int pfh_ks_finish(const void* const* parts, const void* x0,
                             const void* x1, const void* y0, int wide,
                             const void* perm, const void* neg, void* z0,
                             void* z1, int M, int l, int N,
                             const unsigned int* consts, unsigned int p,
                             void* stream) {
  if (M < 1 || l < 1 || l >= MAX_PRIMES || N < 1 || N > MAX_N)
    return (int)cudaErrorInvalidValue;
  FinishConsts c;
  for (int e = 0; e <= l; ++e)
    c.part[e] = static_cast<const uint32_t*>(parts[e]);
  for (int i = 0; i < l; ++i) {
    c.q[i] = consts[i];
    c.inv[i] = consts[l + i];
    c.shoup[i] = consts[2 * l + i];
    c.pad[i] = consts[3 * l + i];
  }
  c.p = p;
  c.p_half = p / 2;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return wide ? launch_finish<int64_t>(x0, x1, y0, perm, neg, z0, z1, M, l,
                                       N, c, s)
              : launch_finish<int32_t>(x0, x1, y0, perm, neg, z0, z1, M, l,
                                       N, c, s);
}
