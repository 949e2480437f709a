// The tile schedule of kernels K4 and K5: a batch's flat (query, probe
// slot) pairs sorted by tile id, stably, in one launch, for Hopper (sm_90a).
//
// K4 and K5 (csrc/slab_scan.cu) are tile-major: the pairs that probe one
// tile share one read of it, so they need the pairs grouped by tile. The
// TPU kernels they replace (prefhetch_tpu/ops/pallas_scan.py
// pallas_slab_distances_sq8 and pallas_slab_distances, grids at :123 and
// :183) walk the pairs in their own order on one core and need no such
// order. For keys = probe_ids, P flat int32 tile ids, each < n_tiles:
//
//     tiles[i] = keys[order[i]], order a stable sort of the pairs by key:
//                bit-equal to torch.sort(keys, stable=True) (int16 or
//                int32 values, int64 indices)
//     pieces   (with chunk > 0) each run of one key cut into pieces of at
//                most `chunk` pairs, in order: pieces[0] = their count,
//                pieces[1 + 2p], pieces[2 + 2p] = start and length of
//                piece p (K5's blocks, one piece each)
//
// How: one block of 1024 threads, a counting sort over SEGS contiguous
// segments of the keys, so that 32 / SEGS warps place each segment at once.
//   1. The keys are staged in shared memory (up to KEYS_SMEM of them) and
//      counted by shared-memory atomics, one count per (segment, key).
//   2. Exclusive scan of the keys' totals and, beside them, of the pieces
//      each total makes: a thread owns a contiguous range of keys, the
//      block scans the 1024 ranges' sums, and each thread turns its keys'
//      counts into cursors, segment s of key k starting after the pairs of
//      k in the segments before s.
//   3. Stable scatter: warp w places segment w / CLASSES, and of it the
//      keys k with k % CLASSES == w % CLASSES, reading that segment in
//      order 32 keys at a time; the lanes holding one of its keys rank
//      themselves among equal keys of the window with __match_any_sync,
//      and the first of them advances that key's cursor. A (segment, key)
//      is placed by one warp, in order: equal keys keep their order, with
//      no atomics. The loop touches shared memory only (a place per staged
//      key): a __syncwarp that had global stores before it would wait for
//      them, window after window.
//   4. The pairs are moved to their places in shared memory, then written
//      out in sorted order (coalesced), and a pair that starts a piece (its
//      rank in its key's run a multiple of chunk) writes that piece.
// The counts live in shared memory where they fit (every preset view:
// 1,474 tiles at T=1024, 4,419 at T=256), else in the wrapper's global
// scratch (pfh_tile_schedule_scratch says how much). Past KEYS_SMEM pairs
// the keys are read from, and the pairs written to, device memory in the
// loop itself: right, but slower.
// What bounds it: latency, not bytes (a 3,072-pair batch moves 43 KB): the
// block's start, one round trip for the keys, a few barriers' worth of
// shared-memory passes, and P / (32 SEGS) dependent windows a warp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ST = 1024;              // threads of the one block
constexpr int SWARPS = ST / 32;
constexpr int SEGS = 8;               // segments placed at once
constexpr int CLASSES = SWARPS / SEGS;  // key classes a segment is split in
constexpr int KEYS_SMEM = 6144;       // pairs staged in shared memory at most
constexpr int SMEM_MAX = 232448 - 1024;  // dynamic bytes, past the static

// ints of the counts and cursors: SEGS per key, the keys' starts (and the
// total), the keys' first pieces
size_t count_ints(int n_tiles) { return (size_t)(SEGS + 2) * (n_tiles + 1); }

bool counts_in_smem(int n_tiles) {
  return (count_ints(n_tiles) + 2 * KEYS_SMEM) * sizeof(int) <= SMEM_MAX;
}

// Exclusive block-wide scan of two counts at once; returns the totals.
__device__ __forceinline__ void scan2(int a, int b, int& ea, int& eb,
                                      int& ta, int& tb, int* wa, int* wb) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int ia = a, ib = b;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int xa = __shfl_up_sync(0xffffffffu, ia, off);
    const int xb = __shfl_up_sync(0xffffffffu, ib, off);
    if (lane >= off) {
      ia += xa;
      ib += xb;
    }
  }
  if (lane == 31) {
    wa[w] = ia;
    wb[w] = ib;
  }
  __syncthreads();
  if (w == 0) {
    int va = wa[lane], vb = wb[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int xa = __shfl_up_sync(0xffffffffu, va, off);
      const int xb = __shfl_up_sync(0xffffffffu, vb, off);
      if (lane >= off) {
        va += xa;
        vb += xb;
      }
    }
    wa[lane] = va;
    wb[lane] = vb;
  }
  __syncthreads();
  ea = (w > 0 ? wa[w - 1] : 0) + ia - a;
  eb = (w > 0 ? wb[w - 1] : 0) + ib - b;
  ta = wa[SWARPS - 1];
  tb = wb[SWARPS - 1];
}

// Pair i of key k at its place pos; a pair that starts a piece writes it.
template <typename K>
__device__ __forceinline__ void place(int k, int i, int pos, int chunk,
                                      const int* first, const int* pb,
                                      K* __restrict__ tiles,
                                      long long* __restrict__ order,
                                      int* __restrict__ pieces) {
  tiles[pos] = (K)k;
  order[pos] = i;
  const int occ = pos - first[k];                 // rank in k's whole run
  if (pieces != nullptr && occ % chunk == 0) {
    const int p = pb[k] + occ / chunk;
    pieces[1 + 2 * p] = pos;
    pieces[2 + 2 * p] = min(chunk, first[k + 1] - pos);
  }
}

constexpr int PER = (KEYS_SMEM + ST - 1) / ST;  // staged pairs a thread

template <typename K>
__global__ void __launch_bounds__(ST, 1)
tile_schedule_kernel(const int* __restrict__ keys,   // [P]
                     int P, int n_tiles, int chunk,
                     int* gcounts,                   // count_ints or null
                     K* __restrict__ tiles,          // [P]
                     long long* __restrict__ order,  // [P]
                     int* __restrict__ pieces) {     // [1 + 2 bound] or null
  extern __shared__ int smem[];
  __shared__ int wa[SWARPS], wb[SWARPS];
  const int n = n_tiles;
  // cur[s * n + k]: counts of key k in segment s, then its cursor there;
  // first[k]: the start of key k's run (first[n] = the total); pb[k]: the
  // index of its first piece
  int* cur = gcounts != nullptr ? gcounts : smem;
  int* first = cur + SEGS * n;
  int* pb = first + n + 1;
  int* skeys = gcounts != nullptr ? smem : pb + n;  // staged keys
  int* spos = skeys + P;                            // and their places
  const bool staged = P <= KEYS_SMEM;
  const int* kp = staged ? skeys : keys;
  const int tid = threadIdx.x;
  const int S = (P + SEGS - 1) / SEGS;              // keys a segment

  // 1. counts per (segment, key); an id outside [0, n) is skipped
  for (int x = tid; x < SEGS * n; x += ST) cur[x] = 0;
  __syncthreads();
  for (int i = tid; i < P; i += ST) {
    const int k = keys[i];
    if (staged) skeys[i] = k;
    if ((unsigned)k < (unsigned)n) atomicAdd(&cur[(i / S) * n + k], 1);
  }
  __syncthreads();

  // 2. starts, pieces and cursors: thread tid owns keys [lo, hi)
  const int per = (n + ST - 1) / ST;
  const int lo = min(n, tid * per), hi = min(n, lo + per);
  int cnt = 0, pcs = 0;
  for (int k = lo; k < hi; ++k) {
    int c = 0;
#pragma unroll
    for (int s = 0; s < SEGS; ++s) c += cur[s * n + k];
    cnt += c;
    if (chunk > 0) pcs += (c + chunk - 1) / chunk;
  }
  int run, prun, total, total_pcs;
  scan2(cnt, pcs, run, prun, total, total_pcs, wa, wb);
  for (int k = lo; k < hi; ++k) {
    first[k] = run;
    pb[k] = prun;
#pragma unroll
    for (int s = 0; s < SEGS; ++s) {
      const int c = cur[s * n + k];
      cur[s * n + k] = run;
      run += c;
    }
    if (chunk > 0) prun += (run - first[k] + chunk - 1) / chunk;
  }
  if (tid == 0) {
    first[n] = total;
    if (pieces != nullptr) pieces[0] = total_pcs;
  }
  __syncthreads();

  // 3. stable scatter: warp w places the keys k % CLASSES == w % CLASSES
  // of segment w / CLASSES
  const int lane = tid & 31, warp = tid >> 5;
  const int cls = warp % CLASSES, seg = warp / CLASSES;
  const unsigned below = (1u << lane) - 1u;
  const int i0 = seg * S, i1 = min(P, i0 + S);
  int* scur = cur + seg * n;
  int k_next = i0 + lane < i1 ? kp[i0 + lane] : -1;
  for (int base = i0; base < i1; base += 32) {
    const int i = base + lane;
    const int k = k_next;
    k_next = i + 32 < i1 ? kp[i + 32] : -1;
    const bool mine = i < i1 && (unsigned)k < (unsigned)n
                      && k % CLASSES == cls;
    const unsigned same = __match_any_sync(0xffffffffu, mine ? k : -1);
    int rank = 0, start = 0;
    if (mine) {
      rank = __popc(same & below);
      start = scur[k];
      if (staged) spos[i] = start + rank;
      else place(k, i, start + rank, chunk, first, pb, tiles, order, pieces);
    }
    __syncwarp();                 // every lane has read its key's cursor
    if (mine && rank == 0) scur[k] = start + __popc(same);
    __syncwarp();                 // the new cursors are seen next window
  }
  if (!staged) return;

  // 4. the staged pairs to their places in shared memory (skeys and spos
  // become the sorted keys and order), then out in order
  int kk[PER], pos[PER];
  __syncthreads();
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = tid + u * ST;
    kk[u] = i < P ? skeys[i] : -1;
    pos[u] = (unsigned)kk[u] < (unsigned)n ? spos[i] : -1;
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < PER; ++u)
    if (pos[u] >= 0) {
      skeys[pos[u]] = kk[u];
      spos[pos[u]] = tid + u * ST;
    }
  __syncthreads();
  for (int p = tid; p < first[n]; p += ST)
    place(skeys[p], spos[p], p, chunk, first, pb, tiles, order, pieces);
}

template <typename K>
int launch(const int* keys, int P, int n_tiles, int chunk, int* gcounts,
           void* tiles, long long* order, int* pieces, cudaStream_t s) {
  const bool in_smem = counts_in_smem(n_tiles);
  if (!in_smem && gcounts == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(int) * (
      (in_smem ? count_ints(n_tiles) : 0) + (P <= KEYS_SMEM ? 2 * P : 0));
  cudaError_t err = cudaFuncSetAttribute(
      tile_schedule_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  tile_schedule_kernel<K><<<1, ST, smem, s>>>(
      keys, P, n_tiles, chunk, in_smem ? nullptr : gcounts,
      static_cast<K*>(tiles), order, pieces);
  return (int)cudaGetLastError();
}

}  // namespace

// C interfaces (bound with ctypes in ops/slab_scan.py).

// The int32 scratch the schedule needs over n_tiles tiles: 0 where its
// counts fit in shared memory.
extern "C" long long pfh_tile_schedule_scratch(int n_tiles) {
  return counts_in_smem(n_tiles) ? 0 : (long long)count_ints(n_tiles);
}

// Returns the cudaError_t of the launch; 0 = launched. keys16 != 0 writes
// the sorted keys as int16 (every id < 32768), else int32. gcounts: int32
// scratch of pfh_tile_schedule_scratch(n_tiles) ints, or null when that is
// 0. pieces: null, or int32 [1 + 2 bound] for chunk > 0.
extern "C" int pfh_tile_schedule(const int* keys, int P, int n_tiles,
                                 int chunk, int keys16, int* gcounts,
                                 void* tiles, long long* order, int* pieces,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pieces != nullptr && chunk <= 0) return (int)cudaErrorInvalidValue;
  if (keys16)
    return launch<int16_t>(keys, P, n_tiles, chunk, gcounts, tiles, order,
                           pieces, s);
  return launch<int32_t>(keys, P, n_tiles, chunk, gcounts, tiles, order,
                         pieces, s);
}
