// Host math of the PyTorch port: the fvecs/ivecs reader and the negacyclic
// NTT with Shoup multiplication.
//
// A copy of sections 1 and 3 of native/prefhetch_native.cpp (the JAX
// package's host library), with one change: the NTT and the pointwise
// product take any int64 value. The JAX copy reads a negative int64 as
// x + 2^64, whose residue mod q is not x's; here a negative value is first
// lifted by a multiple of q (``lift``), so every input gives the result of
// its residue, as the numpy butterfly (crypto/ntt.py) does.
//
// Built as a shared library with g++ at first use, bound with ctypes
// (prefhetch_tpu_torch/native/__init__.py). The JSON codec (section 2) is
// json_codec.cpp.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <sys/mman.h>
#include <sys/stat.h>
#include <fcntl.h>
#include <unistd.h>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// 1. vecs IO
// Returns 0 on success. Two-phase: header() gives (d, n) so the caller can
// allocate, then read() fills a contiguous [n, d] buffer.
int pfh_vecs_header(const char* path, int64_t* d_out, int64_t* n_out) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    int32_t d;
    if (fread(&d, sizeof(int32_t), 1, f) != 1) { fclose(f); return -2; }
    if (d <= 0 || d >= 1000000) { fclose(f); return -3; }
    struct stat st;
    if (fstat(fileno(f), &st) != 0) { fclose(f); return -4; }
    fclose(f);
    const int64_t row = (int64_t)(d + 1) * 4;
    if (st.st_size % row != 0) return -5;
    *d_out = d;
    *n_out = st.st_size / row;
    return 0;
}

// payload is copied with the 4-byte row headers stripped (works for both
// fvecs (float32) and ivecs (int32) — payload is 4 bytes either way).
int pfh_vecs_read(const char* path, void* out, int64_t n, int64_t d) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return -1;
    struct stat st;
    if (fstat(fd, &st) != 0) { close(fd); return -2; }
    const int64_t row = (d + 1) * 4;
    if (st.st_size != n * row) { close(fd); return -3; }
    const char* src = (const char*)mmap(nullptr, st.st_size, PROT_READ,
                                        MAP_PRIVATE, fd, 0);
    if (src == MAP_FAILED) { close(fd); return -4; }
    char* dst = (char*)out;
    for (int64_t i = 0; i < n; i++) {
        // verify per-row header
        int32_t hdr;
        memcpy(&hdr, src + i * row, 4);
        if (hdr != (int32_t)d) {
            munmap((void*)src, st.st_size);
            close(fd);
            return -5;
        }
        memcpy(dst + i * d * 4, src + i * row + 4, d * 4);
    }
    munmap((void*)src, st.st_size);
    close(fd);
    return 0;
}

// ---------------------------------------------------------------------------
// 3. negacyclic NTT, Shoup multiplication
// Tables are passed in from python:
//   psi_all   [N]  — forward ψ^k twist (or ψ^{-k}·N^{-1} for inverse)
//   tw        [N-1] — per-stage twiddles concatenated (stage s has 2^s)
//   tw_shoup  [N-1] — floor(tw·2^64 / q)
//   bitrev    [N]
// Operates in place on x [B, N] int64; any value is taken as its residue
// mod q, and the output is canonical [0, q).

static inline uint64_t mulmod_shoup(uint64_t a, uint64_t w, uint64_t wsh,
                                    uint64_t q) {
    const uint64_t hi = (uint64_t)(((__uint128_t)a * wsh) >> 64);
    uint64_t r = a * w - hi * q;
    if (r >= q) r -= q;
    return r;
}

// v ≥ 0 as itself; v < 0 as v + up, with up = q·⌈2^63/q⌉ (computed mod
// 2^64, where it wraps v's two's complement back), so the result is
// congruent to v mod q and below 2^63 + q. Shoup's product takes any
// a < 2^64, and an inverse butterfly keeps its even input below that bound
// (an even input ≥ q comes out smaller), so the last twist leaves every
// output canonical.
static inline uint64_t lift(int64_t v, uint64_t up) {
    return (uint64_t)v + (v < 0 ? up : 0);
}

static void ntt_rows(int64_t* x, int64_t b0, int64_t b1, int64_t N, uint64_t q,
                     const int64_t* psi, const int64_t* psi_sh,
                     const int64_t* tw, const int64_t* tw_sh,
                     const int64_t* bitrev, int twist_first) {
    const int64_t logN = __builtin_ctzll((uint64_t)N);
    const uint64_t up = ((1ULL << 63) / q + 1) * q;
    std::vector<int64_t> tmp(N);
    for (int64_t b = b0; b < b1; b++) {
        int64_t* row = x + b * N;
        if (twist_first) {
            for (int64_t k = 0; k < N; k++)
                row[k] = (int64_t)mulmod_shoup(lift(row[k], up),
                                               (uint64_t)psi[k],
                                               (uint64_t)psi_sh[k], q);
        }
        // bit-reverse permute
        if (twist_first) {
            for (int64_t k = 0; k < N; k++) tmp[k] = row[bitrev[k]];
        } else {
            for (int64_t k = 0; k < N; k++)
                tmp[k] = (int64_t)lift(row[bitrev[k]], up);
        }
        memcpy(row, tmp.data(), N * sizeof(int64_t));
        // butterflies
        int64_t off = 0;
        for (int64_t s = 0; s < logN; s++) {
            const int64_t m = 1LL << s;
            for (int64_t blk = 0; blk < N; blk += 2 * m) {
                for (int64_t j = 0; j < m; j++) {
                    const uint64_t w = (uint64_t)tw[off + j];
                    const uint64_t wsh = (uint64_t)tw_sh[off + j];
                    const uint64_t even = (uint64_t)row[blk + j];
                    const uint64_t odd = mulmod_shoup(
                        (uint64_t)row[blk + m + j], w, wsh, q);
                    uint64_t t0 = even + odd;
                    if (t0 >= q) t0 -= q;
                    uint64_t t1 = even + q - odd;
                    if (t1 >= q) t1 -= q;
                    row[blk + j] = (int64_t)t0;
                    row[blk + m + j] = (int64_t)t1;
                }
            }
            off += m;
        }
        if (!twist_first) {
            for (int64_t k = 0; k < N; k++)
                row[k] = (int64_t)mulmod_shoup((uint64_t)row[k],
                                               (uint64_t)psi[k],
                                               (uint64_t)psi_sh[k], q);
        }
    }
}

void pfh_ntt_batch(int64_t* x, int64_t B, int64_t N, int64_t q,
                   const int64_t* psi, const int64_t* psi_sh,
                   const int64_t* tw, const int64_t* tw_sh,
                   const int64_t* bitrev, int twist_first, int n_threads) {
    if (n_threads <= 1 || B == 1) {
        ntt_rows(x, 0, B, N, (uint64_t)q, psi, psi_sh, tw, tw_sh, bitrev,
                 twist_first);
        return;
    }
    std::vector<std::thread> ts;
    const int64_t per = (B + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; t++) {
        const int64_t b0 = t * per;
        const int64_t b1 = b0 + per < B ? b0 + per : B;
        if (b0 >= b1) break;
        ts.emplace_back(ntt_rows, x, b0, b1, N, (uint64_t)q, psi, psi_sh,
                        tw, tw_sh, bitrev, twist_first);
    }
    for (auto& th : ts) th.join();
}

// pointwise modular multiply: out = a * b mod q (Shoup on b, b in [0, q))
void pfh_pointwise_mulmod(int64_t* out, const int64_t* a, const int64_t* b,
                          const int64_t* b_sh, int64_t n, int64_t q) {
    const uint64_t up = ((1ULL << 63) / (uint64_t)q + 1) * (uint64_t)q;
    for (int64_t i = 0; i < n; i++)
        out[i] = (int64_t)mulmod_shoup(lift(a[i], up), (uint64_t)b[i],
                                       (uint64_t)b_sh[i], (uint64_t)q);
}

}  // extern "C"
