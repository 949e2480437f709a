// JSON number-array codec of the PyTorch port's serving path.
//
// A copy of section 2 of native/prefhetch_native.cpp (the JAX package's
// host library), kept byte for byte so that both packages write the same
// JSON for the same arrays and either package's client decodes the other's
// responses. Sections 1 and 3 of that file (the vecs reader and the host
// NTT) are host_lib.cpp.
//
// Built as a shared library with g++ at first use, bound with ctypes
// (prefhetch_tpu_torch/native/__init__.py).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// 2. JSON number-array codec
//
// CPython's json module is C-accelerated, so beating it takes more than
// moving the loop to C++: the encoders below use a branchy-digit itoa and
// thread the array across cores; the decoder replaces strtod with the
// Clinger fast path (exact uint64 mantissa ⊙ exact power of ten — always
// correctly rounded when it applies; strtod fallback otherwise) and
// parallelizes by splitting the byte range at comma boundaries.

static inline int itoa_i64(int64_t v, char* out) {
    char tmp[20];
    int tn = 0;
    uint64_t u = v < 0 ? ~(uint64_t)v + 1 : (uint64_t)v;  // safe for INT64_MIN
    do { tmp[tn++] = (char)('0' + u % 10); u /= 10; } while (u);
    int pos = 0;
    if (v < 0) out[pos++] = '-';
    while (tn) out[pos++] = tmp[--tn];
    return pos;
}

// %.9g equivalent for floats that formats the common case (plain decimal,
// |x| in [1e-4, 1e17)) by hand and falls back to snprintf otherwise.
static inline int ftoa_f32(float xf, char* out) {
    double x = (double)xf;
    if (!(x == x) || x > 1.7e308 || x < -1.7e308)          // nan/inf
        return snprintf(out, 24, "null");                   // JSON-safe
    int pos = 0;
    if (x < 0) { out[pos++] = '-'; x = -x; }
    if (x >= 1e17 || (x > 0 && x < 1e-4))
        return pos + snprintf(out + pos, 22, "%.9g", x);
    // 9 significant digits, trailing zeros trimmed — matches %.9g output
    // for this range up to zero-trimming (both reparse to the same f32).
    uint64_t ip = (uint64_t)x;
    double frac = x - (double)ip;
    char ibuf[20];
    int ilen = itoa_i64((int64_t)ip, ibuf);
    memcpy(out + pos, ibuf, ilen);
    pos += ilen;
    int sig_left = 9 - (ip ? ilen : 0);
    if (sig_left <= 0 || frac == 0.0) {
        // verify round-trip; fall back when integer truncation lost bits
        if ((float)ip == xf || frac == 0.0) return pos;
        return (out[0] == '-' ? 1 : 0) + snprintf(out + (out[0] == '-' ? 1 : 0), 22, "%.9g", x);
    }
    // leading zeros of the fraction don't consume significant digits
    int frac_digits = sig_left;
    double scaled = frac;
    if (ip == 0) {
        while (scaled < 0.1 && frac_digits < 17) { frac_digits++; scaled *= 10; }
    }
    static const double P10[18] = {1,10,100,1000,1e4,1e5,1e6,1e7,1e8,1e9,
                                   1e10,1e11,1e12,1e13,1e14,1e15,1e16,1e17};
    uint64_t fdig = (uint64_t)(frac * P10[frac_digits] + 0.5);
    if (fdig >= (uint64_t)P10[frac_digits]) {               // rounded to 1.0
        return (xf < 0 ? 1 : 0) + snprintf(out + (xf < 0 ? 1 : 0), 22, "%.9g", x);
    }
    if (fdig == 0) return pos;
    out[pos++] = '.';
    char fbuf[20];
    int flen = itoa_i64((int64_t)fdig, fbuf);
    for (int z = flen; z < frac_digits; z++) out[pos++] = '0';
    while (flen && fbuf[flen - 1] == '0') flen--;           // trim trailing 0s
    memcpy(out + pos, fbuf, flen);
    pos += flen;
    if (out[pos - 1] == '.') pos--;
    return pos;
}

}  // extern "C" — the encode template below needs C++ linkage

template <typename T, int (*FMT)(T, char*)>
static int64_t encode_rows(const T* x, int64_t n, char* out, int64_t cap,
                           int n_threads) {
    if (n == 0) {
        if (cap < 2) return -1;
        out[0] = '['; out[1] = ']';
        return 2;
    }
    if ((n + 1) * 26 > cap) return -1;   // callers size cap at 26n
    n_threads = n_threads < 1 ? 1 : n_threads;
    if (n < 4096) n_threads = 1;
    const int64_t per = (n + n_threads - 1) / n_threads;
    std::vector<std::vector<char>> bufs(n_threads);
    std::vector<int64_t> lens(n_threads, 0);
    auto work = [&](int t) {
        const int64_t b0 = t * per, b1 = b0 + per < n ? b0 + per : n;
        if (b0 >= b1) return;
        bufs[t].resize((b1 - b0) * 26);
        char* o = bufs[t].data();
        int64_t pos = 0;
        for (int64_t i = b0; i < b1; i++) {
            if (i) o[pos++] = ',';
            pos += FMT(x[i], o + pos);
        }
        lens[t] = pos;
    };
    if (n_threads == 1) {
        work(0);
    } else {
        std::vector<std::thread> ts;
        for (int t = 0; t < n_threads; t++) ts.emplace_back(work, t);
        for (auto& th : ts) th.join();
    }
    int64_t pos = 0;
    out[pos++] = '[';
    for (int t = 0; t < n_threads; t++) {
        if (pos + lens[t] + 1 > cap) return -1;
        memcpy(out + pos, bufs[t].data(), lens[t]);
        pos += lens[t];
    }
    out[pos++] = ']';
    return pos;
}

extern "C" {

int64_t pfh_json_encode_f32(const float* x, int64_t n, char* out, int64_t cap) {
    int nt = (int)std::thread::hardware_concurrency();
    return encode_rows<float, ftoa_f32>(x, n, out, cap, nt > 8 ? 8 : nt);
}

int64_t pfh_json_encode_i64(const int64_t* x, int64_t n, char* out, int64_t cap) {
    int nt = (int)std::thread::hardware_concurrency();
    return encode_rows<int64_t, itoa_i64>(x, n, out, cap, nt > 8 ? 8 : nt);
}

// Clinger fast path: parse one number at s (< end), advancing *io.
// Exact when mantissa ≤ 2^53 and |exp10| ≤ 22; strtod fallback otherwise.
static inline bool parse_number(const char* s, const char* end,
                                const char** io, double* out) {
    static const double P10[23] = {1,10,100,1000,1e4,1e5,1e6,1e7,1e8,1e9,1e10,
        1e11,1e12,1e13,1e14,1e15,1e16,1e17,1e18,1e19,1e20,1e21,1e22};
    const char* p = s;
    bool neg = false;
    bool truncated = false;   // any dropped mantissa digit → strtod fallback
    if (p < end && (*p == '-' || *p == '+')) { neg = *p == '-'; p++; }
    uint64_t mant = 0;
    int digits = 0, exp10 = 0;
    while (p < end && *p >= '0' && *p <= '9') {
        if (digits == 0 && *p == '0') { p++; continue; }    // leading zeros
        if (digits < 19) { mant = mant * 10 + (uint64_t)(*p - '0'); digits++; }
        else { exp10++; truncated = true; }
        p++;
    }
    if (p == s + (neg || (s < end && *s == '+') ? 1 : 0)) {
        if (!(p < end && *p == '.')) return false;          // no int digits ok if fraction
    }
    if (p < end && *p == '.') {
        p++;
        while (p < end && *p >= '0' && *p <= '9') {
            if (digits == 0 && *p == '0') {
                exp10--;                 // significance starts at 1st nonzero
                p++;
                continue;
            }
            if (digits < 19) {
                mant = mant * 10 + (uint64_t)(*p - '0');
                digits++; exp10--;
            } else {
                truncated = true;
            }
            p++;
        }
    }
    if (p < end && (*p == 'e' || *p == 'E')) {
        p++;
        bool eneg = false;
        if (p < end && (*p == '-' || *p == '+')) { eneg = *p == '-'; p++; }
        int ev = 0;
        while (p < end && *p >= '0' && *p <= '9') { ev = ev * 10 + (*p - '0'); p++; }
        exp10 += eneg ? -ev : ev;
    }
    if (!truncated && mant <= (1ULL << 53) && exp10 >= -22 && exp10 <= 22) {
        double v = (double)mant;
        v = exp10 >= 0 ? v * P10[exp10] : v / P10[-exp10];
        *out = neg ? -v : v;
        *io = p;
        return true;
    }
    char* sd_end = nullptr;
    double v = strtod(s, &sd_end);                          // slow, exact
    if (sd_end == s) return false;
    *out = v;
    *io = sd_end;
    return true;
}

// Count numbers and locate the closing ']' of the flat array at s[0]='['.
static int64_t scan_array(const char* s, int64_t len, int64_t* end_out) {
    int64_t cnt = 0;
    bool in_num = false;   // inside (or just past) the current number
    bool gap = false;      // whitespace seen after a number, no comma yet
    for (int64_t i = 1; i < len; i++) {
        const char c = s[i];
        if (c == ']') {
            if (in_num) cnt++;
            *end_out = i;
            return cnt;
        }
        if (c == ',') {
            if (!in_num) return -1;                   // "[,", "[1,,2]"
            cnt++; in_num = false; gap = false;
        } else if (c == ' ' || c == '\n' || c == '\t' || c == '\r') {
            if (in_num) gap = true;
        } else {
            if (gap) return -1;   // "[1 2]": separator must be a comma —
            in_num = true;        // malformed input falls back to stdlib
        }
    }
    return -1;
}

static void decode_range(const char* s, const char* end, double* out,
                         int64_t n, bool* ok) {
    const char* p = s;
    for (int64_t i = 0; i < n; i++) {
        while (p < end && (*p == ' ' || *p == ',' || *p == '\n' ||
                           *p == '\t' || *p == '\r')) p++;
        if (!parse_number(p, end, &p, &out[i])) { *ok = false; return; }
    }
    *ok = true;
}

// Decode a flat JSON array of numbers into float64. Returns count parsed,
// or -1 on malformed input / count exceeding cap.
int64_t pfh_json_decode_f64(const char* s, int64_t len, double* out, int64_t cap) {
    int64_t i = 0;
    while (i < len && (s[i] == ' ' || s[i] == '\n' || s[i] == '\t')) i++;
    if (i >= len || s[i] != '[') return -1;
    int64_t end_pos = 0;
    const int64_t cnt = scan_array(s + i, len - i, &end_pos);
    if (cnt < 0 || cnt > cap) return -1;
    if (cnt == 0) return 0;
    const char* body = s + i + 1;
    const char* body_end = s + i + end_pos;
    int nt = (int)std::thread::hardware_concurrency();
    if (nt > 8) nt = 8;
    if (nt < 1 || cnt < 4096) nt = 1;
    if (nt == 1) {
        bool ok = false;
        decode_range(body, body_end, out, cnt, &ok);
        return ok ? cnt : -1;
    }
    // split at comma boundaries: thread t parses numbers [t·per, …)
    const int64_t per = (cnt + nt - 1) / nt;
    // find the byte offset where each thread's first number starts by
    // counting commas — one linear pre-pass, ~1 cycle/byte
    std::vector<const char*> starts(nt + 1);
    starts[0] = body;
    {
        int64_t seen = 0;
        int next_t = 1;
        for (const char* p = body; p < body_end && next_t < nt; p++) {
            if (*p == ',') {
                seen++;
                if (seen == (int64_t)next_t * per) starts[next_t++] = p + 1;
            }
        }
        while (next_t < nt) starts[next_t++] = body_end;
    }
    starts[nt] = body_end;
    std::vector<std::thread> ts;
    std::vector<char> okbuf(nt, 0);
    for (int t = 0; t < nt; t++) {
        const int64_t c0 = t * per;
        const int64_t c1 = c0 + per < cnt ? c0 + per : cnt;
        if (c0 >= c1) { okbuf[t] = 1; continue; }
        ts.emplace_back([&, t, c0, c1] {
            bool ok = false;
            decode_range(starts[t], starts[t + 1], out + c0, c1 - c0, &ok);
            okbuf[t] = ok ? 1 : 0;
        });
    }
    for (auto& th : ts) th.join();
    for (int t = 0; t < nt; t++)
        if (!okbuf[t]) return -1;
    return cnt;
}

}  // extern "C"
