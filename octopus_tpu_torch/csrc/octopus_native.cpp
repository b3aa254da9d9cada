// Native host-side kernels for octopus_tpu.
//
// The reference links htslib for BGZF/BAM decoding (src/io/read/
// htslib_sam_facade.cpp); this extension provides the equivalent hot loops
// natively — BGZF block inflation (zlib) and BAM record boundary scanning —
// exposed through the CPython C API (no pybind11 in this environment).
// The port requires it: its host modules have no other form of these loops.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <cstring>
#include <map>
#include <queue>
#include <set>
#include <string>
#include <tuple>
#include <unordered_map>
#include <utility>
#include <vector>

#include <zlib.h>

namespace {

// Inflate a concatenation of BGZF blocks. Returns the decompressed bytes and
// (optionally) per-block (compressed_offset, uncompressed_offset) pairs.
static PyObject* inflate_bgzf(PyObject*, PyObject* args) {
    Py_buffer buf;
    if (!PyArg_ParseTuple(args, "y*", &buf)) return nullptr;
    const uint8_t* data = static_cast<const uint8_t*>(buf.buf);
    const Py_ssize_t n = buf.len;

    std::string out;
    out.reserve(static_cast<size_t>(n) * 4);
    std::vector<uint64_t> block_coffsets, block_uoffsets;

    Py_ssize_t off = 0;
    bool error = false;
    std::string error_msg;
    Py_BEGIN_ALLOW_THREADS
    std::vector<uint8_t> scratch(1 << 17);
    while (off + 18 <= n) {
        if (data[off] != 0x1f || data[off + 1] != 0x8b) {
            error = true; error_msg = "bad gzip magic"; break;
        }
        const uint16_t xlen = data[off + 10] | (data[off + 11] << 8);
        // find BSIZE in the extra field
        Py_ssize_t p = off + 12, pend = off + 12 + xlen;
        int bsize = -1;
        while (p + 4 <= pend && p + 4 <= n) {
            const uint8_t si1 = data[p], si2 = data[p + 1];
            const uint16_t slen = data[p + 2] | (data[p + 3] << 8);
            if (si1 == 66 && si2 == 67 && slen == 2 && p + 6 <= n) {
                bsize = (data[p + 4] | (data[p + 5] << 8)) + 1;
                break;
            }
            p += 4 + slen;
        }
        if (bsize <= 0 || off + bsize > n) {
            if (bsize <= 0) { error = true; error_msg = "missing BSIZE"; }
            break;
        }
        const Py_ssize_t cdata_off = off + 12 + xlen;
        const Py_ssize_t cdata_len = bsize - 12 - xlen - 8;
        const uint32_t isize = data[off + bsize - 4] | (data[off + bsize - 3] << 8)
                             | (data[off + bsize - 2] << 16)
                             | (static_cast<uint32_t>(data[off + bsize - 1]) << 24);
        if (isize > 0) {
            if (scratch.size() < isize) scratch.resize(isize);
            z_stream zs;
            std::memset(&zs, 0, sizeof(zs));
            inflateInit2(&zs, -15);
            zs.next_in = const_cast<uint8_t*>(data + cdata_off);
            zs.avail_in = static_cast<uInt>(cdata_len);
            zs.next_out = scratch.data();
            zs.avail_out = static_cast<uInt>(scratch.size());
            const int rc = inflate(&zs, Z_FINISH);
            inflateEnd(&zs);
            if (rc != Z_STREAM_END) { error = true; error_msg = "inflate failed"; break; }
            block_coffsets.push_back(static_cast<uint64_t>(off));
            block_uoffsets.push_back(static_cast<uint64_t>(out.size()));
            out.append(reinterpret_cast<char*>(scratch.data()), zs.total_out);
        } else {
            block_coffsets.push_back(static_cast<uint64_t>(off));
            block_uoffsets.push_back(static_cast<uint64_t>(out.size()));
        }
        off += bsize;
    }
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&buf);
    if (error) {
        PyErr_SetString(PyExc_ValueError, error_msg.c_str());
        return nullptr;
    }
    PyObject* py_out = PyBytes_FromStringAndSize(out.data(), static_cast<Py_ssize_t>(out.size()));
    PyObject* py_coffs = PyBytes_FromStringAndSize(
        reinterpret_cast<const char*>(block_coffsets.data()),
        static_cast<Py_ssize_t>(block_coffsets.size() * 8));
    PyObject* py_uoffs = PyBytes_FromStringAndSize(
        reinterpret_cast<const char*>(block_uoffsets.data()),
        static_cast<Py_ssize_t>(block_uoffsets.size() * 8));
    PyObject* tuple = PyTuple_Pack(3, py_out, py_coffs, py_uoffs);
    Py_XDECREF(py_out);
    Py_XDECREF(py_coffs);
    Py_XDECREF(py_uoffs);
    return tuple;
}

// Scan BAM record boundaries in a decompressed buffer starting at `start`.
// Returns record start offsets (uint64 little-endian bytes).
static PyObject* scan_bam_records(PyObject*, PyObject* args) {
    Py_buffer buf;
    Py_ssize_t start = 0;
    if (!PyArg_ParseTuple(args, "y*|n", &buf, &start)) return nullptr;
    const uint8_t* data = static_cast<const uint8_t*>(buf.buf);
    const Py_ssize_t n = buf.len;
    std::vector<uint64_t> offsets;
    Py_BEGIN_ALLOW_THREADS
    Py_ssize_t off = start;
    while (off + 4 <= n) {
        const int32_t block_size = data[off] | (data[off + 1] << 8)
            | (data[off + 2] << 16) | (static_cast<int32_t>(data[off + 3]) << 24);
        if (block_size <= 0 || off + 4 + block_size > n) break;
        offsets.push_back(static_cast<uint64_t>(off));
        off += 4 + block_size;
    }
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&buf);
    return PyBytes_FromStringAndSize(
        reinterpret_cast<const char*>(offsets.data()),
        static_cast<Py_ssize_t>(offsets.size() * 8));
}

// ---------------------------------------------------------------------------
// rANS 4x8 (CRAM block method 4) — decode hot loops.
//
// The CRAM container layer (octopus_tpu/io/cram.py) replaces the reference's
// htslib dependency; quality/base streams dominate decode time and the
// per-byte state machine is unvectorisable in numpy, so it lives here.
// Format per the CRAM codecs spec: 4 interleaved 32-bit states, 12-bit
// normalised frequencies, RLE'd frequency tables.
// ---------------------------------------------------------------------------

namespace rans {

constexpr uint32_t kTfShift = 12;
constexpr uint32_t kTotFreq = 1u << kTfShift;
constexpr uint32_t kLow = 1u << 23;

struct Reader {
    const uint8_t* p;
    const uint8_t* end;
    bool ok = true;
    uint8_t byte() {
        if (p >= end) { ok = false; return 0; }
        return *p++;
    }
};

// order-0 frequency table: symbol RLE + 1/2-byte frequencies
static bool read_freqs(Reader& r, uint32_t* freq) {
    std::memset(freq, 0, 256 * sizeof(uint32_t));
    int rle = 0;
    int j = r.byte();
    do {
        uint32_t f = r.byte();
        if (f >= 128) f = ((f & 127) << 8) | r.byte();
        if (j < 0 || j > 255) return false;
        freq[j] = f;
        if (rle > 0) {
            rle--;
            j++;
        } else if (r.p < r.end && *r.p == j + 1) {
            j = r.byte();
            rle = r.byte();
        } else {
            j = r.byte();
        }
    } while (j != 0 && r.ok);
    return r.ok;
}

struct Table {
    uint32_t freq[256];
    uint32_t cum[256];
    uint8_t sym[kTotFreq];
    void build() {
        uint32_t x = 0;
        for (int s = 0; s < 256; s++) {
            cum[s] = x;
            for (uint32_t k = 0; k < freq[s] && x + k < kTotFreq; k++) sym[x + k] = s;
            x += freq[s];
        }
    }
};

static inline void renorm(uint32_t& x, Reader& r) {
    while (x < kLow && r.p < r.end) x = (x << 8) | *r.p++;
}

static bool decode0(Reader& r, uint8_t* out, size_t out_sz) {
    Table t;
    if (!read_freqs(r, t.freq)) return false;
    t.build();
    if (r.end - r.p < 16) return false;
    uint32_t st[4];
    for (int j = 0; j < 4; j++) {
        std::memcpy(&st[j], r.p, 4);
        r.p += 4;
    }
    for (size_t i = 0; i < out_sz; i++) {
        uint32_t& x = st[i & 3];
        const uint32_t slot = x & (kTotFreq - 1);
        const uint8_t s = t.sym[slot];
        out[i] = s;
        x = t.freq[s] * (x >> kTfShift) + slot - t.cum[s];
        renorm(x, r);
    }
    return true;
}

static bool decode1(Reader& r, uint8_t* out, size_t out_sz) {
    std::vector<Table> tables(256);
    std::vector<bool> present(256, false);
    int rle = 0;
    int c = r.byte();
    do {
        if (c < 0 || c > 255) return false;
        if (!read_freqs(r, tables[c].freq)) return false;
        present[c] = true;
        if (rle > 0) {
            rle--;
            c++;
        } else if (r.p < r.end && *r.p == c + 1) {
            c = r.byte();
            rle = r.byte();
        } else {
            c = r.byte();
        }
    } while (c != 0 && r.ok);
    if (!r.ok) return false;
    for (int i = 0; i < 256; i++)
        if (present[i]) tables[i].build();
    if (r.end - r.p < 16) return false;
    uint32_t st[4];
    for (int j = 0; j < 4; j++) {
        std::memcpy(&st[j], r.p, 4);
        r.p += 4;
    }
    const size_t isz4 = out_sz >> 2;
    size_t pos[4] = {0, isz4, 2 * isz4, 3 * isz4};
    uint8_t ctx[4] = {0, 0, 0, 0};
    auto step = [&](int j) {
        uint32_t& x = st[j];
        Table& t = tables[ctx[j]];
        const uint32_t slot = x & (kTotFreq - 1);
        const uint8_t s = t.sym[slot];
        out[pos[j]] = s;
        x = t.freq[s] * (x >> kTfShift) + slot - t.cum[s];
        renorm(x, r);
        ctx[j] = s;
        pos[j]++;
    };
    for (size_t i = 0; i < isz4; i++)
        for (int j = 0; j < 4; j++) step(j);
    while (pos[3] < out_sz) step(3);
    return true;
}

}  // namespace rans

static PyObject* rans_uncompress(PyObject*, PyObject* args) {
    Py_buffer buf;
    if (!PyArg_ParseTuple(args, "y*", &buf)) return nullptr;
    const uint8_t* data = static_cast<const uint8_t*>(buf.buf);
    const Py_ssize_t n = buf.len;
    if (n < 9) {
        PyBuffer_Release(&buf);
        PyErr_SetString(PyExc_ValueError, "truncated rANS stream");
        return nullptr;
    }
    const uint8_t order = data[0];
    uint32_t out_sz;
    std::memcpy(&out_sz, data + 5, 4);
    PyObject* result = PyBytes_FromStringAndSize(nullptr, out_sz);
    if (!result) {
        PyBuffer_Release(&buf);
        return nullptr;
    }
    bool ok = true;
    if (out_sz > 0) {
        uint8_t* out = reinterpret_cast<uint8_t*>(PyBytes_AS_STRING(result));
        rans::Reader r{data + 9, data + n};
        Py_BEGIN_ALLOW_THREADS
        ok = (order == 0) ? rans::decode0(r, out, out_sz)
             : (order == 1) ? rans::decode1(r, out, out_sz)
                            : false;
        Py_END_ALLOW_THREADS
    }
    PyBuffer_Release(&buf);
    if (!ok) {
        Py_DECREF(result);
        PyErr_SetString(PyExc_ValueError, "corrupt rANS stream");
        return nullptr;
    }
    return result;
}

// ---------------------------------------------------------------------------
// Exact tandem repeat finding + repeat-based error-model penalty tracks.
//
// Mirrors octopus_tpu.utils.tandem (itself capability-equivalent to the
// reference's vendored lib/tandem) and the hot loops of
// octopus_tpu.core.likelihood.error_models (reference:
// src/core/models/error/repeat_based_{snv,indel}_error_model.cpp).
// ---------------------------------------------------------------------------

struct RepeatRec {
    int32_t pos, length, period;
};

// ---------------------------------------------------------------------------
// Reference-exact tandem repeat finding.
//
// The reference's error models call tandem::extract_exact_tandem_repeats
// (lib/tandem/tandem.hpp): a naive per-period scan for max_period <= 3 (the
// SNV model's 1..3 call) and the Kolpakov-Kucherov maximal-repetition
// algorithm over a Lempel-Ziv factorisation for larger periods (the indel
// model's 1..5 call).  The two algorithms anchor and report runs
// differently, so both are implemented here and fuzz-verified bit-exact
// against the reference library driven in place (tests/golden/
// golden_tandem.cpp).  This is an independent implementation of the
// published algorithms (Main 1989; Kolpakov & Kucherov 1999; Crochemore
// et al. 2008) matching the reference's output conventions.
// ---------------------------------------------------------------------------

namespace tandem_exact {

using std::uint32_t;
using std::size_t;

static const uint32_t kNone = 0xFFFFFFFFu;

// maximal single-base runs of length >= 2 (tandem.hpp extract_homopolymers)
static void homopolymer_runs(const uint8_t* s, int64_t n,
                             std::vector<RepeatRec>& out) {
    int64_t i = 0;
    while (i + 1 < n) {
        if (s[i] != s[i + 1]) { ++i; continue; }
        int64_t j = i + 1;
        while (j < n && s[j] == s[i]) ++j;
        out.push_back({(int32_t)i, (int32_t)(j - i), 1});
        i = j;
    }
}

// naive period-N runs: anchor at a position where adjacent characters
// differ, extend s[anchor+N..] against s[anchor..]; a match of >= N emits
// the run and restarts at the mismatch point (tandem.hpp:411-436 behaviour)
static void naive_period_runs(const uint8_t* s, int64_t n, int N,
                              std::vector<RepeatRec>& out) {
    if (n < 2 * N) return;
    int64_t a = 0;                       // adjacent_find(!=)
    while (a + 1 < n && s[a] == s[a + 1]) ++a;
    if (a + 1 >= n) return;
    int64_t b = a + N;
    while (b < n) {
        int64_t m = 0;
        while (b + m < n && s[b + m] == s[a + m]) ++m;
        if (a + m >= b) {
            out.push_back({(int32_t)a, (int32_t)(b + m - a), (int32_t)N});
            a += m;
        } else {
            ++a;
        }
        while (a + 1 < n && s[a] == s[a + 1]) ++a;
        if (a + 1 >= n) break;
        b = a + N;
    }
}

// stable merge by pos, earlier-period source first (detail::merge)
static void merge_by_pos(std::vector<RepeatRec>& dst,
                         std::vector<RepeatRec>& src) {
    std::vector<RepeatRec> merged;
    merged.reserve(dst.size() + src.size());
    size_t i = 0, j = 0;
    while (i < dst.size() && j < src.size()) {
        if (src[j].pos < dst[i].pos)
            merged.push_back(src[j++]);
        else
            merged.push_back(dst[i++]);
    }
    for (; i < dst.size(); ++i) merged.push_back(dst[i]);
    for (; j < src.size(); ++j) merged.push_back(src[j]);
    dst.swap(merged);
}

static void extract_naive(const uint8_t* s, int64_t n, int min_p, int max_p,
                          std::vector<RepeatRec>& out) {
    if (min_p == 1) homopolymer_runs(s, n, out);
    for (int p = std::max(2, min_p); p <= max_p; ++p) {
        std::vector<RepeatRec> runs;
        naive_period_runs(s, n, p, runs);
        merge_by_pos(out, runs);
    }
}

// suffix array by radix-sort prefix doubling, O(n log n)
// (output identical to any correct SA)
static std::vector<uint32_t> suffix_array(const std::vector<uint8_t>& s) {
    const int64_t n = (int64_t)s.size();
    std::vector<uint32_t> sa(n), sa2(n);
    std::vector<int64_t> rank(n), tmp(n);
    {   // initial counting sort by character
        int64_t cnt[257] = {0};
        for (int64_t i = 0; i < n; ++i) ++cnt[s[i] + 1];
        for (int i = 0; i < 256; ++i) cnt[i + 1] += cnt[i];
        for (int64_t i = 0; i < n; ++i) sa[cnt[s[i]]++] = (uint32_t)i;
        rank[sa[0]] = 0;
        for (int64_t i = 1; i < n; ++i)
            rank[sa[i]] = rank[sa[i - 1]] + (s[sa[i]] != s[sa[i - 1]] ? 1 : 0);
    }
    std::vector<int64_t> cnt(n + 1);
    for (int64_t k = 1; rank[sa[n - 1]] != n - 1; k *= 2) {
        // second key: suffixes i >= n-k have empty second half (smallest);
        // then positions sa[j]-k in first-key order
        int64_t p = 0;
        for (int64_t i = n - k; i < n; ++i) sa2[p++] = (uint32_t)i;
        for (int64_t j = 0; j < n; ++j)
            if ((int64_t)sa[j] >= k) sa2[p++] = sa[j] - (uint32_t)k;
        // stable counting sort by first key
        std::fill(cnt.begin(), cnt.end(), 0);
        for (int64_t i = 0; i < n; ++i) ++cnt[rank[i] + 1];
        for (int64_t i = 0; i < n; ++i) cnt[i + 1] += cnt[i];
        for (int64_t j = 0; j < n; ++j) sa[cnt[rank[sa2[j]]]++] = sa2[j];
        // re-rank
        tmp[sa[0]] = 0;
        for (int64_t i = 1; i < n; ++i) {
            const uint32_t x = sa[i - 1], y = sa[i];
            const int64_t rx2 = x + k < n ? rank[x + k] : -1;
            const int64_t ry2 = y + k < n ? rank[y + k] : -1;
            tmp[y] = tmp[x] + ((rank[x] != rank[y] || rx2 != ry2) ? 1 : 0);
        }
        std::copy(tmp.begin(), tmp.end(), rank.begin());
    }
    return sa;
}

// Kasai LCP; lcp[r] = LCP(sa[r-1], sa[r])
static std::vector<uint32_t> lcp_array(const std::vector<uint8_t>& s,
                                       const std::vector<uint32_t>& sa) {
    const int64_t n = (int64_t)sa.size();
    std::vector<uint32_t> rank(n), lcp(n, 0);
    for (int64_t r = 0; r < n; ++r) rank[sa[r]] = (uint32_t)r;
    int64_t h = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (rank[i] > 0) {
            const int64_t j = sa[rank[i] - 1];
            while (i + h < n && j + h < n && s[i + h] == s[j + h]) ++h;
            lcp[rank[i]] = (uint32_t)h;
            if (h > 0) --h;
        }
    }
    return lcp;
}

// LPF + previous-occurrence arrays (Crochemore et al. 2008 stack pass,
// with the reference's one-slot zero padding of sa/lcp: tandem.hpp
// make_lpf_and_prev_occ_arrays via make_suffix_array(str, 1))
static void lpf_prev_occ(std::vector<uint32_t> sa, std::vector<uint32_t> lcp,
                         std::vector<uint32_t>& lpf,
                         std::vector<uint32_t>& prev) {
    const size_t n = sa.size();       // includes the padding slot
    lpf.assign(n, 0);
    prev.assign(n, 0);
    sa.push_back(kNone);
    lcp.push_back(0);
    std::vector<std::pair<uint32_t, uint32_t>> st;  // (lcp, sa) stack
    st.emplace_back(0, sa[0]);
    for (uint32_t i = 1; i <= n; ++i) {
        uint32_t u = lcp[i];
        while (!st.empty() && (sa[i] == kNone || sa[i] < st.back().second)) {
            const auto top = st.back();
            const uint32_t lo = std::min(top.first, u);
            const uint32_t hi = std::max(top.first, u);
            u = lo;
            lpf[top.second] = hi;
            st.pop_back();
            if (lpf[top.second] == 0) {
                prev[top.second] = kNone;
            } else if (top.first > u) {
                prev[top.second] = st.back().second;
            } else {
                prev[top.second] = sa[i];
            }
        }
        if (i < n) st.emplace_back(u, sa[i]);
    }
}

struct LZBlock {
    uint32_t pos, length;
};

// forward LCE: matched length of s[i..] vs s[j..] with the first range
// bounded by `limit`
static uint32_t lce_fwd(const std::vector<uint8_t>& s, uint32_t i, uint32_t j,
                        uint32_t limit) {
    uint32_t k = 0;
    while (i + k < limit && s[i + k] == s[j + k]) ++k;
    return k;
}

// backward LCE: matched length of s[i],s[i-1],... vs s[j],s[j-1],...,
// scanning the first range down to s[floor] inclusive (j >= i >= floor)
static uint32_t lce_bwd(const std::vector<uint8_t>& s, uint32_t i, uint32_t j,
                        uint32_t floor) {
    uint32_t k = 0;
    while (k <= i - floor && s[i - k] == s[j - k]) ++k;
    return k;
}

// Main (1989): maximal periodicities touching the boundary of `block`
static void add_block_periodicities(const std::vector<uint8_t>& s,
                                    const LZBlock& prev_block,
                                    const LZBlock& block,
                                    uint32_t min_p, uint32_t max_p,
                                    std::vector<RepeatRec>& out) {
    const uint32_t u = block.pos;
    const uint32_t n = block.length;
    const uint32_t m = std::min(u, 2 * prev_block.length + n);
    const uint32_t t = u - m;
    const uint32_t end = u + n;
    for (uint32_t j = min_p; j <= std::min(n, max_p); ++j) {   // rightmax
        const uint32_t ls = lce_bwd(s, u - 1, u + j - 1, t);
        const uint32_t lp = lce_fwd(s, u + j, u, end);
        if (ls + lp >= j && j + lp < n)
            out.push_back({(int32_t)(u - ls), (int32_t)(j + lp + ls),
                           (int32_t)j});
    }
    for (uint32_t j = min_p; j < std::min(m, max_p); ++j) {    // leftmax
        const uint32_t ls = lce_bwd(s, u - j - 1, u - 1, t);
        const uint32_t lp = lce_fwd(s, u, u - j, end);
        if (ls + lp >= j)
            out.push_back({(int32_t)(u - (ls + j)), (int32_t)(j + lp + ls),
                           (int32_t)j});
    }
}

// Kolpakov & Kucherov (1999) over the LZ factorisation, matching the
// reference's bucket conventions (dedup by (pos, length) only; shifted
// copies inserted at the front of each start bucket)
static void extract_lz(const std::vector<uint8_t>& s, uint32_t min_p,
                       uint32_t max_p, std::vector<RepeatRec>& out) {
    const size_t n = s.size();
    // LZ factorisation with previous block occurrences
    std::vector<uint32_t> sa = suffix_array(s);
    std::vector<uint32_t> lcp = lcp_array(s, sa);
    sa.push_back(0);                  // the reference's one-slot padding
    lcp.push_back(0);
    std::vector<uint32_t> lpf, prev;
    lpf_prev_occ(sa, lcp, lpf, prev);
    std::vector<LZBlock> blocks;
    std::vector<uint32_t> block_prev;
    blocks.push_back({0, 1});
    block_prev.push_back(kNone);
    for (uint32_t end = 1; end < n;) {
        const uint32_t m = std::max(uint32_t{1}, lpf[end]);
        blocks.push_back({end, m});
        block_prev.push_back(prev[end]);
        end += m;
    }
    // leftmost maximal repetitions (Main 1989), bucketed by END position
    // with (pos, length) dedup, then re-bucketed by START
    std::vector<RepeatRec> lmrs;
    for (size_t h = 1; h < blocks.size(); ++h)
        add_block_periodicities(s, blocks[h - 1], blocks[h], min_p, max_p,
                                lmrs);
    std::vector<std::vector<RepeatRec>> end_buckets(n);
    for (const auto& r : lmrs) {
        auto& bucket = end_buckets[r.pos + r.length - 1];
        bool dup = false;
        for (const auto& e : bucket)
            if (e.pos == r.pos && e.length == r.length) { dup = true; break; }
        if (!dup) bucket.push_back(r);
    }
    std::vector<std::vector<RepeatRec>> start_buckets(n);
    for (auto& bucket : end_buckets)
        for (const auto& r : bucket)
            start_buckets[r.pos].push_back(r);
    // propagate repeats into later LZ-block occurrences
    for (size_t k = 0; k < blocks.size(); ++k) {
        const auto& block = blocks[k];
        const uint32_t block_end = block.pos + block.length;
        const uint32_t delta =
            block.pos - (block_prev[k] != kNone ? block_prev[k] : 0);
        const uint32_t max_target_end = block_end - delta;
        for (uint32_t j = block.pos; j < block_end; ++j) {
            const uint32_t target_start = j - delta;
            auto& target = start_buckets[target_start];
            uint32_t target_end = max_target_end;
            if (!start_buckets[j].empty())
                target_end = std::min(
                    target_start + (uint32_t)start_buckets[j].front().length,
                    max_target_end);
            // first run whose end reaches target_end (buckets are kept
            // sorted by end via construction order)
            size_t cnt = 0;
            while (cnt < target.size()
                   && (uint32_t)(target[cnt].pos + target[cnt].length)
                          < target_end)
                ++cnt;
            if (cnt > 0) {
                std::vector<RepeatRec> shifted(target.begin(),
                                               target.begin() + cnt);
                for (auto& r : shifted) r.pos += (int32_t)delta;
                start_buckets[j].insert(start_buckets[j].begin(),
                                        shifted.begin(), shifted.end());
            }
        }
    }
    for (auto& bucket : start_buckets)
        for (const auto& r : bucket) out.push_back(r);
}

// base-code -> ASCII mapping: the reference runs on 'ACGTN' characters and
// the suffix-array ORDER matters ('N' sorts between 'G' and 'T')
static std::vector<uint8_t> to_ascii(const uint8_t* codes, int64_t n) {
    static const uint8_t kMap[5] = {'A', 'C', 'G', 'T', 'N'};
    std::vector<uint8_t> s(n);
    for (int64_t i = 0; i < n; ++i) s[i] = kMap[codes[i] < 5 ? codes[i] : 4];
    return s;
}

static void extract(const uint8_t* codes, int64_t n, int min_p, int max_p,
                    std::vector<RepeatRec>& out) {
    if (min_p == 0) min_p = 1;
    if (n == 0 || n < min_p) return;
    if (max_p <= 3) {
        extract_naive(codes, n, min_p, max_p, out);
    } else {
        const auto s = to_ascii(codes, n);
        extract_lz(s, (uint32_t)min_p, (uint32_t)max_p, out);
    }
}

}  // namespace tandem_exact

static void find_tandem_repeats(const uint8_t* s, Py_ssize_t n,
                                int min_p, int max_p,
                                std::vector<RepeatRec>& out) {
    for (int p = std::max(1, min_p); p <= max_p; ++p) {
        if (p == 1) {
            Py_ssize_t i = 0;
            while (i < n) {
                Py_ssize_t j = i + 1;
                while (j < n && s[j] == s[i]) ++j;
                if (j - i >= 2)
                    out.push_back({(int32_t)i, (int32_t)(j - i), 1});
                i = j;
            }
        } else {
            if (n < 2 * p) continue;
            const Py_ssize_t m = n - p;     // eq[i] = s[i] == s[i+p]
            Py_ssize_t i = 0;
            while (i < m) {
                if (s[i] != s[i + p]) { ++i; continue; }
                Py_ssize_t e = i + 1;       // maximal eq-run [i, e)
                while (e < m && s[e] == s[e + p]) ++e;
                Py_ssize_t len = (e - i) + p;
                if (len >= 2 * p) {
                    // advance start past a leading homopolymer run (tandem.py
                    // _find_period_runs; reference tandem.hpp:411-436)
                    Py_ssize_t pos = i;
                    while (pos + 1 < e && s[pos] == s[pos + 1] &&
                           pos + 1 + 2 * p <= e + p)
                        ++pos;
                    len = e + p - pos;
                    if (len >= 2 * p) {
                        bool primitive = true;  // motif not a repetition itself
                        for (int d = 1; d < p && primitive; ++d) {
                            if (p % d) continue;
                            bool all = true;
                            for (int k = 0; k < p; ++k)
                                if (s[pos + k] != s[pos + k % d]) { all = false; break; }
                            if (all) primitive = false;
                        }
                        if (primitive)
                            out.push_back({(int32_t)pos, (int32_t)len, (int32_t)p});
                    }
                }
                i = e;
            }
        }
    }
    std::sort(out.begin(), out.end(), [](const RepeatRec& a, const RepeatRec& b) {
        return a.pos != b.pos ? a.pos < b.pos : a.period < b.period;
    });
}

// tandem_repeats(codes: u8 buffer, min_period, max_period)
//   -> int32-le bytes of (pos, length, period) triples
static PyObject* tandem_repeats(PyObject*, PyObject* args) {
    Py_buffer buf;
    int min_p, max_p;
    if (!PyArg_ParseTuple(args, "y*ii", &buf, &min_p, &max_p)) return nullptr;
    std::vector<RepeatRec> reps;
    Py_BEGIN_ALLOW_THREADS
    tandem_exact::extract((const uint8_t*)buf.buf, buf.len, min_p, max_p, reps);
    std::sort(reps.begin(), reps.end(),
              [](const RepeatRec& a, const RepeatRec& b) {
                  return a.pos != b.pos ? a.pos < b.pos : a.period < b.period;
              });
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&buf);
    PyObject* result = PyBytes_FromStringAndSize(
        (const char*)reps.data(), (Py_ssize_t)(reps.size() * sizeof(RepeatRec)));
    return result;
}

static void count_runs_impl(const int16_t* mask, Py_ssize_t n, int max_gap,
                            int32_t* out) {
    if (n == 0) return;
    std::memset(out, 0, n * sizeof(int32_t));
    int16_t prev = mask[0];
    int32_t count = prev > 0 ? 1 : 0;
    int gap = 0;
    for (Py_ssize_t i = 1; i < n; ++i) {
        int16_t x = mask[i];
        int32_t emitted = 0;
        if (x == 0) {
            ++gap;
            if (count > 0) {
                if (gap == 1) {
                    emitted = count;
                    if (max_gap < 1) count = 0;
                } else if (gap > max_gap) {
                    count = 0;
                }
            }
        } else if (prev == x) {
            gap = 0;
            ++count;
        } else {
            prev = x;
            emitted = count;
            count = 1;
        }
        out[i] = emitted;
    }
}

// snv_priors(codes: u8, subst_mask: u8 (may be empty), max_q,
//            caps1: i16 buffer, caps2: i16, caps3: i16)
//   -> (fwd int16-le bytes, rev int16-le bytes)
// Full RepeatBasedSnvErrorModel.evaluate (error_models.py:110-135).
static PyObject* snv_priors(PyObject*, PyObject* args) {
    Py_buffer codes_b, sub_b, c1_b, c2_b, c3_b;
    int max_q;
    if (!PyArg_ParseTuple(args, "y*y*iy*y*y*", &codes_b, &sub_b, &max_q,
                          &c1_b, &c2_b, &c3_b))
        return nullptr;
    const uint8_t* codes = (const uint8_t*)codes_b.buf;
    const Py_ssize_t n = codes_b.len;
    const uint8_t* sub = (const uint8_t*)sub_b.buf;
    const bool has_sub = sub_b.len == n;
    const int16_t* caps[3] = {(const int16_t*)c1_b.buf, (const int16_t*)c2_b.buf,
                              (const int16_t*)c3_b.buf};
    const Py_ssize_t ncaps[3] = {
        c1_b.len / (Py_ssize_t)sizeof(int16_t),
        c2_b.len / (Py_ssize_t)sizeof(int16_t),
        c3_b.len / (Py_ssize_t)sizeof(int16_t)};
    PyObject* fwd_o = PyBytes_FromStringAndSize(nullptr, n * sizeof(int16_t));
    PyObject* rev_o = PyBytes_FromStringAndSize(nullptr, n * sizeof(int16_t));
    if (!fwd_o || !rev_o) {
        Py_XDECREF(fwd_o); Py_XDECREF(rev_o);
        PyBuffer_Release(&codes_b); PyBuffer_Release(&sub_b);
        PyBuffer_Release(&c1_b); PyBuffer_Release(&c2_b); PyBuffer_Release(&c3_b);
        return nullptr;
    }
    int16_t* fwd = (int16_t*)PyBytes_AS_STRING(fwd_o);
    int16_t* rev = (int16_t*)PyBytes_AS_STRING(rev_o);
    Py_BEGIN_ALLOW_THREADS
    for (Py_ssize_t i = 0; i < n; ++i) { fwd[i] = (int16_t)max_q; rev[i] = (int16_t)max_q; }
    std::vector<RepeatRec> reps;
    tandem_exact::extract(codes, n, 1, 3, reps);
    std::vector<int16_t> mask(n), rmask(n);
    std::vector<int32_t> runs(n);
    for (int period = 1; period <= 3; ++period) {
        std::fill(mask.begin(), mask.end(), 0);
        bool any = false;
        for (const auto& r : reps) {
            if (r.period != period) continue;
            any = true;
            // base-sum motif hash so adjacent distinct repeats break runs
            int32_t h = period + 1;
            for (int k = 0; k < period; ++k) h += codes[r.pos + k];
            for (int32_t j = r.pos; j < r.pos + r.length && j < n; ++j)
                mask[j] = (int16_t)h;
        }
        if (!any) continue;
        const int16_t* cp = caps[period - 1];
        const Py_ssize_t nc = ncaps[period - 1];
        const int max_gap = period + 1;
        count_runs_impl(mask.data(), n, max_gap, runs.data());
        for (Py_ssize_t i = 0; i < n; ++i) {
            Py_ssize_t k = runs[i] < nc - 1 ? runs[i] : nc - 1;
            if (cp[k] < fwd[i]) fwd[i] = cp[k];
        }
        for (Py_ssize_t i = 0; i < n; ++i) rmask[i] = mask[n - 1 - i];
        count_runs_impl(rmask.data(), n, max_gap, runs.data());
        for (Py_ssize_t i = 0; i < n; ++i) {
            Py_ssize_t k = runs[n - 1 - i] < nc - 1 ? runs[n - 1 - i] : nc - 1;
            if (cp[k] < rev[i]) rev[i] = cp[k];
        }
    }
    if (has_sub) {
        for (Py_ssize_t i = 0; i < n; ++i)
            if (sub[i]) { fwd[i] = (int16_t)max_q; rev[i] = (int16_t)max_q; }
    }
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&codes_b); PyBuffer_Release(&sub_b);
    PyBuffer_Release(&c1_b); PyBuffer_Release(&c2_b); PyBuffer_Release(&c3_b);
    PyObject* tup = PyTuple_Pack(2, fwd_o, rev_o);
    Py_DECREF(fwd_o); Py_DECREF(rev_o);
    return tup;
}

// indel_penalties(codes: u8, default_open, default_extend,
//                 at_open: i16, cg_open: i16, di_open: i16, tri_open: i16,
//                 homo_ext: i16, di_ext: i16, tri_ext: i16)
//   -> (gap_open int16-le bytes, gap_extend int16-le bytes)
// Full RepeatBasedIndelErrorModel.set_penalties (error_models.py:242-254).
// Base codes: A=0 C=1 G=2 T=3.
static PyObject* indel_penalties(PyObject*, PyObject* args) {
    Py_buffer codes_b, at_b, cg_b, di_b, tri_b, he_b, de_b, te_b;
    int def_open, def_ext;
    if (!PyArg_ParseTuple(args, "y*iiy*y*y*y*y*y*y*", &codes_b, &def_open,
                          &def_ext, &at_b, &cg_b, &di_b, &tri_b, &he_b, &de_b,
                          &te_b))
        return nullptr;
    const uint8_t* codes = (const uint8_t*)codes_b.buf;
    const Py_ssize_t n = codes_b.len;
    PyObject* open_o = PyBytes_FromStringAndSize(nullptr, n * sizeof(int16_t));
    PyObject* ext_o = PyBytes_FromStringAndSize(nullptr, n * sizeof(int16_t));
    if (!open_o || !ext_o) {
        Py_XDECREF(open_o); Py_XDECREF(ext_o);
        PyBuffer_Release(&codes_b); PyBuffer_Release(&at_b); PyBuffer_Release(&cg_b);
        PyBuffer_Release(&di_b); PyBuffer_Release(&tri_b); PyBuffer_Release(&he_b);
        PyBuffer_Release(&de_b); PyBuffer_Release(&te_b);
        return nullptr;
    }
    int16_t* gap_open = (int16_t*)PyBytes_AS_STRING(open_o);
    int16_t* gap_ext = (int16_t*)PyBytes_AS_STRING(ext_o);
    Py_BEGIN_ALLOW_THREADS
    auto lookup = [](const Py_buffer& b, Py_ssize_t idx) -> int16_t {
        const int16_t* t = (const int16_t*)b.buf;
        Py_ssize_t m = b.len / (Py_ssize_t)sizeof(int16_t);
        return t[idx < m ? idx : m - 1];
    };
    for (Py_ssize_t i = 0; i < n; ++i) {
        gap_open[i] = (int16_t)def_open;
        gap_ext[i] = (int16_t)def_ext;
    }
    std::vector<RepeatRec> reps;
    tandem_exact::extract(codes, n, 1, 5, reps);
    std::sort(reps.begin(), reps.end(),
              [](const RepeatRec& a, const RepeatRec& b) {
                  return a.pos != b.pos ? a.pos < b.pos : a.period < b.period;
              });
    std::stable_sort(reps.begin(), reps.end(),
                     [](const RepeatRec& a, const RepeatRec& b) {
                         return a.length < b.length;
                     });
    for (const auto& r : reps) {
        const int period = r.period;
        const Py_ssize_t periodicity = r.length / period;
        int16_t opn, ext;
        if (period == 1) {
            const uint8_t b0 = codes[r.pos];
            opn = (b0 == 0 || b0 == 3) ? lookup(at_b, periodicity)
                                       : lookup(cg_b, periodicity);
            ext = lookup(he_b, periodicity);
        } else if (period == 2) {
            opn = lookup(di_b, periodicity);
            const uint8_t b0 = codes[r.pos], b1 = codes[r.pos + 1];
            // CG dinucleotide repeats are extra error-prone
            if (opn > 7 && ((b0 == 1 && b1 == 2) || (b0 == 2 && b1 == 1)))
                opn -= 2;
            ext = lookup(de_b, periodicity);
        } else {
            opn = lookup(tri_b, periodicity);
            ext = lookup(te_b, periodicity);
        }
        const Py_ssize_t lo = r.pos;
        const Py_ssize_t hi = std::min((Py_ssize_t)(r.pos + r.length), n);
        for (Py_ssize_t i = lo; i < hi; ++i) {
            if (opn < gap_open[i]) gap_open[i] = opn;
            gap_ext[i] = ext;
        }
    }
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&codes_b); PyBuffer_Release(&at_b); PyBuffer_Release(&cg_b);
    PyBuffer_Release(&di_b); PyBuffer_Release(&tri_b); PyBuffer_Release(&he_b);
    PyBuffer_Release(&de_b); PyBuffer_Release(&te_b);
    PyObject* tup = PyTuple_Pack(2, open_o, ext_o);
    Py_DECREF(open_o); Py_DECREF(ext_o);
    return tup;
}

// ---------------------------------------------------------------------------
// Full BAM record decode.
//
// Mirrors octopus_tpu.io.bam.BamFile._decode_records (reference:
// src/io/read/htslib_sam_facade.cpp record conversion): one pass over the
// inflated BGZF buffer, region/flag filtering, 4-bit sequence decode, CIGAR
// expansion, reference-span computation and FNV-1a name hashing — the
// numpy fancy-index gathers and per-record python loops collapse into one
// native call.
// ---------------------------------------------------------------------------

// decode_bam_records(buf: y*, ref_id, begin: L, end: L, seq4_table: y* 16)
//   -> (pos_i64, ends_i64, mapq_u8, flags_u16, next_ref_i32, next_pos_i64,
//       tlen_i32, name_hash_u64, name_blob_u8, name_offsets_i64,
//       seq_u8, quals_u8, seq_offsets_i64, cigar_i32, cigar_offsets_i64,
//       aux_start_i64, aux_end_i64)  all little-endian bytes objects
static PyObject* decode_bam_records(PyObject*, PyObject* args) {
    Py_buffer buf_b, tbl_b;
    int ref_id;
    long long begin, end;
    if (!PyArg_ParseTuple(args, "y*iLLy*", &buf_b, &ref_id, &begin, &end,
                          &tbl_b))
        return nullptr;
    if (tbl_b.len < 16) {
        PyBuffer_Release(&buf_b); PyBuffer_Release(&tbl_b);
        PyErr_SetString(PyExc_ValueError, "seq4 table must be 16 bytes");
        return nullptr;
    }
    const uint8_t* data = (const uint8_t*)buf_b.buf;
    const Py_ssize_t n_bytes = buf_b.len;
    const uint8_t* tbl = (const uint8_t*)tbl_b.buf;
    std::vector<int64_t> pos_v, ends_v, next_pos_v, name_off_v{0}, seq_off_v{0},
        cig_off_v{0}, aux_s_v, aux_e_v;
    std::vector<uint8_t> mapq_v, name_blob, seq_v, qual_v;
    std::vector<uint16_t> flags_v;
    std::vector<int32_t> next_ref_v, tlen_v, cig_v;
    std::vector<uint64_t> hash_v;
    Py_BEGIN_ALLOW_THREADS
    auto rd_i32 = [&](Py_ssize_t o) -> int32_t {
        return (int32_t)(data[o] | (data[o + 1] << 8) | (data[o + 2] << 16)
                         | ((uint32_t)data[o + 3] << 24));
    };
    auto rd_u16 = [&](Py_ssize_t o) -> uint16_t {
        return (uint16_t)(data[o] | (data[o + 1] << 8));
    };
    Py_ssize_t off = 0;
    while (off + 4 <= n_bytes) {
        const int32_t block_size = rd_i32(off);
        if (block_size <= 0 || off + 4 + block_size > n_bytes) break;
        const Py_ssize_t rec = off;
        off += 4 + block_size;
        const int32_t rec_ref = rd_i32(rec + 4);
        const int64_t rec_pos = rd_i32(rec + 8);
        const uint16_t flags = rd_u16(rec + 18);
        if (rec_ref != ref_id || rec_pos >= end || (flags & 0x4)) continue;
        const int l_read_name = data[rec + 12];
        const uint8_t mapq = data[rec + 13];
        const int n_cigar = rd_u16(rec + 16);
        const int64_t l_seq = rd_i32(rec + 20);
        const int32_t next_ref = rd_i32(rec + 24);
        const int64_t next_pos = rd_i32(rec + 28);
        const int32_t tlen = rd_i32(rec + 32);
        const Py_ssize_t name_off = rec + 36;
        const Py_ssize_t cigar_off = name_off + l_read_name;
        const Py_ssize_t seq_off = cigar_off + 4 * (Py_ssize_t)n_cigar;
        const Py_ssize_t qual_off = seq_off + (l_seq + 1) / 2;
        const Py_ssize_t aux_off = qual_off + l_seq;
        const Py_ssize_t rec_end = rec + 4 + block_size;
        if (aux_off > rec_end) continue;  // malformed
        // reference span from cigar (ops M=0 D=2 N=3 EQ=7 X=8 consume ref)
        int64_t span = 0;
        for (int c = 0; c < n_cigar; ++c) {
            const uint32_t w = (uint32_t)rd_i32(cigar_off + 4 * c);
            const uint32_t op = w & 0xF;
            if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8)
                span += w >> 4;
        }
        const int64_t rec_endpos = rec_pos + span;
        if (rec_endpos <= begin) continue;
        pos_v.push_back(rec_pos);
        ends_v.push_back(rec_endpos);
        mapq_v.push_back(mapq);
        flags_v.push_back(flags);
        next_ref_v.push_back(next_ref);
        next_pos_v.push_back(next_pos);
        tlen_v.push_back(tlen);
        // FNV-1a over the NUL-terminated read name (without the NUL)
        uint64_t h = 1469598103934665603ull;
        for (int k = 0; k + 1 < l_read_name; ++k) {
            h ^= data[name_off + k];
            h *= 1099511628211ull;
        }
        hash_v.push_back(h);
        name_blob.insert(name_blob.end(), data + name_off,
                         data + name_off + (l_read_name > 0 ? l_read_name - 1 : 0));
        name_off_v.push_back((int64_t)name_blob.size());
        for (int c = 0; c < n_cigar; ++c) {
            const uint32_t w = (uint32_t)rd_i32(cigar_off + 4 * c);
            cig_v.push_back((int32_t)(w >> 4));
            cig_v.push_back((int32_t)(w & 0xF));
        }
        cig_off_v.push_back((int64_t)(cig_v.size() / 2));
        for (int64_t k = 0; k < l_seq; ++k) {
            const uint8_t nib = data[seq_off + k / 2];
            seq_v.push_back(tbl[(k % 2 == 0) ? (nib >> 4) : (nib & 0xF)]);
            const uint8_t q = data[qual_off + k];
            qual_v.push_back(q == 0xFF ? 30 : q);
        }
        seq_off_v.push_back((int64_t)seq_v.size());
        aux_s_v.push_back((int64_t)aux_off);
        aux_e_v.push_back((int64_t)rec_end);
    }
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&buf_b); PyBuffer_Release(&tbl_b);
    auto mk = [](const void* p, size_t nbytes) {
        return PyBytes_FromStringAndSize((const char*)p, (Py_ssize_t)nbytes);
    };
    PyObject* tup = Py_BuildValue(
        "(NNNNNNNNNNNNNNNNN)",
        mk(pos_v.data(), pos_v.size() * 8),
        mk(ends_v.data(), ends_v.size() * 8),
        mk(mapq_v.data(), mapq_v.size()),
        mk(flags_v.data(), flags_v.size() * 2),
        mk(next_ref_v.data(), next_ref_v.size() * 4),
        mk(next_pos_v.data(), next_pos_v.size() * 8),
        mk(tlen_v.data(), tlen_v.size() * 4),
        mk(hash_v.data(), hash_v.size() * 8),
        mk(name_blob.data(), name_blob.size()),
        mk(name_off_v.data(), name_off_v.size() * 8),
        mk(seq_v.data(), seq_v.size()),
        mk(qual_v.data(), qual_v.size()),
        mk(seq_off_v.data(), seq_off_v.size() * 8),
        mk(cig_v.data(), cig_v.size() * 4),
        mk(cig_off_v.data(), cig_off_v.size() * 8),
        mk(aux_s_v.data(), aux_s_v.size() * 8),
        mk(aux_e_v.data(), aux_e_v.size() * 8));
    return tup;
}

// ---------------------------------------------------------------------------
// Affine-gap global alignment (GlobalAligner equivalent; reference:
// src/core/tools/vargen/utils/global_aligner.cpp): argmax ties go M before
// X before Y, and the backtrack prefers a gap open to an extension.
// ---------------------------------------------------------------------------

// (length, op) runs from the start; op: 0=M 1=I (consumes b) 2=D (consumes a)
static std::vector<std::pair<int32_t, int32_t>> global_align(
    const uint8_t* a, int64_t n, const uint8_t* b, int64_t m, int match,
    int mismatch, int gap_open, int gap_extend) {
    const int64_t NEG = -((int64_t)1 << 30);
    const int64_t w = m + 1;
    std::vector<int64_t> M((n + 1) * w, NEG), X((n + 1) * w, NEG),
        Y((n + 1) * w, NEG);
    M[0] = 0;
    for (int64_t i = 1; i <= n; ++i) X[i * w] = gap_open + (i - 1) * gap_extend;
    for (int64_t j = 1; j <= m; ++j) Y[j] = gap_open + (j - 1) * gap_extend;
    for (int64_t i = 1; i <= n; ++i) {
        const uint8_t ai = a[i - 1];
        for (int64_t j = 1; j <= m; ++j) {
            const int64_t pm = M[(i - 1) * w + j - 1], px = X[(i - 1) * w + j - 1],
                          py = Y[(i - 1) * w + j - 1];
            int64_t best = pm > px ? pm : px;
            if (py > best) best = py;
            M[i * w + j] = best + (ai == b[j - 1] ? match : mismatch);
            const int64_t xo = M[(i - 1) * w + j] + gap_open,
                          xe = X[(i - 1) * w + j] + gap_extend;
            X[i * w + j] = xo > xe ? xo : xe;
            const int64_t yo = M[i * w + j - 1] + gap_open,
                          ye = Y[i * w + j - 1] + gap_extend;
            Y[i * w + j] = yo > ye ? yo : ye;
        }
    }
    int64_t i = n, j = m;
    auto argmax3 = [](int64_t x0, int64_t x1, int64_t x2) -> int {
        if (x0 >= x1 && x0 >= x2) return 0;   // first max wins
        if (x1 >= x2) return 1;
        return 2;
    };
    int state = argmax3(M[n * w + m], X[n * w + m], Y[n * w + m]);
    std::vector<std::pair<int32_t, int32_t>> ops;  // (length, op), end first
    auto push = [&ops](int32_t op) {
        if (!ops.empty() && ops.back().second == op)
            ++ops.back().first;
        else
            ops.push_back({1, op});
    };
    while (i > 0 || j > 0) {
        if (state == 0 && i > 0 && j > 0) {
            const int prev = argmax3(M[(i - 1) * w + j - 1],
                                     X[(i - 1) * w + j - 1],
                                     Y[(i - 1) * w + j - 1]);
            push(0);
            --i; --j;
            state = prev;
        } else if (state == 1 && i > 0) {
            if (X[i * w + j] == M[(i - 1) * w + j] + gap_open) state = 0;
            push(2);  // D consumes a
            --i;
        } else if (state == 2 && j > 0) {
            if (Y[i * w + j] == M[i * w + j - 1] + gap_open) state = 0;
            push(1);  // I consumes b
            --j;
        } else {
            state = i > 0 ? 1 : 2;
        }
    }
    std::reverse(ops.begin(), ops.end());
    return ops;
}

// global_align(a: u8, b: u8, match, mismatch, gap_open, gap_extend)
//   -> int32-le bytes of (length, op) pairs; op: 0=M 1=I 2=D
static PyObject* global_align_native(PyObject*, PyObject* args) {
    Py_buffer a_b, b_b;
    int match, mismatch, gap_open, gap_extend;
    if (!PyArg_ParseTuple(args, "y*y*iiii", &a_b, &b_b, &match, &mismatch,
                          &gap_open, &gap_extend))
        return nullptr;
    std::vector<int32_t> out_ops;
    Py_BEGIN_ALLOW_THREADS
    for (const auto& op : global_align((const uint8_t*)a_b.buf, a_b.len,
                                       (const uint8_t*)b_b.buf, b_b.len, match,
                                       mismatch, gap_open, gap_extend)) {
        out_ops.push_back(op.first);
        out_ops.push_back(op.second);
    }
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&a_b); PyBuffer_Release(&b_b);
    return PyBytes_FromStringAndSize(
        (const char*)out_ops.data(),
        (Py_ssize_t)(out_ops.size() * sizeof(int32_t)));
}

// ---------------------------------------------------------------------------
// Candidate generation: one call a window (core/vargen/generator.py).
//
// The reference's VariantGenerator runs a CigarScanner and a
// LocalReassembler over the window's reads (src/core/tools/vargen/
// cigar_scanner.cpp, local_reassembler.cpp, utils/assembler.cpp); here
// both run in one call over every sample's reads:
//
// * the CIGAR scan: each read's mismatches, insertions and deletions, the
//   Poisson-tail misalignment filter, observations grouped by (begin, end,
//   alt) with each sample's depth from difference arrays, and the
//   germline, threshold and PacBio inclusion predicates
//   (cigar_scanner.cpp:500-799). The somatic and cell predicates take
//   scipy's beta tail, so their groups go back to Python with their
//   per-sample statistics;
// * the reassembler: the indel/clip and mismatch-dense triggers, 600 bp
//   bins with 200 bp overlap, quality masking, a de-Bruijn graph a bin and
//   k-mer size on (k-1)-mers packed 2 bits a base, its bubbles best first,
//   their alignment to the reference and decomposition, the fallback k
//   ladder and the cross-k confirmation;
// * every indel left-aligned, the union deduplicated and sorted.
// ---------------------------------------------------------------------------

namespace vargen {

// contig bases [lo, hi) and the contig's length
struct Ref {
    const uint8_t* base;
    int64_t lo, hi, contig_size;
    bool has(int64_t p) const { return p >= lo && p < hi; }
    uint8_t at(int64_t p) const { return base[p - lo]; }
    // contig[b, e) clipped to the contig (ReferenceGenome.fetch_codes)
    std::string slice(int64_t b, int64_t e) const {
        b = std::max(b, lo);
        e = std::min(std::min(e, contig_size), hi);
        if (e <= b) return std::string();
        return std::string((const char*)base + (b - lo), (size_t)(e - b));
    }
};

// one ReadBatch (SoA) of one sample
struct Batch {
    int sample = 0;
    Py_ssize_t n = 0;
    const int64_t* begins = nullptr;
    const int64_t* ends = nullptr;
    const uint8_t* mapq = nullptr;
    const uint16_t* flags = nullptr;
    const uint8_t* seq = nullptr;
    const uint8_t* quals = nullptr;
    const int64_t* soff = nullptr;
    const int32_t* cig = nullptr;   // (length, op) pairs
    const int64_t* coff = nullptr;
};

struct Var {
    int64_t begin, end;
    std::string ref, alt;
    bool edge = false;   // left alignment stopped at the window's reference
    bool is_indel() const { return ref.size() != alt.size(); }
    bool operator<(const Var& o) const {
        return std::tie(begin, end, alt, ref) < std::tie(o.begin, o.end, o.alt, o.ref);
    }
    bool operator==(const Var& o) const {
        return begin == o.begin && end == o.end && ref == o.ref && alt == o.alt;
    }
};

// types/variants.py left_align: trim, then rotate a pure indel left over
// the bases before it. Sets edge where the rotation reached the start of
// the reference held here before the contig's.
static void left_align(Var& v, const Ref& R) {
    std::string& ref = v.ref;
    std::string& alt = v.alt;
    while (!ref.empty() && !alt.empty() && ref.back() == alt.back() &&
           (ref.size() > 1 || alt.size() > 1)) {
        ref.pop_back();
        alt.pop_back();
    }
    size_t p = 0;
    while (ref.size() - p > 1 && alt.size() - p > 1 && ref[p] == alt[p]) ++p;
    ref.erase(0, p);
    alt.erase(0, p);
    v.begin += (int64_t)p;
    if (ref.empty() != alt.empty()) {
        std::string& longer = ref.empty() ? alt : ref;
        const int64_t len = (int64_t)longer.size();
        // after s steps the allele is S[-s, len - s) of S = contig[..begin) + longer
        auto S = [&](int64_t k) -> uint8_t {
            return k < 0 ? R.at(v.begin + k) : (uint8_t)longer[k];
        };
        int64_t s = 0;
        while (v.begin - s > 0) {
            if (!R.has(v.begin - s - 1)) { v.edge = true; break; }
            if (S(len - 1 - s) != R.at(v.begin - s - 1)) break;
            ++s;
        }
        if (s) {
            std::string rotated((size_t)len, '\0');
            for (int64_t k = 0; k < len; ++k) rotated[k] = (char)S(k - s);
            longer = rotated;
            v.begin -= s;
        }
    }
    v.end = v.begin + (int64_t)ref.size();
}

// ---- CIGAR scan -----------------------------------------------------------

static double poisson_lnsf(int64_t k_minus_1, double mu) {
    // ln P(Poisson(mu) >= k), direct upper-tail sum in log space
    const int64_t k = k_minus_1 + 1;
    if (mu <= 0.0) return k <= 0 ? 0.0 : -std::numeric_limits<double>::infinity();
    const double lead = -mu + k * std::log(mu) - std::lgamma((double)k + 1.0);
    double total = 1.0, ratio = 1.0;
    int64_t i = k;
    for (;;) {
        ++i;
        ratio *= mu / (double)i;
        if (ratio < 1e-18) break;
        total += ratio;
    }
    return std::min(lead + std::log(total), 0.0);
}

// cigar_scanner._INCLUSION: the caller's predicate decides BY_CALLER groups
enum Inclusion { GERMLINE = 0, THRESHOLD = 1, PACBIO = 2, BY_CALLER = 3 };

struct ScanOptions {
    int use = 0;
    int snv_threshold = 20;
    double snv_penalty = 1, indel_penalty = 1, clip_penalty = 1;
    int max_clip = 3;
    long long max_variant_size = 2000;
    int use_filter = 1;
    double mutation_rate = 0.0211, min_ln_prob = 0;
    int inclusion = 0;   // an Inclusion
    int copy_number = 2;
    int allow_strand_bias = 0;
    int min_observations = 2;
};

// one observation of a read: alt at read offset, reference [begin, end)
struct ScanCand {
    int32_t read, offset, alt_len, sum_q;
    int64_t begin, end;
    uint8_t at_edge, misaligned;
};

// cigar_scanner.cpp:80-260 over a batch: every read's mismatches (M, =, X
// against non-N bases), insertions and deletions, with the read's
// misalignment verdict
static void scan_batch(const Batch& B, const Ref& R, const ScanOptions& o,
                       std::vector<ScanCand>& out) {
    std::vector<ScanCand> found;
    for (Py_ssize_t r = 0; r < B.n; ++r) {
        const int64_t begin = B.begins[r], end = B.ends[r];
        const uint8_t* rs = B.seq + B.soff[r];
        const uint8_t* rq = B.quals + B.soff[r];
        int64_t ref_i = begin;
        int64_t read_i = 0;
        double penalty = 0.0;
        found.clear();
        for (int64_t c = B.coff[r]; c < B.coff[r + 1]; ++c) {
            const int32_t length = B.cig[2 * c];
            const int32_t op = B.cig[2 * c + 1];
            switch (op) {
            case 0: case 7: case 8: {          // M, EQ, X
                for (int32_t i = 0; i < length; ++i) {
                    const int64_t p = ref_i + i;
                    if (!R.has(p)) continue;
                    const uint8_t rb = R.at(p), qb = rs[read_i + i];
                    if (rb != qb && rb != 4 && qb != 4) {
                        found.push_back({(int32_t)r, (int32_t)(read_i + i), 1, 0,
                                         p, p + 1, 0, 0});
                        if (rq[read_i + i] >= o.snv_threshold) penalty += o.snv_penalty;
                    }
                }
                read_i += length;
                ref_i += length;
                break;
            }
            case 1:                            // I
                found.push_back({(int32_t)r, (int32_t)read_i, length, 0,
                                 ref_i, ref_i, 0, 0});
                read_i += length;
                penalty += o.indel_penalty;
                break;
            case 2:                            // D
                found.push_back({(int32_t)r, (int32_t)read_i, 0, 0,
                                 ref_i, ref_i + length, 0, 0});
                ref_i += length;
                penalty += o.indel_penalty;
                break;
            case 4:                            // S
                read_i += length;
                if (length > o.max_clip) penalty += o.clip_penalty;
                break;
            case 5:                            // H
                if (length > o.max_clip) penalty += o.clip_penalty;
                break;
            case 3: case 6:                    // NSKIP, P
                ref_i += length;
                break;
            default:
                break;
            }
        }
        uint8_t misaligned = 0;
        if (o.use_filter) {
            const int64_t k = (int64_t)std::floor(penalty);
            if (k > 0) {
                const double ln_missmap = -(std::log(10.0) / 10.0) * B.mapq[r];
                const double ln_mapped =
                    B.mapq[r] > 0 ? std::log1p(-std::exp(ln_missmap))
                                  : -std::numeric_limits<double>::infinity();
                const double mu = o.mutation_rate * (double)(end - begin);
                if (ln_mapped + poisson_lnsf(k - 1, mu) < o.min_ln_prob)
                    misaligned = 1;
            }
        }
        for (auto& f : found) {
            if (f.end - f.begin > o.max_variant_size) continue;
            int32_t sum_q = 0;
            for (int32_t i = 0; i < f.alt_len; ++i) sum_q += rq[f.offset + i];
            f.sum_q = sum_q;
            f.at_edge = (f.begin == begin || f.end == end) ? 1 : 0;
            f.misaligned = misaligned;
            out.push_back(f);
        }
    }
}

// ---- inclusion predicates (cigar_scanner.cpp:500-799) ----------------------

// exact two-sided Fisher p: the tail of hypergeometric pmfs at or below the
// observed one (+1e-7 in log space), as cigar_scanner._fisher_two_sided_p
static double fisher_two_sided_p(int64_t a, int64_t b, int64_t c, int64_t d) {
    const int64_t n = a + b + c + d;
    if (n == 0) return 1.0;
    const int64_t r1 = a + b, r2 = c + d, c1 = a + c;
    const int64_t lo = std::max<int64_t>(0, c1 - r2), hi = std::min(c1, r1);
    auto lg = [](int64_t x) { return std::lgamma((double)x); };
    const double whole = lg(n + 1) - lg(c1 + 1) - lg(n - c1 + 1);
    auto lp = [&](int64_t x) {
        return lg(r1 + 1) - lg(x + 1) - lg(r1 - x + 1) + lg(r2 + 1) -
               lg(c1 - x + 1) - lg(r2 - c1 + x + 1) - whole;
    };
    const double p_obs = lp(a);
    double total = 0.0;
    for (int64_t x = lo; x <= hi; ++x) {
        const double l = lp(x);
        if (l <= p_obs + 1e-7) total += std::exp(l);
    }
    return std::min(total, 1.0);
}

static bool only_one_strand(int64_t fwd, int64_t rev) {
    return (fwd + rev) > 0 && (fwd == 0 || rev == 0);
}

static double median(std::vector<int32_t> q) {
    std::sort(q.begin(), q.end());
    const size_t n = q.size();
    return n % 2 ? (double)q[n / 2] : ((double)q[n / 2 - 1] + (double)q[n / 2]) / 2.0;
}

static bool is_tandem_repeat(const std::string& s, int max_period = 4) {
    const size_t n = s.size();
    for (int p = 1; p <= max_period; ++p)
        if (n >= 2 * (size_t)p && s.compare(p, n - p, s, 0, n - p) == 0) return true;
    return false;
}

// one sample's observations of a group
struct Stats {
    int64_t depth = 0, fwd_depth = 0, fwd_support = 0, edge_support = 0;
    std::vector<int32_t> quals;   // sum of alt base qualities, one an observation
};

static bool is_good_germline(const Var& v, const Stats& st, int copy_number,
                             bool allow_strand_bias) {
    const std::vector<int32_t>& quals = st.quals;
    const int64_t support = (int64_t)quals.size();
    const int64_t depth = st.depth;
    int64_t sum_q = 0;
    for (int32_t q : quals) sum_q += q;
    if (depth < 4) return support > 1 || sum_q >= 30 || v.alt.size() < v.ref.size();
    const int64_t rev_support = support - st.fwd_support;
    const int64_t rev_depth = depth - st.fwd_depth;
    // the strand-bias test decides only here
    if (!allow_strand_bias && support > 20 && only_one_strand(st.fwd_support, rev_support)) {
        const double bias = 1.0 - fisher_two_sided_p(
            st.fwd_support, std::max<int64_t>(st.fwd_depth - st.fwd_support, 0),
            rev_support, std::max<int64_t>(rev_depth - rev_support, 0));
        if (bias > 0.99) return false;
    }
    auto count_at_least = [&](int32_t t) {
        int64_t c = 0;
        for (int32_t q : quals) c += q >= t;
        return c;
    };
    auto best_at_least = [&](int32_t t) {
        int32_t best = -1;
        for (int32_t q : quals) if (q >= t && q > best) best = q;
        return best;
    };
    if (v.ref.size() == 1 && v.alt.size() == 1) {   // snv
        if (support >= 10 && only_one_strand(st.fwd_support, rev_support) &&
            median(quals) < 15)
            return false;   // run-through artifact
        const int64_t good = count_at_least(20);
        if (depth <= 10) return good > 1;
        return good > 2 && (double)good / (double)depth > 1.0 / (5 * copy_number);
    }
    if (v.alt.size() > v.ref.size()) {              // insertion
        const int64_t alt_size = (int64_t)v.alt.size();
        if (support == 1 && alt_size > 10) return false;
        if (depth < 10) return support > 1 || (alt_size > 3 && is_tandem_repeat(v.alt));
        if (depth <= 30) return support > 1;
        const bool mid = depth <= 60;
        if (support == 1) return false;
        if ((double)support / (double)depth > (mid ? 0.3 : 0.35)) return true;
        const int32_t t = mid ? 25 : 20;
        const int64_t good = count_at_least(t);
        if (good <= 1) return false;
        if (good > (mid ? 2 : 3)) return true;
        return (double)best_at_least(t) / (double)alt_size > 20;
    }
    const int64_t region_size = v.end - v.begin;   // deletion or mnv
    if (region_size < 10)
        return support > 1 && (double)support / (double)depth > 1.0 / (10 * copy_number);
    return (double)support / ((double)depth - std::sqrt((double)depth)) >
           1.0 / (5 * copy_number);
}

static bool is_good_pacbio(const Var& v, int64_t depth, int64_t support) {
    const double vaf = (double)support / (double)std::max<int64_t>(depth, 1);
    if (v.alt.size() > v.ref.size()) {
        const size_t alt_size = v.alt.size();
        if (alt_size > 500) return true;
        if (alt_size > 200) return vaf > 0.02;
        if (alt_size > 20) return vaf > 0.05;
        if (support < 2) return false;
        if (alt_size <= 2) return vaf > 0.2;
        if (alt_size < 4) return vaf > 0.1;
        return vaf > 0.05;
    }
    if (v.alt.size() < v.ref.size() || v.end - v.begin > 1) {
        const int64_t size = v.end - v.begin;
        if (size > 50) return vaf > 0.1;
        if (support < 2) return false;
        if (size <= 2) return vaf > 0.2;
        if (size < 4) return vaf > 0.1;
        return vaf > 0.05;
    }
    return support > 1 && vaf > 0.1;
}

// ---- de-Bruijn reassembly ---------------------------------------------------

struct AsmOptions {
    std::vector<int> kmer_sizes;
    long long bin_size = 600, bin_overlap = 200;
    int mask_threshold = 10, min_weight = 1, max_bubbles = 30;
    double min_score = 2.0;
    long long max_variant_size = 5000;
    int max_extension = 700, num_fallbacks = 10, fallback_interval = 10;
    int assemble_all = 0;
    long long max_steps = 100000;
    long long max_size = 5000;    // the generator's size limit on its output
};

struct Edge {
    int dst;
    int weight;
    bool is_ref;   // edge on the reference path
    int ref_order; // index on the reference path, -1 otherwise
    int next;      // the source's next edge in insertion order, -1 last
};

static inline uint64_t mix64(uint64_t x) {
    x += 0x9E3779B97F4A7C15ull;
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
    x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
    return x ^ (x >> 31);
}

// a (k-1)-mer of A, C, G, T packed 2 bits a base into W words
template <int W>
struct Key {
    uint64_t w[W];
    bool operator==(const Key& o) const {
        for (int i = 0; i < W; ++i)
            if (w[i] != o.w[i]) return false;
        return true;
    }
};

template <int W>
struct KeyHash {
    size_t operator()(const Key<W>& k) const {
        uint64_t h = 0;
        for (int i = 0; i < W; ++i) h = mix64(h ^ k.w[i]);
        return (size_t)h;
    }
};

// (k-1)-mer -> node id, open addressing with linear probes
template <int W>
struct KmerTable {
    std::vector<Key<W>> keys;
    std::vector<int32_t> ids;   // -1: empty
    size_t mask = 0, count = 0;

    KmerTable() { reset(1024); }

    void reset(size_t capacity) {
        keys.assign(capacity, Key<W>{});
        ids.assign(capacity, -1);
        mask = capacity - 1;
        count = 0;
    }

    // the id of `key`, or -1 after inserting it with `id`
    int find_or_insert(const Key<W>& key, int32_t id) {
        for (size_t h = KeyHash<W>()(key) & mask;; h = (h + 1) & mask) {
            if (ids[h] < 0) {
                keys[h] = key;
                ids[h] = id;
                if (2 * ++count > mask) grow();
                return -1;
            }
            if (keys[h] == key) return ids[h];
        }
    }

    void grow() {
        std::vector<Key<W>> old_keys;
        std::vector<int32_t> old_ids;
        old_keys.swap(keys);
        old_ids.swap(ids);
        reset(2 * old_ids.size());
        for (size_t i = 0; i < old_ids.size(); ++i)
            if (old_ids[i] >= 0) find_or_insert(old_keys[i], old_ids[i]);
    }
};

// Nodes are (k-1)-mers, numbered in order of first insertion; edges keep
// insertion order, so the bubble search visits them as a graph of
// insertion-ordered dicts does.
struct Graph {
    int k, m;                            // m = k - 1
    std::vector<const uint8_t*> text;    // each node's (k-1)-mer
    std::vector<Edge> edges;             // every node's out-edges, linked
    std::vector<int> head, tail;         // a node's first and last edge
    std::vector<int> ref_path;           // node ids along the reference
    std::vector<int> ref_index;          // node id -> position on it (-1)
    bool valid = true;

    explicit Graph(int k_) : k(k_), m(k_ - 1) {}

    int add_node(const uint8_t* s) {
        text.push_back(s);
        head.push_back(-1);
        tail.push_back(-1);
        return (int)text.size() - 1;
    }

    Edge* find_edge(int src, int dst) {
        for (int e = head[src]; e >= 0; e = edges[e].next)
            if (edges[e].dst == dst) return &edges[e];
        return nullptr;
    }

    void add_edge(int src, int dst, int weight, bool is_ref, int ref_order) {
        const int e = (int)edges.size();
        edges.push_back(Edge{dst, weight, is_ref, ref_order, -1});
        if (tail[src] < 0) head[src] = e;
        else edges[tail[src]].next = e;
        tail[src] = e;
    }

    void prune(int min_weight) {
        // strict threshold: the reference's junction leniency keeps
        // single-read noise paths alive in this simpler pipeline
        for (size_t v = 0; v < head.size(); ++v) {
            int* link = &head[v];
            for (int e = head[v]; e >= 0; e = edges[e].next)
                if (edges[e].weight >= min_weight || edges[e].is_ref) {
                    *link = e;
                    link = &edges[e].next;
                }
            *link = -1;
        }
        ref_index.resize(text.size(), -1);
    }
};

// Builds a Graph on (k-1)-mers of A, C, G, T packed 2 bits a base into W
// words; a (k-1)-mer with another base code (N) is keyed by its bytes.
// `packed` false keys every (k-1)-mer by its bytes (k - 1 beyond 32 W).
template <int W>
struct KmerGraph : Graph {
    bool packed = true;
    KmerTable<W> ids;
    std::unordered_map<std::string, int> other;
    const uint8_t* ref_text = nullptr;
    std::vector<Key<W>> ref_keys;        // the reference's (k-1)-mers
    std::vector<char> ref_plain;         // ... where packed
    uint64_t top;                        // the key's bits in its first word

    KmerGraph(int k_, bool packed_) : Graph(k_), packed(packed_) {
        const int bits = 2 * m - 64 * (W - 1);
        top = bits >= 64 ? ~0ull : ((1ull << bits) - 1);
    }

    int intern(const Key<W>& key, bool plain, const uint8_t* s) {
        const int id = (int)text.size();
        if (plain) {
            const int found = ids.find_or_insert(key, id);
            if (found >= 0) return found;
        } else {
            auto ins = other.try_emplace(std::string((const char*)s, (size_t)m), id);
            if (!ins.second) return ins.first->second;
        }
        return add_node(s);
    }

    // shifts base s[j] into the key of the window that ends at j;
    // last_other: the last position of a base other than A, C, G, T
    void roll(Key<W>& key, int64_t& last_other, const uint8_t* s, int64_t j) const {
        uint64_t c = s[j];
        if (c > 3) { last_other = j; c = 0; }
        if (!packed) return;
        for (int i = 0; i + 1 < W; ++i)
            key.w[i] = (key.w[i] << 2) | (key.w[i + 1] >> 62);
        key.w[W - 1] = (key.w[W - 1] << 2) | c;
        key.w[0] &= top;
    }

    void insert_reference(const uint8_t* seq, int64_t n) {
        if (n < k) { valid = false; return; }
        size_t capacity = 1024;
        while (capacity < 4 * (size_t)n) capacity *= 2;
        ids.reset(capacity);
        ref_text = seq;
        Key<W> key{};
        int64_t last_other = -1;
        for (int64_t j = 0; j < n; ++j) {
            roll(key, last_other, seq, j);
            const int64_t i = j - m + 1;
            if (i < 0) continue;
            const bool plain = packed && last_other < i;
            ref_path.push_back(intern(key, plain, seq + i));
            ref_keys.push_back(key);
            ref_plain.push_back(plain);
        }
        {   // reference (k-1)-mers must be unique at this k
            std::vector<char> seen(text.size(), 0);
            for (int id : ref_path) {
                if (seen[id]) { valid = false; return; }
                seen[id] = 1;
            }
        }
        for (size_t i = 0; i + 1 < ref_path.size(); ++i) {
            const int src = ref_path[i], dst = ref_path[i + 1];
            Edge* e = find_edge(src, dst);
            if (!e) add_edge(src, dst, 0, true, (int)i);
            else { e->is_ref = true; e->ref_order = (int)i; }
        }
        ref_index.assign(text.size(), -1);
        for (size_t i = 0; i < ref_path.size(); ++i) ref_index[ref_path[i]] = (int)i;
    }

    // a read's k-mers, split at masked bases (code 4)
    void insert_read(const uint8_t* seq, int64_t n) {
        int64_t start = 0;
        for (int64_t i = 0; i <= n; ++i) {
            if (i == n || seq[i] == 4) {
                if (i - start >= k) insert_segment(seq + start, i - start);
                start = i + 1;
            }
        }
    }

    // Consecutive (k-1)-mers make an edge, or add one to its weight. Where
    // the read follows the reference path, the steps are reference edges,
    // whose weights the bubble search never reads: those steps are skipped,
    // up to the last reference node the read reaches.
    void insert_segment(const uint8_t* s, int64_t n) {
        const int64_t n_ref = (int64_t)ref_path.size();
        Key<W> key{};
        int64_t last_other = -1;
        for (int64_t j = 0; j < m - 1; ++j) roll(key, last_other, s, j);
        int prev = -1;
        for (int64_t j = m - 1; j < n; ++j) {
            roll(key, last_other, s, j);
            const int64_t i = j - m + 1;             // this window's start
            const bool plain = packed && last_other < i;
            const int at = prev >= 0 && prev < (int)ref_index.size() ? ref_index[prev] : -1;
            int node;
            if (plain && at >= 0 && at + 1 < n_ref && ref_plain[at + 1] &&
                ref_keys[at + 1] == key)
                node = ref_path[at + 1];
            else
                node = intern(key, plain, s + i);
            if (prev >= 0) {
                Edge* e = find_edge(prev, node);
                if (e) e->weight += 1;
                else add_edge(prev, node, 1, false, -1);
            }
            prev = node;
            const int here = node < (int)ref_index.size() ? ref_index[node] : -1;
            if (here < 0) continue;
            // the windows that go on along the reference path
            int64_t t = 0;
            while (j + 1 + t < n && here + 1 + t < n_ref &&
                   s[j + 1 + t] == ref_text[here + m + t])
                ++t;
            if (!t) continue;
            j += t;
            prev = ref_path[here + t];
            if (ref_plain[here + t]) {
                key = ref_keys[here + t];
            } else {
                for (int64_t u = j - m + 1; u <= j; ++u) roll(key, last_other, s, u);
            }
        }
    }
};

struct PathEntry {
    int node;
    int parent;  // index into arena, -1 for root
    int start_i; // seed position on the reference path
    int min_w;
    int depth;   // number of nodes on the alt path
};

struct HeapItem {
    int score;       // min edge support along the path
    long counter;    // global push order (FIFO tie-break)
    int entry;       // arena index
    bool operator<(const HeapItem& o) const {
        // max-heap on score, then min on counter
        if (score != o.score) return score < o.score;
        return counter > o.counter;
    }
};

struct Bubble {
    int start_i, end_i;
    std::string alt;
};

static bool path_contains(const std::vector<PathEntry>& arena, int entry, int node) {
    for (int e = entry; e >= 0; e = arena[e].parent)
        if (arena[e].node == node) return true;
    return false;
}

// Alt paths that leave the reference path and rejoin it downstream, best
// first by their weakest edge, ties in push order; at most max_steps pushes
static std::vector<Bubble> extract(const Graph& g, int max_bubbles, double min_score,
                                   int max_extension, long max_steps) {
    std::vector<Bubble> out;
    std::vector<PathEntry> arena;
    std::priority_queue<HeapItem> heap;
    long counter = 0;
    for (size_t i = 0; i + 1 < g.ref_path.size(); ++i) {
        const int src = g.ref_path[i];
        for (int x = g.head[src]; x >= 0; x = g.edges[x].next) {
            const Edge& e = g.edges[x];
            if (e.is_ref && e.ref_order == (int)i) continue;
            if (e.weight <= 0) continue;
            if (counter >= max_steps) break;
            arena.push_back(PathEntry{e.dst, -1, (int)i, e.weight, 1});
            heap.push(HeapItem{e.weight, counter++, (int)arena.size() - 1});
        }
    }
    std::set<std::tuple<int, int, std::string>> seen;
    while (!heap.empty() && (int)out.size() < max_bubbles) {
        const HeapItem item = heap.top();
        heap.pop();
        const PathEntry ent = arena[item.entry];
        const int node = ent.node;
        const int ridx = g.ref_index[node];
        if (ridx >= 0 && ridx > ent.start_i) {
            // rejoined the reference: alt = first ref node + last base of
            // each path node in root->leaf order
            std::string alt((const char*)g.text[g.ref_path[ent.start_i]], (size_t)g.m);
            alt.resize((size_t)(g.m + ent.depth));
            int e = item.entry;
            for (int d = ent.depth - 1; d >= 0; --d, e = arena[e].parent)
                alt[g.m + d] = (char)g.text[arena[e].node][g.m - 1];
            auto key = std::make_tuple(ent.start_i, ridx, alt);
            if (!seen.count(key) && ent.min_w >= min_score) {
                seen.insert(key);
                out.push_back(Bubble{ent.start_i, ridx, std::move(alt)});
            }
            continue;
        }
        if (ent.depth > max_extension) continue;
        for (int x = g.head[node]; x >= 0; x = g.edges[x].next) {
            const Edge& e = g.edges[x];
            if (e.weight <= 0 && !e.is_ref) continue;
            if (e.dst == g.ref_path[ent.start_i] ||
                path_contains(arena, item.entry, e.dst))
                continue;
            if (counter >= max_steps) break;
            const int eff = e.is_ref ? ent.min_w : std::min(ent.min_w, e.weight);
            arena.push_back(PathEntry{e.dst, item.entry, ent.start_i, eff,
                                      ent.depth + 1});
            heap.push(HeapItem{eff, counter++, (int)arena.size() - 1});
        }
    }
    return out;
}

// the bubbles of one bin at one k; false where a (k-1)-mer repeats on the
// reference (the reference's assembler rejects such a k)
template <int W>
static bool bubbles_at(const uint8_t* ref, int64_t n, const std::vector<uint8_t>& reads,
                       const std::vector<int64_t>& offsets, int k, bool packed,
                       const AsmOptions& o, std::vector<Bubble>& out) {
    KmerGraph<W> g(k, packed);
    g.insert_reference(ref, n);
    if (!g.valid) return false;
    for (size_t r = 0; r + 1 < offsets.size(); ++r)
        g.insert_read(reads.data() + offsets[r], offsets[r + 1] - offsets[r]);
    g.prune(o.min_weight);
    out = extract(g, o.max_bubbles, o.min_score, o.max_extension, (long)o.max_steps);
    return true;
}

static bool bubbles_for(const uint8_t* ref, int64_t n, const std::vector<uint8_t>& reads,
                        const std::vector<int64_t>& offsets, int k,
                        const AsmOptions& o, std::vector<Bubble>& out) {
    const int words = (2 * (k - 1) + 63) / 64;
    switch (words) {
    case 1: return bubbles_at<1>(ref, n, reads, offsets, k, true, o, out);
    case 2: return bubbles_at<2>(ref, n, reads, offsets, k, true, o, out);
    case 3: return bubbles_at<3>(ref, n, reads, offsets, k, true, o, out);
    case 4: return bubbles_at<4>(ref, n, reads, offsets, k, true, o, out);
    default: return bubbles_at<1>(ref, n, reads, offsets, k, false, o, out);
    }
}

// mismatches of each aligned column, and each gap up to max_size
static void variants_from_alignment(int64_t ref_begin, const uint8_t* ref,
                                    const std::string& alt,
                                    const std::vector<std::pair<int32_t, int32_t>>& ops,
                                    long long max_size, std::vector<Var>& out) {
    int64_t ri = 0, bi = 0;
    for (const auto& op : ops) {
        const int64_t length = op.first;
        if (op.second == 0) {
            for (int64_t k = 0; k < length; ++k)
                if (ref[ri + k] != (uint8_t)alt[bi + k])
                    out.push_back(Var{ref_begin + ri + k, ref_begin + ri + k + 1,
                                      std::string(1, (char)ref[ri + k]),
                                      std::string(1, alt[bi + k])});
            ri += length;
            bi += length;
        } else if (op.second == 2) {
            if (length <= max_size)
                out.push_back(Var{ref_begin + ri, ref_begin + ri + length,
                                  std::string((const char*)ref + ri, (size_t)length),
                                  std::string()});
            ri += length;
        } else {
            if (length <= max_size)
                out.push_back(Var{ref_begin + ri, ref_begin + ri, std::string(),
                                  alt.substr((size_t)bi, (size_t)length)});
            bi += length;
        }
    }
}

// one bin: the default k-mer sizes, then the fallback ladder until one k is
// unambiguous; the largest k's variants and those two sizes confirm
static void assemble_bin(const Batch& B, const std::vector<Py_ssize_t>& reads,
                         int64_t begin, int64_t end, const Ref& R,
                         const AsmOptions& o, std::vector<Var>& out) {
    const int pad = *std::max_element(o.kmer_sizes.begin(), o.kmer_sizes.end());
    const int64_t ref_begin = std::max<int64_t>(begin - pad, 0);
    const int64_t ref_end = std::min<int64_t>(end + pad, R.contig_size);
    const uint8_t* ref = R.base + (ref_begin - R.lo);
    const int64_t n = std::max<int64_t>(ref_end - ref_begin, 0);
    std::vector<uint8_t> masked;
    std::vector<int64_t> offsets{0};
    for (Py_ssize_t r : reads) {
        for (int64_t i = B.soff[r]; i < B.soff[r + 1]; ++i)
            masked.push_back(B.quals[i] < o.mask_threshold ? 4 : B.seq[i]);
        offsets.push_back((int64_t)masked.size());
    }
    std::vector<int> ks(o.kmer_sizes);
    for (int i = 0; i < o.num_fallbacks; ++i)
        ks.push_back(pad + (i + 1) * o.fallback_interval);
    std::vector<std::pair<int, std::vector<Var>>> per_k;
    std::vector<Bubble> bubbles;
    for (size_t tier = 0; tier < ks.size(); ++tier) {
        const int k = ks[tier];
        if (tier >= o.kmer_sizes.size() && !per_k.empty()) break;
        if (n < k + 1) continue;
        if (!bubbles_for(ref, n, masked, offsets, k, o, bubbles)) continue;
        std::vector<Var> got;
        for (const Bubble& b : bubbles) {
            // the bubble spans reference [start_i, end_i + k - 1)
            const uint8_t* seg = ref + b.start_i;
            const int64_t seg_n = b.end_i + k - 1 - b.start_i;
            if ((int64_t)b.alt.size() == seg_n &&
                std::memcmp(seg, b.alt.data(), (size_t)seg_n) == 0)
                continue;
            const size_t first = got.size();
            variants_from_alignment(
                ref_begin + b.start_i, seg, b.alt,
                global_align(seg, seg_n, (const uint8_t*)b.alt.data(),
                             (int64_t)b.alt.size(), 2, -3, -8, -1),
                o.max_variant_size, got);
            for (size_t i = first; i < got.size(); ++i)
                if (got[i].is_indel()) left_align(got[i], R);
        }
        auto it = std::find_if(per_k.begin(), per_k.end(),
                               [k](const auto& kv) { return kv.first == k; });
        if (it == per_k.end()) per_k.emplace_back(k, std::move(got));
        else it->second = std::move(got);
    }
    if (per_k.empty()) return;
    if (per_k.size() == 1) {
        out.insert(out.end(), per_k[0].second.begin(), per_k[0].second.end());
        return;
    }
    // cross-k confirmation: at small k, (k-1)-mers shared between distant
    // loci can glue phantom bubbles out of real reads' paths; a real event
    // survives at every k that holds its junction context
    std::map<Var, int> counts;
    for (auto& kv : per_k) {
        std::vector<Var> distinct(kv.second);
        std::sort(distinct.begin(), distinct.end());
        distinct.erase(std::unique(distinct.begin(), distinct.end()), distinct.end());
        for (const Var& v : distinct) ++counts[v];
    }
    const auto largest = std::max_element(
        per_k.begin(), per_k.end(),
        [](const auto& a, const auto& b) { return a.first < b.first; });
    out.insert(out.end(), largest->second.begin(), largest->second.end());
    for (const auto& kv : counts)
        if (kv.second >= 2) out.push_back(kv.first);
}

// the reassembler over one batch: bins of signal-bearing reads. Returns
// the number of mismatch-dense reads where they were too many to trigger
// assembly, else 0.
static int64_t reassemble(const Batch& B, const Ref& R, int64_t region_begin,
                          int64_t region_end, const AsmOptions& o, std::vector<Var>& out) {
    // reads with indels or soft clips of >= 2 bases (TriggerType::indel)
    std::vector<char> interesting((size_t)B.n, 0);
    for (Py_ssize_t r = 0; r < B.n; ++r)
        for (int64_t c = B.coff[r]; c < B.coff[r + 1]; ++c) {
            const int32_t len = B.cig[2 * c], op = B.cig[2 * c + 1];
            if (op == 1 || op == 2 || (op == 4 && len >= 2)) interesting[r] = 1;
        }
    // reads of one M operation with >= 2 mismatches (TriggerType::clustered)
    std::vector<char> dense((size_t)B.n, 0);
    int64_t n_dense = 0;
    if (B.n) {
        int64_t lo = B.begins[0], hi = B.ends[0];
        for (Py_ssize_t r = 0; r < B.n; ++r) {
            lo = std::min(lo, B.begins[r]);
            hi = std::max(hi, B.ends[r]);
        }
        lo = std::max<int64_t>(lo, 0);
        hi = std::min(hi, R.contig_size);
        for (Py_ssize_t r = 0; hi > lo && r < B.n; ++r) {
            if (B.coff[r + 1] - B.coff[r] != 1 || B.cig[2 * B.coff[r] + 1] != 0) continue;
            int mism = 0;
            for (int64_t i = 0; i < B.soff[r + 1] - B.soff[r]; ++i) {
                const int64_t p = B.begins[r] + i;
                if (p >= lo && p < hi && B.seq[B.soff[r] + i] != R.at(p)) ++mism;
            }
            if (mism >= 2) { dense[r] = 1; ++n_dense; }
        }
    }
    // a majority of dense reads over many reads is a wrong reference or an
    // unalignable region, not a local event: the clustered trigger stays off
    const bool suppress = B.n && (double)n_dense / (double)B.n > 0.5 && n_dense >= 256;
    if (!suppress)
        for (Py_ssize_t r = 0; r < B.n; ++r) interesting[r] |= dense[r];
    const int64_t step = o.bin_size - o.bin_overlap;
    std::vector<Py_ssize_t> over;
    for (int64_t pos = region_begin; pos < region_end; pos += step) {
        const int64_t bin_end = std::min(pos + (int64_t)o.bin_size, region_end);
        over.clear();
        int64_t n_int = 0;
        for (Py_ssize_t r = 0; r < B.n; ++r)
            if (B.begins[r] < bin_end && B.ends[r] > pos) {
                over.push_back(r);
                n_int += interesting[r];
            }
        const int64_t n_over = (int64_t)over.size();
        if (n_over >= 2 &&
            (o.assemble_all || (double)n_int >= std::max(2.0, 0.05 * (double)n_over)))
            assemble_bin(B, over, pos, bin_end, R, o, out);
    }
    return suppress ? n_dense : 0;
}

// ---- the window ---------------------------------------------------------------

struct Group {
    int64_t begin, end;
    std::string alt;
};

struct GroupKeyHash {
    size_t operator()(const std::tuple<int64_t, int64_t, std::string>& k) const {
        return (size_t)mix64((uint64_t)std::get<0>(k) * 31 + (uint64_t)std::get<1>(k)) ^
               std::hash<std::string>()(std::get<2>(k));
    }
};

struct Obs {
    int32_t group, sample, sum_q;
    uint8_t forward, at_edge;
};

struct Out {
    std::vector<Var> found;          // included, all sources
    // groups for the caller's inclusion predicate
    std::vector<int64_t> groups;     // (begin, end, ref_len, alt_len, row0, row1)
    std::string group_seqs;
    std::vector<int64_t> rows;       // (sample, depth, fwd_depth, fwd_support,
                                     //  edge_support, q0, q1)
    std::vector<int32_t> quals;
    std::vector<int64_t> suppressed; // (batch, dense reads, reads)
};

static void scan_window(const std::vector<Batch>& batches, const Ref& R,
                        int64_t region_begin, int64_t region_end,
                        const ScanOptions& o, Out& out) {
    std::unordered_map<std::tuple<int64_t, int64_t, std::string>, int32_t, GroupKeyHash> ids;
    std::vector<Group> groups;
    std::vector<Obs> obs;
    std::vector<ScanCand> cands;
    int n_samples = 0;
    int64_t lo = std::numeric_limits<int64_t>::max(), hi = std::numeric_limits<int64_t>::min();
    for (const Batch& B : batches) {
        n_samples = std::max(n_samples, B.sample + 1);
        for (Py_ssize_t r = 0; r < B.n; ++r) {
            lo = std::min(lo, B.begins[r]);
            hi = std::max(hi, B.ends[r]);
        }
        cands.clear();
        scan_batch(B, R, o, cands);
        for (const ScanCand& c : cands) {
            if (c.misaligned) continue;
            if ((c.begin >= region_end || c.end <= region_begin) &&
                !(c.begin == c.end && c.begin == region_begin))
                continue;
            std::tuple<int64_t, int64_t, std::string> key(
                c.begin, c.end,
                std::string((const char*)B.seq + B.soff[c.read] + c.offset, (size_t)c.alt_len));
            auto ins = ids.try_emplace(std::move(key), (int32_t)groups.size());
            if (ins.second)
                groups.push_back(Group{c.begin, c.end, std::get<2>(ins.first->first)});
            obs.push_back(Obs{ins.first->second, B.sample, c.sum_q,
                              (uint8_t)!(B.flags[c.read] & 16), c.at_edge});
        }
    }
    if (obs.empty()) return;
    // coverage over the reads' span, each sample, forward strand and all
    const int64_t n = hi - lo + 1;
    std::vector<int32_t> cov((size_t)(n_samples * n), 0), fwd((size_t)(n_samples * n), 0),
        total((size_t)n, 0);
    for (const Batch& B : batches)
        for (Py_ssize_t r = 0; r < B.n; ++r) {
            const int64_t b = B.begins[r] - lo, e = B.ends[r] - lo;
            int32_t* cs = cov.data() + B.sample * n;
            ++cs[b]; --cs[e];
            ++total[b]; --total[e];
            if (!(B.flags[r] & 16)) {
                int32_t* fs = fwd.data() + B.sample * n;
                ++fs[b]; --fs[e];
            }
        }
    for (int s = 0; s < n_samples; ++s)
        for (int64_t i = 1; i < n; ++i) {
            cov[s * n + i] += cov[s * n + i - 1];
            fwd[s * n + i] += fwd[s * n + i - 1];
        }
    for (int64_t i = 1; i < n; ++i) total[i] += total[i - 1];
    auto min_depth = [&](const int32_t* arr, int64_t b, int64_t e) -> int64_t {
        b = std::min(std::max<int64_t>(b - lo, 0), n - 1);
        e = std::min(std::max(e - lo, b + 1), n);
        int32_t m = arr[b];
        for (int64_t i = b + 1; i < e; ++i) m = std::min(m, arr[i]);
        return m;
    };
    // observations by group, then sample
    std::vector<int32_t> order(obs.size());
    for (size_t i = 0; i < obs.size(); ++i) order[i] = (int32_t)i;
    std::stable_sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
        return std::tie(obs[a].group, obs[a].sample) < std::tie(obs[b].group, obs[b].sample);
    });
    std::vector<std::pair<int, Stats>> stats;
    size_t i = 0;
    while (i < order.size()) {
        const int32_t gi = obs[order[i]].group;
        size_t j = i;
        while (j < order.size() && obs[order[j]].group == gi) ++j;
        const Group& gr = groups[gi];
        Var v{gr.begin, gr.end, R.slice(gr.begin, gr.end), gr.alt};
        bool include = false;
        if (o.inclusion == THRESHOLD) {
            include = (int64_t)(j - i) >= o.min_observations;
        } else {
            stats.clear();
            for (size_t a = i; a < j;) {
                const int s = obs[order[a]].sample;
                Stats st;
                for (; a < j && obs[order[a]].sample == s; ++a) {
                    const Obs& ob = obs[order[a]];
                    st.quals.push_back(ob.sum_q);
                    st.fwd_support += ob.forward;
                    st.edge_support += ob.at_edge;
                }
                st.depth = std::max(min_depth(cov.data() + s * n, v.begin, v.end),
                                    (int64_t)st.quals.size());
                st.fwd_depth = min_depth(fwd.data() + s * n, v.begin, v.end);
                stats.emplace_back(s, std::move(st));
            }
            if (o.inclusion == BY_CALLER) {
                const int64_t row0 = (int64_t)out.rows.size() / 7;
                for (const auto& sst : stats) {
                    const Stats& st = sst.second;
                    const int64_t q0 = (int64_t)out.quals.size();
                    out.quals.insert(out.quals.end(), st.quals.begin(), st.quals.end());
                    out.rows.insert(out.rows.end(),
                                    {(int64_t)sst.first, st.depth, st.fwd_depth,
                                     st.fwd_support, st.edge_support, q0,
                                     (int64_t)out.quals.size()});
                }
                out.groups.insert(out.groups.end(),
                                  {v.begin, v.end, (int64_t)v.ref.size(),
                                   (int64_t)v.alt.size(), row0,
                                   (int64_t)out.rows.size() / 7});
                out.group_seqs += v.ref;
                out.group_seqs += v.alt;
                i = j;
                continue;
            }
            for (const auto& sst : stats) {
                const Stats& st = sst.second;
                include = o.inclusion == GERMLINE
                    ? is_good_germline(v, st, o.copy_number, o.allow_strand_bias)
                    : is_good_pacbio(v, st.depth, (int64_t)st.quals.size());
                if (include) break;
            }
            if (!include && stats.size() > 1) {   // the samples pooled
                Stats pooled;
                pooled.depth = min_depth(total.data(), v.begin, v.end);
                for (const auto& sst : stats) {
                    pooled.fwd_depth += sst.second.fwd_depth;
                    pooled.fwd_support += sst.second.fwd_support;
                    pooled.quals.insert(pooled.quals.end(), sst.second.quals.begin(),
                                        sst.second.quals.end());
                }
                include = o.inclusion == GERMLINE
                    ? is_good_germline(v, pooled, o.copy_number, o.allow_strand_bias)
                    : is_good_pacbio(v, pooled.depth, (int64_t)pooled.quals.size());
            }
        }
        if (include) {
            if (v.is_indel()) left_align(v, R);
            out.found.push_back(std::move(v));
        }
        i = j;
    }
}

}  // namespace vargen

// Buffers of the arguments, released on return
struct Views {
    std::vector<Py_buffer> held;
    ~Views() { for (auto& b : held) PyBuffer_Release(&b); }
    // the buffer of obj as n_items of `item` bytes (n_items < 0: any count)
    const void* get(PyObject* obj, Py_ssize_t item, Py_ssize_t& n_items) {
        Py_buffer b;
        if (PyObject_GetBuffer(obj, &b, PyBUF_C_CONTIGUOUS) < 0) return nullptr;
        held.push_back(b);
        if (b.len % item || (n_items >= 0 && b.len / item != n_items)) {
            PyErr_SetString(PyExc_ValueError, "generate_candidates: buffer of the wrong size");
            return nullptr;
        }
        n_items = b.len / item;
        return b.buf;
    }
};

static PyObject* bytes_of(const void* p, size_t n) {
    return PyBytes_FromStringAndSize(n ? (const char*)p : "", (Py_ssize_t)n);
}

static PyObject* pack_vars(const std::vector<vargen::Var>& vs) {
    std::vector<int64_t> rec;
    std::string seqs;
    for (const auto& v : vs) {
        rec.insert(rec.end(), {v.begin, v.end, (int64_t)v.ref.size(),
                               (int64_t)v.alt.size(), (int64_t)v.edge});
        seqs += v.ref;
        seqs += v.alt;
    }
    return Py_BuildValue("(NN)", bytes_of(rec.data(), rec.size() * sizeof(int64_t)),
                         bytes_of(seqs.data(), seqs.size()));
}

// generate_candidates(ref: u8 contig[lo, hi), lo, contig_size,
//     batches: [(sample, begins i64, ends i64, mapq u8, flags u16, seq u8,
//                quals u8, seq_offsets i64, cigar_ops i32 (n, 2),
//                cigar_offsets i64)],
//     region_begin, region_end,
//     scanner: (use, snv_threshold, snv_penalty, indel_penalty, clip_penalty,
//               max_clip, max_variant_size, use_filter, mutation_rate,
//               min_ln_prob, inclusion, copy_number, allow_strand_bias,
//               min_observations),
//     assembler: None | (kmer_sizes i32, bin_size, bin_overlap,
//               mask_threshold, min_weight, max_bubbles, min_score,
//               max_variant_size, max_extension, num_fallbacks,
//               fallback_interval, assemble_all, max_steps, max_size))
//   -> ((records i64 (begin, end, ref_len, alt_len, edge), seqs),
//       groups i64 (begin, end, ref_len, alt_len, row0, row1), group_seqs,
//       rows i64 (sample, depth, fwd_depth, fwd_support, edge_support, q0, q1),
//       quals i32, suppressed i64 (batch, dense reads, reads))
// The records are the window's candidates from both generators, distinct,
// sorted by (begin, end, alt); an edge record's left alignment stopped at
// lo. The groups are the scanner's for the caller's predicate (inclusion 3).
static PyObject* generate_candidates(PyObject*, PyObject* args) {
    using namespace vargen;
    PyObject *ref_obj, *batch_list, *scan_t, *asm_t;
    long long ref_lo, contig_size, region_begin, region_end;
    if (!PyArg_ParseTuple(args, "OLLO!LLO!O", &ref_obj, &ref_lo, &contig_size,
                          &PyList_Type, &batch_list, &region_begin, &region_end,
                          &PyTuple_Type, &scan_t, &asm_t))
        return nullptr;
    Views views;
    Py_ssize_t ref_n = -1;
    const void* ref_p = views.get(ref_obj, 1, ref_n);
    if (!ref_p) return nullptr;
    const Ref R{(const uint8_t*)ref_p, ref_lo, ref_lo + ref_n, contig_size};
    ScanOptions so;
    if (!PyArg_ParseTuple(scan_t, "iidddiLiddiiii", &so.use, &so.snv_threshold,
                          &so.snv_penalty, &so.indel_penalty, &so.clip_penalty,
                          &so.max_clip, &so.max_variant_size, &so.use_filter,
                          &so.mutation_rate, &so.min_ln_prob, &so.inclusion,
                          &so.copy_number, &so.allow_strand_bias, &so.min_observations))
        return nullptr;
    AsmOptions ao;
    const bool assemble = asm_t != Py_None;
    if (assemble) {
        PyObject* ks;
        if (!PyArg_ParseTuple(asm_t, "OLLiiidLiiiiLL", &ks, &ao.bin_size, &ao.bin_overlap,
                              &ao.mask_threshold, &ao.min_weight, &ao.max_bubbles,
                              &ao.min_score, &ao.max_variant_size, &ao.max_extension,
                              &ao.num_fallbacks, &ao.fallback_interval, &ao.assemble_all,
                              &ao.max_steps, &ao.max_size))
            return nullptr;
        Py_ssize_t nk = -1;
        const int32_t* kp = (const int32_t*)views.get(ks, 4, nk);
        if (!kp) return nullptr;
        ao.kmer_sizes.assign(kp, kp + nk);
        if (ao.kmer_sizes.empty() || ao.bin_size <= ao.bin_overlap ||
            *std::min_element(ao.kmer_sizes.begin(), ao.kmer_sizes.end()) < 2) {
            PyErr_SetString(PyExc_ValueError,
                            "assembler: k-mer sizes >= 2 and a bin longer than its overlap");
            return nullptr;
        }
    }
    std::vector<Batch> batches;
    for (Py_ssize_t i = 0; i < PyList_GET_SIZE(batch_list); ++i) {
        PyObject* t = PyList_GET_ITEM(batch_list, i);
        Batch B;
        PyObject *o_beg, *o_end, *o_mq, *o_fl, *o_seq, *o_q, *o_so, *o_cig, *o_co;
        if (!PyArg_ParseTuple(t, "iOOOOOOOOO", &B.sample, &o_beg, &o_end, &o_mq, &o_fl,
                              &o_seq, &o_q, &o_so, &o_cig, &o_co))
            return nullptr;
        Py_ssize_t n = -1, n1, n_seq = -1, n_ops = -1, n_q;
        if (!(B.begins = (const int64_t*)views.get(o_beg, 8, n))) return nullptr;
        n1 = n + 1;
        if (!(B.ends = (const int64_t*)views.get(o_end, 8, n)) ||
            !(B.mapq = (const uint8_t*)views.get(o_mq, 1, n)) ||
            !(B.flags = (const uint16_t*)views.get(o_fl, 2, n)) ||
            !(B.seq = (const uint8_t*)views.get(o_seq, 1, n_seq)) ||
            !(B.quals = (const uint8_t*)views.get(o_q, 1, n_q = n_seq)) ||
            !(B.soff = (const int64_t*)views.get(o_so, 8, n1)) ||
            !(B.cig = (const int32_t*)views.get(o_cig, 8, n_ops)) ||
            !(B.coff = (const int64_t*)views.get(o_co, 8, n1 = n + 1)))
            return nullptr;
        bool ok = B.sample >= 0 && B.soff[0] >= 0 && B.coff[0] >= 0 &&
                  B.soff[n] <= n_seq && B.coff[n] <= n_ops;
        for (Py_ssize_t r = 0; ok && r < n; ++r)
            ok = B.soff[r] <= B.soff[r + 1] && B.coff[r] <= B.coff[r + 1] &&
                 B.begins[r] >= R.lo && B.begins[r] <= B.ends[r] &&
                 (B.ends[r] <= R.hi || R.hi == R.contig_size);
        if (!ok) {
            PyErr_SetString(PyExc_ValueError,
                            "generate_candidates: reads outside the reference held, "
                            "or offsets out of order");
            return nullptr;
        }
        B.n = n;
        batches.push_back(B);
    }
    if (assemble && region_begin < region_end) {
        const int pad = *std::max_element(ao.kmer_sizes.begin(), ao.kmer_sizes.end());
        if (std::max<int64_t>(region_begin - pad, 0) < R.lo ||
            std::min<int64_t>(region_end + pad, R.contig_size) > R.hi) {
            PyErr_SetString(PyExc_ValueError,
                            "generate_candidates: bins outside the reference held");
            return nullptr;
        }
    }
    Out out;
    std::string error;
    Py_BEGIN_ALLOW_THREADS
    try {
        if (so.use) scan_window(batches, R, region_begin, region_end, so, out);
        if (assemble)
            for (size_t b = 0; b < batches.size(); ++b) {
                std::vector<Var> got;
                const int64_t n_dense =
                    reassemble(batches[b], R, region_begin, region_end, ao, got);
                if (n_dense)
                    out.suppressed.insert(out.suppressed.end(),
                                          {(int64_t)b, n_dense, (int64_t)batches[b].n});
                for (Var& v : got)
                    if (v.end - v.begin <= ao.max_size) {
                        if (v.is_indel()) left_align(v, R);
                        out.found.push_back(std::move(v));
                    }
            }
        std::sort(out.found.begin(), out.found.end());
        out.found.erase(std::unique(out.found.begin(), out.found.end()), out.found.end());
    } catch (const std::exception& e) {
        error = e.what();
    }
    Py_END_ALLOW_THREADS
    if (!error.empty()) {
        PyErr_SetString(PyExc_RuntimeError, error.c_str());
        return nullptr;
    }
    return Py_BuildValue(
        "(NNNNNN)", pack_vars(out.found), bytes_of(out.groups.data(), out.groups.size() * 8),
        bytes_of(out.group_seqs.data(), out.group_seqs.size()),
        bytes_of(out.rows.data(), out.rows.size() * 8),
        bytes_of(out.quals.data(), out.quals.size() * 4),
        bytes_of(out.suppressed.data(), out.suppressed.size() * 8));
}

// banded_traceback(cm: int32 (R, W), gap_open: int32 (W), gap_extend:
// int32 (W), R, pad, nuc_prior) -> (score, first_pos, ops bytes)
// The banded Viterbi with traceback of core/likelihood/pairhmm_ref.py's
// banded_align on its match-cost matrix, cell for cell: the same parity
// quirk of row 0, the same tie-breaking (M over I over D, gap open over
// extend) and the same op string ('M', 'I', 'D', start to end).
static PyObject* banded_traceback(PyObject*, PyObject* args) {
    Py_buffer cm_b, opn_b, ext_b;
    int R, pad, nuc_prior;
    if (!PyArg_ParseTuple(args, "y*y*y*iii", &cm_b, &opn_b, &ext_b, &R, &pad,
                          &nuc_prior))
        return nullptr;
    const int D = 2 * pad;
    const int64_t W = (int64_t)R + 2 * pad - 1;
    if (R < 1 || pad < 1 || cm_b.len != (Py_ssize_t)(R * W * 4) ||
        opn_b.len != (Py_ssize_t)(W * 4) || ext_b.len != (Py_ssize_t)(W * 4)) {
        PyBuffer_Release(&cm_b); PyBuffer_Release(&opn_b);
        PyBuffer_Release(&ext_b);
        PyErr_SetString(PyExc_ValueError, "banded_traceback: bad shapes");
        return nullptr;
    }
    const int32_t* cm = (const int32_t*)cm_b.buf;
    const int32_t* opn = (const int32_t*)opn_b.buf;
    const int32_t* ext = (const int32_t*)ext_b.buf;
    const int32_t INF = 1 << 29;
    int32_t score = 0;
    int first_pos = 0;
    std::string ops;
    Py_BEGIN_ALLOW_THREADS
    const int64_t n = (int64_t)(R + 1) * D;
    std::vector<int32_t> Mt(n, INF), It(n, INF), Dt(n, INF);
    std::vector<int8_t> Mb(n, 0), Ib(n, 0), Db(n, 0);
    std::vector<int32_t> m0_gap(D);
    for (int d = 0; d < D; ++d) {
        Mt[d] = 0;
        Mb[d] = 3;
        // gap ops may only start from odd offsets (see banded_score)
        m0_gap[d] = (d % 2 == 1) ? 0 : INF;
    }
    for (int d = 1; d < D; ++d) {
        const int32_t via_open = m0_gap[d - 1] + opn[d - 1];
        const int32_t via_ext = Dt[d - 1] + ext[d - 1];
        if (via_open <= via_ext) { Dt[d] = via_open; Db[d] = 0; }
        else { Dt[d] = via_ext; Db[d] = 2; }
    }
    for (int y = 1; y <= R; ++y) {
        const int32_t* gap_row = y == 1 ? m0_gap.data() : &Mt[(y - 1) * D];
        const int64_t row = (int64_t)y * D, prev = row - D;
        for (int d = 0; d < D; ++d) {
            const int64_t x = y - 1 + d;
            // match: the first of the smallest of (M, I, D), as np.argmin
            int k = 0;
            int32_t best = Mt[prev + d];
            if (It[prev + d] < best) { best = It[prev + d]; k = 1; }
            if (Dt[prev + d] < best) { best = Dt[prev + d]; k = 2; }
            Mt[row + d] = cm[(int64_t)(y - 1) * W + x] + best;
            Mb[row + d] = (int8_t)k;
            if (d + 1 < D) {
                const int32_t via_open = gap_row[d + 1] + opn[x];
                const int32_t via_ext = It[prev + d + 1] + ext[x];
                if (via_open <= via_ext) {
                    It[row + d] = nuc_prior + via_open; Ib[row + d] = 0;
                } else {
                    It[row + d] = nuc_prior + via_ext; Ib[row + d] = 1;
                }
            }
            if (d > 0) {
                const int64_t xd = y + d - 1;
                const int32_t c0 = Mt[row + d - 1] + opn[xd];
                const int32_t c1 = It[row + d - 1] + opn[xd];
                const int32_t c2 = Dt[row + d - 1] + ext[xd];
                int kd = 0;
                int32_t bd = c0;
                if (c1 < bd) { bd = c1; kd = 1; }
                if (c2 < bd) { bd = c2; kd = 2; }
                Dt[row + d] = bd;
                Db[row + d] = (int8_t)kd;
            }
        }
    }
    // the first smallest of the last row's (M, I, D) cells, state-major
    const int64_t last = (int64_t)R * D;
    int state = 0, d = 0;
    score = Mt[last];
    const std::vector<int32_t>* tables[3] = {&Mt, &It, &Dt};
    for (int s = 0; s < 3; ++s)
        for (int dd = 0; dd < D; ++dd)
            if ((*tables[s])[last + dd] < score) {
                score = (*tables[s])[last + dd]; state = s; d = dd;
            }
    int y = R;
    while (!(y == 0 && state == 0)) {
        const int64_t at = (int64_t)y * D + d;
        if (state == 0) {
            state = Mb[at]; ops.push_back('M'); --y;
        } else if (state == 1) {
            state = Ib[at]; ops.push_back('I'); --y; ++d;
        } else {
            state = Db[at]; ops.push_back('D'); --d;
        }
    }
    std::reverse(ops.begin(), ops.end());
    first_pos = d;
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&cm_b); PyBuffer_Release(&opn_b); PyBuffer_Release(&ext_b);
    return Py_BuildValue("iiy#", (int)score, first_pos, ops.data(),
                         (Py_ssize_t)ops.size());
}

// ---------------------------------------------------------------------------
// Batched banded pair-HMM align + flank-score discount.
//
// Mirrors the reference's traceback-and-subtract flank correction
// (src/core/models/pairhmm/simd_pair_hmm.hpp:352-430 calculate_flank_score)
// and the repo's host golden model (pairhmm_ref.banded_align +
// flank_score_of_path), batched over the flank-overlapping rows of one
// device launch. Inputs are the same packed per-row windows the device
// kernel consumes; output is the flank-corrected phred score per row.
// ---------------------------------------------------------------------------

static const int32_t kInf = 1 << 29;
static const int32_t kNScore = 2;   // pairhmm_ref.N_SCORE
static const int32_t kNCode = 4;

struct FlankDP {
    // tables sized (R+1, D); backpointers 0=M,1=I,2=D,3=START
    std::vector<int32_t> M, I, D;
    std::vector<int8_t> Mb, Ib, Db;
    std::vector<char> ops;   // traceback scratch
    void resize(int rows, int d) {
        size_t n = (size_t)rows * d;
        M.assign(n, kInf); I.assign(n, kInf); D.assign(n, kInf);
        Mb.assign(n, 0); Ib.assign(n, 0); Db.assign(n, 0);
    }
};

static inline int32_t match_cost(int32_t t, int32_t w, int32_t q,
                                 int32_t m, int32_t pr) {
    int32_t pen = (t == w) ? 0 : ((m == t) ? std::min(q, pr) : q);
    if (w == kNCode) pen = std::min(pen, kNScore);
    return pen;
}

// ---------------------------------------------------------------------------
// Lane-batched score-only banded DP: G independent (read, window) pairs of
// identical length advance in lockstep, lane-minor, so every recurrence is
// a straight vertical vector op (the serial in-band deletion scan is
// unaffected — lanes are independent pairs).  Bit-identical min-plus math
// to the scalar traceback path above; used for rows that need no flank
// discount.  target_clones lets gcc emit AVX2/AVX-512 versions and pick at
// runtime without changing the baseline build flags.
// ---------------------------------------------------------------------------

static const int kLanes = 16;

#if defined(__x86_64__) && defined(__gnu_linux__)
__attribute__((target_clones("default", "avx2", "arch=x86-64-v4")))
#endif
static void banded_scores_group(
    int G, int R, int Dn, int nuc_prior,
    const int32_t* tgtT, const int32_t* qualT,   // (L, G) lane-minor
    const int32_t* winT, const int32_t* opnT, const int32_t* extT,
    const int32_t* mskT, const int32_t* priT,    // (W, G) lane-minor
    int32_t* M_prev, int32_t* I_prev, int32_t* D_prev,   // (Dn, G) scratch
    int32_t* M_cur, int32_t* I_cur, int32_t* D_cur,
    int32_t* out_scores) {
    const int GD = G;
    // row 0: M = 0 everywhere; I = inf; D via the odd-diagonal gap chain
    for (int d = 0; d < Dn; ++d)
        for (int g = 0; g < GD; ++g) {
            M_prev[d * GD + g] = 0;
            I_prev[d * GD + g] = kInf;
            D_prev[d * GD + g] = kInf;
        }
    for (int d = 1; d < Dn; ++d) {
        const int32_t m0 = ((d - 1) % 2 == 1) ? 0 : kInf;
        const int32_t* opn_x = opnT + (size_t)(d - 1) * GD;
        const int32_t* ext_x = extT + (size_t)(d - 1) * GD;
        for (int g = 0; g < GD; ++g) {
            const int32_t vo = m0 + opn_x[g];
            const int32_t ve = D_prev[(d - 1) * GD + g] + ext_x[g];
            D_prev[d * GD + g] = vo <= ve ? vo : ve;
        }
    }
    for (int y = 1; y <= R; ++y) {
        const int32_t* tgt_y = tgtT + (size_t)(y - 1) * GD;
        const int32_t* qual_y = qualT + (size_t)(y - 1) * GD;
        for (int d = 0; d < Dn; ++d) {
            const size_t x = (size_t)(y - 1 + d) * GD;
            const int32_t* win_x = winT + x;
            const int32_t* msk_x = mskT + x;
            const int32_t* pri_x = priT + x;
            const int32_t* opn_x = opnT + x;
            const int32_t* ext_x = extT + x;
            int32_t* Mc = M_cur + (size_t)d * GD;
            const int32_t* Mp = M_prev + (size_t)d * GD;
            const int32_t* Ip = I_prev + (size_t)d * GD;
            const int32_t* Dp = D_prev + (size_t)d * GD;
            for (int g = 0; g < GD; ++g) {
                const int32_t t = tgt_y[g], w = win_x[g], q = qual_y[g];
                int32_t pen = (t == w) ? 0
                              : ((msk_x[g] == t) ? (q < pri_x[g] ? q : pri_x[g])
                                                 : q);
                pen = (w == kNCode && pen > kNScore) ? kNScore : pen;
                int32_t best = Mp[g];
                if (Ip[g] < best) best = Ip[g];
                if (Dp[g] < best) best = Dp[g];
                Mc[g] = pen + best;
            }
            int32_t* Ic = I_cur + (size_t)d * GD;
            if (d + 1 < Dn) {
                const int32_t* Mp1 = M_prev + (size_t)(d + 1) * GD;
                const int32_t* Ip1 = I_prev + (size_t)(d + 1) * GD;
                const int32_t m0 = ((d + 1) % 2 == 1) ? 0 : kInf;
                for (int g = 0; g < GD; ++g) {
                    const int32_t mp = (y == 1) ? m0 : Mp1[g];
                    const int32_t vo = mp + opn_x[g];
                    const int32_t ve = Ip1[g] + ext_x[g];
                    Ic[g] = nuc_prior + (vo <= ve ? vo : ve);
                }
            } else {
                for (int g = 0; g < GD; ++g) Ic[g] = kInf;
            }
            int32_t* Dc = D_cur + (size_t)d * GD;
            if (d > 0) {
                const size_t xd = (size_t)(y + d - 1) * GD;
                const int32_t* opn_d = opnT + xd;
                const int32_t* ext_d = extT + xd;
                const int32_t* Mdm1 = M_cur + (size_t)(d - 1) * GD;
                const int32_t* Idm1 = I_cur + (size_t)(d - 1) * GD;
                const int32_t* Ddm1 = D_cur + (size_t)(d - 1) * GD;
                for (int g = 0; g < GD; ++g) {
                    int32_t bd = Mdm1[g] + opn_d[g];
                    const int32_t c1 = Idm1[g] + opn_d[g];
                    const int32_t c2 = Ddm1[g] + ext_d[g];
                    if (c1 < bd) bd = c1;
                    if (c2 < bd) bd = c2;
                    Dc[g] = bd;
                }
            } else {
                for (int g = 0; g < GD; ++g) Dc[g] = kInf;
            }
        }
        std::swap(M_prev, M_cur);
        std::swap(I_prev, I_cur);
        std::swap(D_prev, D_cur);
    }
    for (int g = 0; g < GD; ++g) out_scores[g] = kInf;
    for (int d = 0; d < Dn; ++d) {
        for (int g = 0; g < GD; ++g) {
            const int32_t m = M_prev[d * GD + g];
            const int32_t i = I_prev[d * GD + g];
            const int32_t dd = D_prev[d * GD + g];
            int32_t s = m;
            if (i < s) s = i;
            if (dd < s) s = dd;
            if (s < out_scores[g]) out_scores[g] = s;
        }
    }
}

// flank_banded_scores(n, L, W, pad, nuc_prior,
//                     tgt, quals,            # (n, L) int32
//                     win, opn, ext, mask, prior,   # (n, W) int32
//                     lens, lhs_w, rhs_w)    # (n,) int32
// -> bytes of n int32 flank-corrected scores
static PyObject* flank_banded_scores(PyObject*, PyObject* args) {
    int n, L, W, pad, nuc_prior;
    Py_buffer tgt_b, qual_b, win_b, opn_b, ext_b, mask_b, prior_b;
    Py_buffer len_b, lhs_b, rhs_b;
    if (!PyArg_ParseTuple(args, "iiiiiy*y*y*y*y*y*y*y*y*y*",
                          &n, &L, &W, &pad, &nuc_prior,
                          &tgt_b, &qual_b, &win_b, &opn_b, &ext_b, &mask_b,
                          &prior_b, &len_b, &lhs_b, &rhs_b))
        return nullptr;
    PyObject* result = PyBytes_FromStringAndSize(nullptr, (Py_ssize_t)n * 4);
    if (!result) return nullptr;
    int32_t* out = (int32_t*)PyBytes_AS_STRING(result);
    const int32_t* tgt_a = (const int32_t*)tgt_b.buf;
    const int32_t* qual_a = (const int32_t*)qual_b.buf;
    const int32_t* win_a = (const int32_t*)win_b.buf;
    const int32_t* opn_a = (const int32_t*)opn_b.buf;
    const int32_t* ext_a = (const int32_t*)ext_b.buf;
    const int32_t* mask_a = (const int32_t*)mask_b.buf;
    const int32_t* prior_a = (const int32_t*)prior_b.buf;
    const int32_t* lens = (const int32_t*)len_b.buf;
    const int32_t* lhs_a = (const int32_t*)lhs_b.buf;
    const int32_t* rhs_a = (const int32_t*)rhs_b.buf;
    const int Dn = 2 * pad;

    Py_BEGIN_ALLOW_THREADS
    // rows needing no flank discount take the lane-batched score-only DP,
    // grouped by read length; flank rows keep the scalar traceback path
    std::vector<uint8_t> done((size_t)n, 0);
    {
        std::map<int, std::vector<int>> by_len;
        for (int i = 0; i < n; ++i)
            if (lhs_a[i] == 0 && rhs_a[i] == 0) by_len[lens[i]].push_back(i);
        const int G = kLanes;
        std::vector<int32_t> tgtT((size_t)L * G), qualT((size_t)L * G),
            winT((size_t)W * G), opnT((size_t)W * G), extT((size_t)W * G),
            mskT((size_t)W * G), priT((size_t)W * G);
        std::vector<int32_t> Mp((size_t)Dn * G), Ip((size_t)Dn * G),
            Dp((size_t)Dn * G), Mc((size_t)Dn * G), Ic((size_t)Dn * G),
            Dc((size_t)Dn * G), scores(G);
        for (auto& kv : by_len) {
            const int R = kv.first;
            if (R <= 0) continue;
            const int Wr = R + 2 * pad - 1;
            const std::vector<int>& rows = kv.second;
            for (size_t lo = 0; lo < rows.size(); lo += G) {
                const int valid = (int)std::min((size_t)G, rows.size() - lo);
                int lane_row[kLanes];
                for (int g = 0; g < G; ++g)
                    lane_row[g] = rows[lo + (g < valid ? g : 0)];
                for (int x = 0; x < Wr; ++x) {
                    for (int g = 0; g < G; ++g) {
                        const size_t src = (size_t)lane_row[g] * W + x;
                        const size_t dst = (size_t)x * G + g;
                        winT[dst] = win_a[src];
                        opnT[dst] = opn_a[src];
                        extT[dst] = ext_a[src];
                        mskT[dst] = mask_a[src];
                        priT[dst] = prior_a[src];
                    }
                }
                for (int y = 0; y < R; ++y) {
                    for (int g = 0; g < G; ++g) {
                        const size_t src = (size_t)lane_row[g] * L + y;
                        const size_t dst = (size_t)y * G + g;
                        tgtT[dst] = tgt_a[src];
                        qualT[dst] = qual_a[src];
                    }
                }
                banded_scores_group(G, R, Dn, nuc_prior,
                                    tgtT.data(), qualT.data(), winT.data(),
                                    opnT.data(), extT.data(), mskT.data(),
                                    priT.data(), Mp.data(), Ip.data(),
                                    Dp.data(), Mc.data(), Ic.data(),
                                    Dc.data(), scores.data());
                for (int g = 0; g < valid; ++g) {
                    out[rows[lo + g]] = scores[g];
                    done[rows[lo + g]] = 1;
                }
            }
        }
    }
    FlankDP dp;
    dp.ops.reserve((size_t)L + Dn);
    for (int i = 0; i < n; ++i) {
        if (done[i]) continue;
        const int R = lens[i];
        const int Wr = R + 2 * pad - 1;   // this row's real window width
        const int32_t* tgt = tgt_a + (size_t)i * L;
        const int32_t* qual = qual_a + (size_t)i * L;
        const int32_t* win = win_a + (size_t)i * W;
        const int32_t* opn = opn_a + (size_t)i * W;
        const int32_t* ext = ext_a + (size_t)i * W;
        const int32_t* msk = mask_a + (size_t)i * W;
        const int32_t* pri = prior_a + (size_t)i * W;
        dp.resize(R + 1, Dn);
        auto at = [Dn](std::vector<int32_t>& v, int y, int d) -> int32_t& {
            return v[(size_t)y * Dn + d];
        };
        auto bt = [Dn](std::vector<int8_t>& v, int y, int d) -> int8_t& {
            return v[(size_t)y * Dn + d];
        };
        // row 0: M free start anywhere; gap ops may start only from ODD
        // diagonals (half-step parity quirk, pairhmm_ref.banded_score)
        for (int d = 0; d < Dn; ++d) { at(dp.M, 0, d) = 0; bt(dp.Mb, 0, d) = 3; }
        auto m0_gap = [](int d) -> int32_t { return (d % 2 == 1) ? 0 : kInf; };
        for (int d = 1; d < Dn; ++d) {
            int32_t via_open = m0_gap(d - 1) + opn[d - 1];
            int32_t via_ext = at(dp.D, 0, d - 1) + ext[d - 1];
            if (via_open <= via_ext) { at(dp.D, 0, d) = via_open; bt(dp.Db, 0, d) = 0; }
            else { at(dp.D, 0, d) = via_ext; bt(dp.Db, 0, d) = 2; }
        }
        for (int y = 1; y <= R; ++y) {
            for (int d = 0; d < Dn; ++d) {
                const int x_im1 = y - 1 + d;
                // match: best of (M, I, D) at (y-1, d); ties prefer M<I<D
                int32_t c0 = at(dp.M, y - 1, d), c1 = at(dp.I, y - 1, d),
                        c2 = at(dp.D, y - 1, d);
                int k = 0; int32_t best = c0;
                if (c1 < best) { best = c1; k = 1; }
                if (c2 < best) { best = c2; k = 2; }
                at(dp.M, y, d) = match_cost(tgt[y - 1], win[x_im1],
                                            qual[y - 1], msk[x_im1],
                                            pri[x_im1]) + best;
                bt(dp.Mb, y, d) = (int8_t)k;
                // insertion from previous row, diagonal d+1
                if (d + 1 < Dn) {
                    int32_t m_prev = (y == 1) ? m0_gap(d + 1)
                                              : at(dp.M, y - 1, d + 1);
                    int32_t via_open = m_prev + opn[x_im1];
                    int32_t via_ext = at(dp.I, y - 1, d + 1) + ext[x_im1];
                    if (via_open <= via_ext) {
                        at(dp.I, y, d) = nuc_prior + via_open; bt(dp.Ib, y, d) = 0;
                    } else {
                        at(dp.I, y, d) = nuc_prior + via_ext; bt(dp.Ib, y, d) = 1;
                    }
                }
                // deletion: uses this row's M/I at d-1
                if (d > 0) {
                    const int x_del = y + d - 1;
                    int32_t cd0 = at(dp.M, y, d - 1) + opn[x_del];
                    int32_t cd1 = at(dp.I, y, d - 1) + opn[x_del];
                    int32_t cd2 = at(dp.D, y, d - 1) + ext[x_del];
                    int kd = 0; int32_t bd = cd0;
                    if (cd1 < bd) { bd = cd1; kd = 1; }
                    if (cd2 < bd) { bd = cd2; kd = 2; }
                    at(dp.D, y, d) = bd; bt(dp.Db, y, d) = (int8_t)kd;
                }
            }
        }
        // final: min over states/diagonals at y=R, ties prefer M<I<D then low d
        int state = 0, d = 0; int32_t score = kInf;
        for (int s = 0; s < 3; ++s) {
            std::vector<int32_t>& v = (s == 0) ? dp.M : (s == 1) ? dp.I : dp.D;
            for (int dd = 0; dd < Dn; ++dd) {
                if (at(v, R, dd) < score) { score = at(v, R, dd); state = s; d = dd; }
            }
        }
        // traceback
        dp.ops.clear();
        int y = R;
        while (!(y == 0 && state == 0)) {
            if (state == 0) { state = bt(dp.Mb, y, d); dp.ops.push_back('M'); --y; }
            else if (state == 1) { state = bt(dp.Ib, y, d); dp.ops.push_back('I'); --y; ++d; }
            else { state = bt(dp.Db, y, d); dp.ops.push_back('D'); --d; }
        }
        // flank walk (simd_pair_hmm.hpp:352-430; pairhmm_ref.flank_score_of_path)
        const int lhs = lhs_a[i];
        const int rhs_begin = Wr - rhs_a[i];
        int truth_idx = d, target_idx = 0, fscore = 0, mask_size = 0;
        char prev = 'M';
        for (auto it = dp.ops.rbegin(); it != dp.ops.rend(); ++it) {
            const char op = *it;
            const bool in_flank = truth_idx < lhs || truth_idx >= rhs_begin;
            if (op == 'M') {
                if (in_flank) {
                    if (tgt[target_idx] != win[truth_idx]) {
                        // truth N adds exactly the N score in the walk
                        // (simd_pair_hmm.hpp:388-393)
                        if (win[truth_idx] == kNCode) {
                            fscore += kNScore;
                        } else {
                            int32_t q = qual[target_idx];
                            if (msk[truth_idx] == tgt[target_idx])
                                q = std::min(q, pri[truth_idx]);
                            fscore += q;
                        }
                    }
                    ++mask_size;
                }
                ++truth_idx; ++target_idx;
            } else if (op == 'I') {
                if (in_flank) {
                    fscore += ((prev == 'I') ? ext[truth_idx - 1]
                                             : opn[truth_idx - 1]) + nuc_prior;
                    ++mask_size;
                }
                ++target_idx;
            } else {
                if (in_flank) {
                    fscore += (prev == 'D') ? ext[truth_idx] : opn[truth_idx];
                }
                ++truth_idx;
            }
            prev = op;
        }
        if (R - mask_size < 2) fscore = 0;
        out[i] = score - fscore;
    }
    Py_END_ALLOW_THREADS

    PyBuffer_Release(&tgt_b); PyBuffer_Release(&qual_b);
    PyBuffer_Release(&win_b); PyBuffer_Release(&opn_b);
    PyBuffer_Release(&ext_b); PyBuffer_Release(&mask_b);
    PyBuffer_Release(&prior_b); PyBuffer_Release(&len_b);
    PyBuffer_Release(&lhs_b); PyBuffer_Release(&rhs_b);
    return result;
}


// ---------------------------------------------------------------------------
// Per-site read support/mismatch statistics for the CSR measures
// (mirrors octopus_tpu/core/csr/measures.py _read_supports /
// _read_mismatches bit-for-bit).  Cigar ops: 0=M 1=I 2=D 3=N 4=S 5=H 6=P
// 7=EQ 8=X.
// ---------------------------------------------------------------------------

static bool rotations_equal(const uint8_t* a, const uint8_t* b, int64_t n) {
    if (n == 0) return true;
    for (int64_t s = 0; s < n; ++s) {
        bool ok = true;
        for (int64_t i = 0; i < n; ++i) {
            if (a[i] != b[(i + s) % n]) { ok = false; break; }
        }
        if (ok) return true;
    }
    return false;
}

static PyObject* site_read_stats(PyObject*, PyObject* args) {
    Py_buffer beg_b, seq_b, qual_b, soff_b, cig_b, coff_b, ref_b, alt_b;
    long long begin, end, ref_begin;
    int is_ins, is_del, shift_max, have_ref;
    if (!PyArg_ParseTuple(args, "y*y*y*y*y*y*y*Ly*LLiii",
                          &beg_b, &seq_b, &qual_b, &soff_b, &cig_b, &coff_b,
                          &ref_b, &ref_begin, &alt_b, &begin, &end,
                          &is_ins, &is_del, &shift_max))
        return nullptr;
    have_ref = ref_b.len > 0;
    const int64_t* begins = (const int64_t*)beg_b.buf;
    const uint8_t* seq = (const uint8_t*)seq_b.buf;
    const uint8_t* quals = (const uint8_t*)qual_b.buf;
    const int64_t* soff = (const int64_t*)soff_b.buf;
    const int32_t* cig = (const int32_t*)cig_b.buf;
    const int64_t* coff = (const int64_t*)coff_b.buf;
    const uint8_t* ref = (const uint8_t*)ref_b.buf;
    const Py_ssize_t ref_n = ref_b.len;
    const uint8_t* alt = (const uint8_t*)alt_b.buf;
    const int64_t alt_n = alt_b.len;
    const Py_ssize_t n = beg_b.len / (Py_ssize_t)sizeof(int64_t);

    // outputs: sup(i8), bq(i16, -1 none), off(i32, -1 none), mism(i32),
    // clipped(i8)
    PyObject* sup_o = PyBytes_FromStringAndSize(nullptr, n);
    PyObject* bq_o = PyBytes_FromStringAndSize(nullptr, n * 2);
    PyObject* off_o = PyBytes_FromStringAndSize(nullptr, n * 4);
    PyObject* mism_o = PyBytes_FromStringAndSize(nullptr, n * 4);
    PyObject* clip_o = PyBytes_FromStringAndSize(nullptr, n);
    if (!sup_o || !bq_o || !off_o || !mism_o || !clip_o) return nullptr;
    int8_t* sup = (int8_t*)PyBytes_AS_STRING(sup_o);
    int16_t* bq = (int16_t*)PyBytes_AS_STRING(bq_o);
    int32_t* off_out = (int32_t*)PyBytes_AS_STRING(off_o);
    int32_t* mism_out = (int32_t*)PyBytes_AS_STRING(mism_o);
    int8_t* clip = (int8_t*)PyBytes_AS_STRING(clip_o);

    Py_BEGIN_ALLOW_THREADS
    for (Py_ssize_t r = 0; r < n; ++r) {
        const uint8_t* rs = seq + soff[r];
        const uint8_t* rq = quals + soff[r];
        int64_t pos = begins[r];
        int64_t q = 0;
        int s_res = 0;
        int16_t bq_res = -1;
        int32_t off_res = -1;
        bool decided = false;
        int32_t mism = 0;
        int8_t clipped = 0;
        for (int64_t c = coff[r]; c < coff[r + 1]; ++c) {
            const int32_t length = cig[2 * c];
            const int32_t op = cig[2 * c + 1];
            switch (op) {
            case 0: case 7: case 8: {          // M, EQ, X
                if (have_ref) {                // mismatch count vs reference
                    const int64_t lo = pos - ref_begin;
                    const int64_t r0 = lo > 0 ? lo : 0;
                    const int64_t r1 = (lo + length) < ref_n ? (lo + length)
                                                             : ref_n;
                    const int64_t skip = lo < 0 ? -lo : 0;
                    const int64_t cnt = r1 - r0;
                    for (int64_t i = 0; i < cnt; ++i) {
                        if (ref[r0 + i] != rs[q + skip + i]) ++mism;
                    }
                }
                if (!decided && !is_ins && !is_del && pos <= begin
                        && begin + alt_n <= pos + length) {
                    const int64_t o = q + (begin - pos);
                    bool eq = true;
                    for (int64_t i = 0; i < alt_n; ++i) {
                        if (rs[o + i] != alt[i]) { eq = false; break; }
                    }
                    if (eq) {
                        s_res = 1;
                        int16_t mn = 32767;
                        for (int64_t i = 0; i < alt_n; ++i) {
                            if (rq[o + i] < mn) mn = (int16_t)rq[o + i];
                        }
                        bq_res = alt_n ? mn : -1;
                        off_res = (int32_t)o;
                    }
                    decided = true;            // SNV path decides either way
                }
                pos += length;
                q += length;
                break;
            }
            case 1:                            // I
                mism += length;
                if (!decided && is_ins && begin <= pos
                        && pos <= begin + shift_max && length == alt_n) {
                    if (rotations_equal(rs + q, alt, length)) {
                        s_res = 1;
                        int16_t mn = 32767;
                        for (int64_t i = 0; i < length; ++i) {
                            if (rq[q + i] < mn) mn = (int16_t)rq[q + i];
                        }
                        bq_res = length ? mn : -1;
                        off_res = (int32_t)q;
                        decided = true;
                    }
                }
                q += length;
                break;
            case 2:                            // D
                mism += length;
                if (!decided && is_del && begin <= pos
                        && pos <= begin + shift_max && length == end - begin) {
                    s_res = 1;
                    bq_res = -1;
                    off_res = (int32_t)q;
                    decided = true;
                }
                pos += length;
                break;
            case 4:                            // S
                clipped = 1;
                q += length;
                break;
            case 5:                            // H (not counted as clip:
                break;                     // measures.py counts S only)
            case 3: case 6:                    // N, P (measures.py parity)
                pos += length;
                break;
            default:
                break;
            }
        }
        sup[r] = (int8_t)s_res;
        bq[r] = bq_res;
        off_out[r] = off_res;
        mism_out[r] = have_ref ? mism : 0;
        clip[r] = clipped;
    }
    Py_END_ALLOW_THREADS

    PyBuffer_Release(&beg_b); PyBuffer_Release(&seq_b);
    PyBuffer_Release(&qual_b); PyBuffer_Release(&soff_b);
    PyBuffer_Release(&cig_b); PyBuffer_Release(&coff_b);
    PyBuffer_Release(&ref_b); PyBuffer_Release(&alt_b);
    PyObject* tup = PyTuple_Pack(5, sup_o, bq_o, off_o, mism_o, clip_o);
    Py_DECREF(sup_o); Py_DECREF(bq_o); Py_DECREF(off_o);
    Py_DECREF(mism_o); Py_DECREF(clip_o);
    return tup;
}

// The (haplotype, read, anchor) jobs of a populate, as the reference's
// k-mer mapper and _populate_sample give them, element for element
// (tests/test_torch_anchor_jobs.py).
//
// Groups: reads [read_base[g], read_base[g+1]) against haplotypes
// [hap_base[g], hap_base[g+1]). For each haplotype of a group, in order:
// a CSR table of its K-mer positions (hashes with N folded to A, ascending
// positions within a hash); each needed read's K-mers vote for begin =
// position - k-mer index (begin >= 0), counted in one vote row over the
// haplotype's begins that every read reuses and clears through its list of
// touched begins; the begins with the most votes, ascending, at most
// max_anchors, are its anchors, and its original offset joins them when
// they lack it. A job is kept when pad <= begin and begin + length <=
// hap_len; a needed read left without one is shifted into range (pos =
// max(original, pad), moved left by its overrun of the haplotype's end).
// Emitted a haplotype at a time: the kept anchors by read, begins
// ascending; then the kept original offsets; then the shifted reads.
struct AnchorJobs {
    std::vector<int64_t> hap, read, pos;
    void push(int64_t h, int64_t r, int64_t p) {
        hap.push_back(h); read.push_back(r); pos.push_back(p);
    }
};

// Returns false, with the (haplotype, read) at fault, when a needed read
// fits no in-range position.
static bool gather_anchor_jobs_impl(
        const uint8_t* read_codes, const int64_t* read_offsets,
        const int64_t* original, int64_t n_reads,
        const uint8_t* hap_codes, const int64_t* hap_offsets,
        const int64_t* read_base, const int64_t* hap_base, int64_t n_groups,
        const uint8_t* need, int64_t pad, int K, int max_anchors,
        AnchorJobs& out, int64_t& fault_hap, int64_t& fault_read) {
    const uint32_t n_buckets = 1u << (2 * K);
    const uint32_t top_shift = 2 * (K - 1);
    auto fold = [](uint8_t c) -> uint32_t { return c >= 4 ? 0u : c; };
    // every read's rolling K-mer hashes, flat
    std::vector<int64_t> hash_off((size_t)n_reads + 1, 0);
    for (int64_t r = 0; r < n_reads; ++r) {
        const int64_t len = read_offsets[r + 1] - read_offsets[r];
        hash_off[r + 1] = hash_off[r] + (len >= K ? len - K + 1 : 0);
    }
    std::vector<uint32_t> hashes((size_t)hash_off[n_reads]);
    for (int64_t r = 0; r < n_reads; ++r) {
        const uint8_t* s = read_codes + read_offsets[r];
        const int64_t nk = hash_off[r + 1] - hash_off[r];
        if (nk == 0) continue;
        uint32_t h = 0;
        for (int k = 0; k < K; ++k) h |= fold(s[k]) << (2 * k);
        uint32_t* dst = hashes.data() + hash_off[r];
        dst[0] = h;
        for (int64_t j = 1; j < nk; ++j) {
            h = (h >> 2) | (fold(s[j + K - 1]) << top_shift);
            dst[j] = h;
        }
    }
    std::vector<int32_t> table_start(n_buckets + 1), table_fill(n_buckets);
    std::vector<int32_t> table_pos, votes, touched, best;
    std::vector<uint32_t> hap_hash;
    AnchorJobs anchors, originals, shifted;
    for (int64_t g = 0; g < n_groups; ++g) {
        const int64_t r0 = read_base[g], r1 = read_base[g + 1];
        for (int64_t h = hap_base[g]; h < hap_base[g + 1]; ++h) {
            const uint8_t* need_h = need ? need + h * n_reads : nullptr;
            bool any = need_h == nullptr;
            for (int64_t r = r0; r < r1 && !any; ++r) any = need_h[r] != 0;
            if (!any) continue;
            const uint8_t* codes = hap_codes + hap_offsets[h];
            const int64_t hap_len = hap_offsets[h + 1] - hap_offsets[h];
            const int64_t n_kmers = hap_len >= K ? hap_len - K + 1 : 0;
            // the haplotype's K-mer table (counting sort: stable)
            std::fill(table_start.begin(), table_start.end(), 0);
            table_pos.resize((size_t)n_kmers);
            hap_hash.resize((size_t)n_kmers);
            if (n_kmers > 0) {
                uint32_t hh = 0;
                for (int k = 0; k < K; ++k) hh |= fold(codes[k]) << (2 * k);
                hap_hash[0] = hh;
                for (int64_t p = 1; p < n_kmers; ++p) {
                    hh = (hh >> 2) | (fold(codes[p + K - 1]) << top_shift);
                    hap_hash[p] = hh;
                }
            }
            for (int64_t p = 0; p < n_kmers; ++p) ++table_start[hap_hash[p] + 1];
            for (uint32_t b = 0; b < n_buckets; ++b)
                table_start[b + 1] += table_start[b];
            std::copy(table_start.begin(), table_start.end() - 1,
                      table_fill.begin());
            for (int64_t p = 0; p < n_kmers; ++p)
                table_pos[table_fill[hap_hash[p]]++] = (int32_t)p;
            votes.assign((size_t)n_kmers, 0);
            anchors.hap.clear(); anchors.read.clear(); anchors.pos.clear();
            originals.hap.clear(); originals.read.clear(); originals.pos.clear();
            shifted.hap.clear(); shifted.read.clear(); shifted.pos.clear();
            for (int64_t r = r0; r < r1; ++r) {
                if (need_h && !need_h[r]) continue;
                const int64_t len = read_offsets[r + 1] - read_offsets[r];
                const int64_t orig = original[r];
                touched.clear();
                if (n_kmers > 0) {
                    const uint32_t* q = hashes.data() + hash_off[r];
                    const int64_t nk = hash_off[r + 1] - hash_off[r];
                    for (int64_t j = 0; j < nk; ++j) {
                        for (int32_t t = table_start[q[j]];
                             t < table_start[q[j] + 1]; ++t) {
                            const int64_t b = table_pos[t] - j;
                            if (b < 0) continue;
                            if (votes[b]++ == 0) touched.push_back((int32_t)b);
                        }
                    }
                }
                int32_t most = 0;
                for (int32_t b : touched) most = std::max(most, votes[b]);
                best.clear();
                for (int32_t b : touched) {
                    if (votes[b] == most) best.push_back(b);
                    votes[b] = 0;
                }
                std::sort(best.begin(), best.end());
                if ((int)best.size() > max_anchors) best.resize(max_anchors);
                bool has_orig = false, in_range = false;
                for (int32_t b : best) {
                    has_orig |= b == orig;
                    if (b >= pad && b + len <= hap_len) {
                        anchors.push(h, r, b);
                        in_range = true;
                    }
                }
                if (!has_orig && orig >= pad && orig + len <= hap_len) {
                    originals.push(h, r, orig);
                    in_range = true;
                }
                if (in_range) continue;
                int64_t p = std::max(orig, pad);
                const int64_t over = p + len - hap_len;
                if (over > 0) p -= over;
                if (p < pad || p + len > hap_len) {
                    fault_hap = h;
                    fault_read = r;
                    return false;
                }
                shifted.push(h, r, p);
            }
            for (const AnchorJobs* part : {&anchors, &originals, &shifted}) {
                out.hap.insert(out.hap.end(), part->hap.begin(), part->hap.end());
                out.read.insert(out.read.end(), part->read.begin(), part->read.end());
                out.pos.insert(out.pos.end(), part->pos.begin(), part->pos.end());
            }
        }
    }
    return true;
}

static PyObject* int64_bytearray(const std::vector<int64_t>& v) {
    return PyByteArray_FromStringAndSize(
        reinterpret_cast<const char*>(v.data()),
        (Py_ssize_t)(v.size() * sizeof(int64_t)));
}

// gather_anchor_jobs(read_codes: u8, read_offsets: i64 (n_reads+1),
//                    original: i64 (n_reads), hap_codes: u8,
//                    hap_offsets: i64 (n_haps+1), read_base: i64
//                    (n_groups+1), hap_base: i64 (n_groups+1),
//                    need: u8 (n_haps, n_reads) or empty for all needed,
//                    pad, K, max_anchors)
//   -> (job_hap, job_read, job_pos int64-le bytearrays, None), or
//      (None, None, None, (hap, read)) at the first needed read that no
//      in-range position fits
static PyObject* gather_anchor_jobs(PyObject*, PyObject* args) {
    Py_buffer rc_b, ro_b, or_b, hc_b, ho_b, rb_b, hb_b, need_b;
    long long pad;
    int K, max_anchors;
    if (!PyArg_ParseTuple(args, "y*y*y*y*y*y*y*y*Lii", &rc_b, &ro_b, &or_b,
                          &hc_b, &ho_b, &rb_b, &hb_b, &need_b, &pad, &K,
                          &max_anchors))
        return nullptr;
    auto release = [&]() {
        for (Py_buffer* b : {&rc_b, &ro_b, &or_b, &hc_b, &ho_b, &rb_b, &hb_b,
                             &need_b})
            PyBuffer_Release(b);
    };
    const int64_t n_reads = or_b.len / 8;
    const int64_t n_haps = ho_b.len / 8 - 1;
    const int64_t n_groups = rb_b.len / 8 - 1;
    const int64_t* read_offsets = (const int64_t*)ro_b.buf;
    const int64_t* hap_offsets = (const int64_t*)ho_b.buf;
    const int64_t* read_base = (const int64_t*)rb_b.buf;
    const int64_t* hap_base = (const int64_t*)hb_b.buf;
    const char* bad = nullptr;
    if (K < 1 || K > 8 || max_anchors < 0)
        bad = "K must lie in 1..8 and max_anchors be >= 0";
    else if (ro_b.len != (n_reads + 1) * 8 || n_haps < 0 || n_groups < 0
             || hb_b.len != rb_b.len)
        bad = "offset and group arrays disagree in length";
    else if (read_offsets[n_reads] > rc_b.len
             || hap_offsets[n_haps] > hc_b.len)
        bad = "offsets run past the codes";
    else if (need_b.len != 0 && need_b.len != n_haps * n_reads)
        bad = "need must be empty or (n_haps, n_reads)";
    else if (n_groups > 0 && (read_base[0] < 0 || hap_base[0] < 0
             || read_base[n_groups] > n_reads || hap_base[n_groups] > n_haps))
        bad = "groups run past the reads or haplotypes";
    if (bad) {
        release();
        PyErr_SetString(PyExc_ValueError, bad);
        return nullptr;
    }
    AnchorJobs jobs;
    int64_t fault_hap = -1, fault_read = -1;
    bool ok;
    Py_BEGIN_ALLOW_THREADS
    ok = gather_anchor_jobs_impl(
        (const uint8_t*)rc_b.buf, read_offsets, (const int64_t*)or_b.buf,
        n_reads, (const uint8_t*)hc_b.buf, hap_offsets, read_base, hap_base,
        n_groups, need_b.len ? (const uint8_t*)need_b.buf : nullptr,
        (int64_t)pad, K, max_anchors, jobs, fault_hap, fault_read);
    Py_END_ALLOW_THREADS
    release();
    if (!ok)
        return Py_BuildValue("(OOO(LL))", Py_None, Py_None, Py_None,
                             (long long)fault_hap, (long long)fault_read);
    PyObject* h = int64_bytearray(jobs.hap);
    PyObject* r = int64_bytearray(jobs.read);
    PyObject* p = int64_bytearray(jobs.pos);
    PyObject* tup = (h && r && p) ? PyTuple_Pack(4, h, r, p, Py_None) : nullptr;
    Py_XDECREF(h); Py_XDECREF(r); Py_XDECREF(p);
    return tup;
}

static PyMethodDef methods[] = {
    {"gather_anchor_jobs", gather_anchor_jobs, METH_VARARGS,
     "A populate's (haplotype, read, anchor) jobs -> int64-le bytearrays."},
    {"site_read_stats", site_read_stats, METH_VARARGS,
     "Per-read site support/bq/offset/mismatch/clip stats for measures."},
    {"flank_banded_scores", flank_banded_scores, METH_VARARGS,
     "Batched banded align + flank-score discount -> int32-le scores."},
    {"decode_bam_records", decode_bam_records, METH_VARARGS,
     "Full BAM record decode for one region -> tuple of flat field buffers."},
    {"banded_traceback", banded_traceback, METH_VARARGS,
     "Banded Viterbi with traceback -> (score, first_pos, ops bytes)."},
    {"global_align", global_align_native, METH_VARARGS,
     "Affine-gap global alignment -> int32-le (length, op) pairs."},
    {"generate_candidates", generate_candidates, METH_VARARGS,
     "A window's candidate variants, CIGAR scan and reassembly -> packed records."},
    {"tandem_repeats", tandem_repeats, METH_VARARGS,
     "Maximal exact tandem repeats -> int32-le (pos, length, period) triples."},
    {"snv_priors", snv_priors, METH_VARARGS,
     "Repeat-context SNV penalty caps -> (fwd, rev) int16-le bytes."},
    {"indel_penalties", indel_penalties, METH_VARARGS,
     "Repeat-context indel gap penalties -> (open, extend) int16-le bytes."},
    {"inflate_bgzf", inflate_bgzf, METH_VARARGS,
     "Inflate concatenated BGZF blocks -> (data, block_coffsets_u64, block_uoffsets_u64)."},
    {"scan_bam_records", scan_bam_records, METH_VARARGS,
     "Scan BAM record boundaries -> uint64-le offsets bytes."},
    {"rans_uncompress", rans_uncompress, METH_VARARGS,
     "Decode a CRAM rANS-4x8 stream (order 0 or 1) -> bytes."},
    {nullptr, nullptr, 0, nullptr},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_native", "octopus_tpu native host kernels",
    -1, methods, nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__native(void) {
    return PyModule_Create(&moduledef);
}
