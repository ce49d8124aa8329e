// Native host helpers of nanocall_tpu_torch (a copy of
// nanocall_tpu/native/preprocess.cpp): the sequential per-read scalar scans
// that sit outside the device compute path.
//
// Covers the reference's host-side hot loops (Fast5_Summary.hpp):
//   - abasic level quantile               (detect_abasic_level, :528-543)
//   - island detection                    (:545-571)
//   - event filtering                     (filter_ed_event, :734-745)
//   - base-sequence assembly from a decoded state path (Event.hpp:85-99,
//     Viterbi.hpp:144-150 move computation)
//
// Exposed as a plain C ABI for ctypes; nanocall_tpu_torch/native/__init__.py
// builds it with g++ at first use and falls back to numpy without it.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Sorted-quantile abasic level: value at index n*(1 - top_percent/100),
// clamped to the last element, plus offset.  The quantile value and the
// sum are rounded through float32: the reference copies event means into a
// vector<Float_Type> (f32) before sorting and stores the result in a
// Float_Type field (Fast5_Summary.hpp:528-543), and the downstream
// >=-threshold comparisons (filter_ed_event, island detection) happen
// against that f32 value — with abasic_level_top_offset 0 (the r9 preset)
// the threshold lands exactly ON an event, so whether f32 rounding went up
// or down decides if the quantile event itself survives the filter.
double nc_abasic_level(const double* means, int64_t n, double top_percent,
                       double top_offset) {
    std::vector<float> s(means, means + n);
    int64_t idx = (int64_t)((double)n * (1.0 - top_percent / 100.0));
    if (idx > n - 1) idx = n - 1;
    if (idx < 0) idx = 0;
    std::nth_element(s.begin(), s.begin() + idx, s.end());
    return (double)(float)(s[idx] + (float)top_offset);
}

// Sequential float32 moment accumulation (alg::mean_stdv_of<Float_Type>,
// shim alg.hpp / hpptools): s += v; s2 += v*v in f32 event order, then
// mean = s/n, stdv = sqrtf(s2/n - mean^2).  The reference derives initial
// scale/shift from these f32 moments (Fast5_Summary.hpp:223-278), and the
// f32-vs-f64 accumulation gap is enough to flip a near-tie Viterbi base —
// so exact FASTA parity on untrained runs requires bit-equal moments.
void nc_mean_stdv_f32(const double* vals, int64_t n, double* out) {
    float s = 0.0f, s2 = 0.0f;
    for (int64_t i = 0; i < n; ++i) {
        float v = (float)vals[i];
        s += v;
        s2 += v * v;
    }
    if (n == 0) { out[0] = 0.0; out[1] = 0.0; return; }
    float mean = s / n;
    float var = s2 / n - mean * mean;
    out[0] = (double)mean;
    out[1] = (double)(var > 0.0f ? sqrtf(var) : 0.0f);
}

// Islands of >= 5 consecutive events with mean >= level.  Writes up to
// max_islands (start, end) pairs into out; returns the island count.
int64_t nc_find_islands_5(const double* means, int64_t n, double level,
                          int64_t* out, int64_t max_islands) {
    int64_t count = 0;
    int64_t i = 0;
    while (i < n) {
        if (means[i] >= level) {
            int64_t j = i + 1;
            while (j < n && means[j] >= level) ++j;
            if (j - i >= 5 && count < max_islands) {
                out[2 * count] = i;
                out[2 * count + 1] = j;
                ++count;
            }
            i = j + 1;
        } else {
            ++i;
        }
    }
    return count;
}

// Event filter (mean < abasic_level && stdv <= 4.0); writes a 0/1 mask.
void nc_filter_events(const double* mean, const double* stdv, int64_t n,
                      double abasic_level, uint8_t* keep) {
    for (int64_t i = 0; i < n; ++i)
        keep[i] = (mean[i] < abasic_level) && (stdv[i] <= 4.0);
}

// min_skip over consecutive path states (Kmer.hpp:51-68): moves[0] = 0,
// moves[i] = min d with suffix(path[i-1], K-d) == prefix(path[i], K-d).
void nc_moves(const int32_t* path, int64_t n, int32_t K, int32_t* moves) {
    if (n == 0) return;
    moves[0] = 0;
    for (int64_t i = 1; i < n; ++i) {
        uint32_t k1 = (uint32_t)path[i - 1], k2 = (uint32_t)path[i];
        int32_t res = K;
        if (k1 == k2) {
            res = 0;
        } else {
            for (int32_t k = K - 1; k > 0; --k) {
                if ((k1 & ((1u << (2 * k)) - 1)) == (k2 >> (2 * (K - k)))) {
                    res = K - k;
                    break;
                }
            }
        }
        moves[i] = res;
    }
}

// Reconstruct a full state path from unpacked compact traceback codes:
// path[0] = s0, codes[t-1] = (move << 4) | (state_t & 15), move 0 = stay,
// 1 = step (shift in 1 base), 2 = skip (shift in 2 bases).  n = path
// length (= len(codes) + 1).
// The per-step update is branchless (shift/low-bit-mask lookup tables
// indexed by the move nibble): moves are data-random, so the branching
// form mispredicts ~half the steps and measured ~2x slower at 128x8192.
// 16 entries so ANY uint8 code indexes in bounds; nibbles other than
// 1 (step) and 2 (skip) decode as stay, like the old branching form.
static const uint32_t nc_move_shift[16] = {0, 2, 4, 0, 0, 0, 0, 0,
                                           0, 0, 0, 0, 0, 0, 0, 0};
static const uint32_t nc_move_lowmask[16] = {0, 0x3, 0xf, 0, 0, 0, 0, 0,
                                             0, 0, 0, 0, 0, 0, 0, 0};

void nc_path_from_codes(int32_t s0, const uint8_t* codes, int64_t n,
                        int32_t K, int32_t* path) {
    if (n == 0) return;
    uint32_t mask = (1u << (2 * K)) - 1;
    uint32_t s = (uint32_t)s0;
    path[0] = (int32_t)s;
    for (int64_t t = 1; t < n; ++t) {
        uint32_t c = codes[t - 1];
        uint32_t m = c >> 4;
        s = ((s << nc_move_shift[m]) | (c & nc_move_lowmask[m])) & mask;
        path[t] = (int32_t)s;
    }
}

// Reconstruct a full state path from the device's BIT-PACKED compact
// traceback codes (ops/hmm.py viterbi_traceback_grouped compact=True):
// four 6-bit codes per little-endian 24-bit group — code j = t-1 lives at
// bits [6*(j&3), 6*(j&3)+6) of packed[3*(j>>2) .. 3*(j>>2)+2].  n = path
// length; packed must hold at least 3*ceil((n-1)/4) bytes.
void nc_path_from_packed(int32_t s0, const uint8_t* packed, int64_t n,
                         int32_t K, int32_t* path) {
    if (n == 0) return;
    uint32_t mask = (1u << (2 * K)) - 1;
    uint32_t s = (uint32_t)s0;
    path[0] = (int32_t)s;
    // one 24-bit word load per FOUR codes, branchless updates: the naive
    // form (reload + variable shift + branch per code) measured ~1.5x
    // slower than the unpacked loop; this runs at parity with it.
    const uint8_t* p = packed;
    int64_t t = 1;
    while (t < n) {
        uint32_t w = (uint32_t)p[0] | ((uint32_t)p[1] << 8)
                     | ((uint32_t)p[2] << 16);
        p += 3;
        int64_t lim = t + 4 < n ? t + 4 : n;
        for (; t < lim; ++t) {
            uint32_t c = w & 0x3f;
            w >>= 6;
            uint32_t m = c >> 4;
            s = ((s << nc_move_shift[m]) | (c & nc_move_lowmask[m])) & mask;
            path[t] = (int32_t)s;
        }
    }
}

// Base-sequence assembly (Event.hpp:85-99): out must hold n*K+1 bytes;
// returns the sequence length.
int64_t nc_base_seq(const int32_t* path, const int32_t* moves, int64_t n,
                    int32_t K, char* out) {
    static const char bases[4] = {'A', 'C', 'G', 'T'};
    int64_t pos = 0;
    for (int64_t i = 0; i < n; ++i) {
        int32_t a = i == 0 ? K : std::min(moves[i], K);
        uint32_t s = (uint32_t)path[i];
        for (int32_t b = K - a; b < K; ++b)
            out[pos++] = bases[(s >> (2 * (K - 1 - b))) & 0x3];
    }
    out[pos] = '\0';
    return pos;
}

}  // extern "C"
