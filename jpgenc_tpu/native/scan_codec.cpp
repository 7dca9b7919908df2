// Native host tier: baseline-JPEG entropy scan decoder (SURVEY.md component
// #20, call stack 4.4 hot loop). The scan is inherently sequential (T.81
// F.2.2), so this is host C++ rather than a device kernel; it replaces the
// per-bit Python reader with a 64-bit buffered reader plus an 8-bit Huffman
// lookahead table (the classic libjpeg-style structure, re-derived from
// T.81 F.2.2.3 — no reference code consulted).
//
// Built as a plain shared library; Python binds via ctypes (no pybind11 in
// this environment).
//
// Error codes: 0 ok; <0 = malformed stream.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct HuffDecoder {
    // canonical decode per T.81 F.2.2.3
    int32_t mincode[17];
    int32_t maxcode[17];   // -1 when no codes of this length
    int32_t valptr[17];
    const uint8_t* huffval;
    // 8-bit lookahead: packed (symbol << 8) | code_length, 0 = miss
    uint16_t look[256];

    void build(const uint8_t* bits /*[16]*/, const uint8_t* vals /*[256]*/) {
        huffval = vals;
        int code = 0, k = 0;
        for (int l = 1; l <= 16; ++l) {
            valptr[l] = k;
            mincode[l] = code;
            int n = bits[l - 1];
            code += n;
            k += n;
            maxcode[l] = n ? code - 1 : -1;
            code <<= 1;
        }
        std::memset(look, 0, sizeof(look));
        k = 0;
        code = 0;
        for (int l = 1; l <= 8; ++l) {
            for (int n = 0; n < bits[l - 1]; ++n, ++k) {
                int c = mincode[l] + n;
                int lo = c << (8 - l);
                int hi = lo + (1 << (8 - l));
                for (int i = lo; i < hi; ++i)
                    look[i] = (uint16_t)((vals[k] << 8) | l);
            }
        }
    }
};

struct BitReader {
    const uint8_t* data;
    int64_t len;
    int64_t pos = 0;      // next byte index
    uint64_t acc = 0;     // MSB-aligned accumulator
    int nbits = 0;
    bool bad = false;
    int padded = 0;       // zero-fill bytes consumed past the segment end

    // Fill accumulator; stops before markers (0xFF non-00). A truncated or
    // corrupt stream would otherwise decode unlimited valid-looking blocks
    // from the zero padding (zero bits are valid Huffman codes), so more
    // than a lookahead's worth of padding marks the stream bad.
    inline void fill() {
        while (nbits <= 56) {
            if (pos >= len) {
                nbits += 8;
                if (++padded > 16) bad = true;
                continue;
            }
            uint8_t b = data[pos];
            if (b == 0xFF) {
                if (pos + 1 < len && data[pos + 1] == 0x00) {
                    pos += 2;
                } else {
                    // marker: behave as end of segment (pad with zeros)
                    nbits += 8;
                    continue;
                }
            } else {
                pos += 1;
            }
            acc |= (uint64_t)b << (56 - nbits);
            nbits += 8;
        }
    }

    inline int peek8() {
        if (nbits < 8) fill();
        return (int)(acc >> 56);
    }

    inline void drop(int n) {
        acc <<= n;
        nbits -= n;
    }

    inline int32_t get(int n) {   // read n bits MSB-first (n <= 16)
        if (n == 0) return 0;
        if (nbits < n) fill();
        int32_t v = (int32_t)(acc >> (64 - n));
        drop(n);
        return v;
    }

    inline int decode(const HuffDecoder& h) {
        int lk = h.look[peek8()];
        if (lk) {
            drop(lk & 0xFF);
            return lk >> 8;
        }
        // slow path: lengths 9..16 (start from the 8 peeked bits)
        int32_t code = peek8();
        drop(8);
        for (int l = 9; l <= 16; ++l) {
            code = (code << 1) | get(1);
            if (h.maxcode[l] >= 0 && code <= h.maxcode[l])
                return h.huffval[h.valptr[l] + (code - h.mincode[l])];
        }
        bad = true;
        return 0;
    }
};

inline int32_t extend(int32_t v, int s) {   // T.81 F.2.2.1
    if (s == 0) return 0;
    return (v >= (1 << (s - 1))) ? v : v - (1 << s) + 1;
}

struct SegBounds { int64_t start, end; };

// One pass over the stuffed scan: record every restart segment's byte range
// (segments are delimited by unstuffed RSTn markers; any foreign marker
// terminates the scan). Returns false when the segment count disagrees with
// the layout — a truncated stream must fail loudly, exactly as the Python
// reference decoder does.
static bool find_segments(const uint8_t* data, int64_t data_len,
                          int n_segments, std::vector<SegBounds>& segs) {
    segs.clear();
    segs.reserve(n_segments > 0 ? n_segments : 1);
    int64_t start = 0;
    for (int64_t i = 0; i + 1 < data_len; ++i) {
        if (data[i] == 0xFF) {
            uint8_t m = data[i + 1];
            if (m == 0x00) { ++i; continue; }
            if (m >= 0xD0 && m <= 0xD7) {
                segs.push_back({start, i});
                start = i + 2;
                ++i;
                continue;
            }
            segs.push_back({start, i});   // foreign marker ends the scan
            return (int)segs.size() == n_segments;
        }
    }
    if (start > data_len) start = data_len;   // RSTn as the final bytes
    segs.push_back({start, data_len});
    return (int)segs.size() == n_segments;
}

// Per-segment-range Huffman block loop. Restart segments are independent by
// construction (DC predictors reset, byte-aligned starts — T.81 F.1.2.3), so
// disjoint ranges can decode concurrently: the same property the stripe
// ENCODER builds on (SURVEY.md hard part 5). `emit(pos, flat_coef_index,
// value)` receives every NONZERO coefficient (the dense output buffer is
// pre-zeroed, so skipping zero DC is equivalent); `pos` = j*64+k is the
// coefficient's SCAN position — strictly increasing across the walk even
// for interleaved color, where the flat index jumps between component
// regions (the packed delta form needs a monotonic space). Returning false
// aborts with -9 (capacity exceeded).
template <typename Emit>
static int64_t decode_segment_range(
        const uint8_t* data, const SegBounds* segs, int s0, int s1,
        int n_comps, const int32_t* scan_comp, const int32_t* scan_flat,
        int64_t n_scan, const int32_t* comp_dc_tab,
        const int32_t* comp_ac_tab, const HuffDecoder* dc,
        const HuffDecoder* ac, int64_t blocks_per_segment, Emit&& emit) {
    int32_t pred[4];

    for (int s = s0; s < s1; ++s) {
        BitReader br{data + segs[s].start, segs[s].end - segs[s].start};
        for (int c = 0; c < 4; ++c) pred[c] = 0;

        int64_t j0 = (int64_t)s * blocks_per_segment;
        int64_t j1 = j0 + blocks_per_segment;
        if (j1 > n_scan) j1 = n_scan;
        for (int64_t j = j0; j < j1; ++j) {
            int ci = scan_comp[j];
            if (ci < 0 || ci >= n_comps || ci >= 4) return -2;
            int64_t base = (int64_t)scan_flat[j] * 64;
            int64_t pos = j * 64;
            const HuffDecoder& hdc = dc[comp_dc_tab[ci]];
            const HuffDecoder& hac = ac[comp_ac_tab[ci]];

            int ssss = br.decode(hdc);
            if (br.bad || ssss > 11) return -3;
            pred[ci] += extend(br.get(ssss), ssss);
            if (pred[ci] != 0 && !emit(pos, base, pred[ci])) return -9;

            int k = 1;
            while (k < 64) {
                int rs = br.decode(hac);
                if (br.bad) return -4;
                int r = rs >> 4, sz = rs & 15;
                if (sz == 0) {
                    if (rs == 0xF0) { k += 16; continue; }   // ZRL
                    break;                                    // EOB
                }
                k += r;
                if (k > 63) return -5;
                if (!emit(pos + k, base + k, extend(br.get(sz), sz)))
                    return -9;
                ++k;
            }
        }
    }
    return 0;
}

// Thread count for a segment-parallel decode: capped by the hardware, the
// segment count, and the useful work. Spawn+join costs ~1 ms/thread on
// this class of host while serial decode runs ~60-70 MB/s, so threads only
// pay off with >= ~512 KB of scan bytes each (measured: auto-threading a
// 70 KB 1080p Q75 scan was a 4x LOSS; a 1.9 MB noisy scan a 2.2x win).
static int pick_threads(int n_threads, int n_segments, int64_t data_len) {
    if (n_threads <= 0) {
        unsigned hc = std::thread::hardware_concurrency();
        n_threads = hc ? (int)hc : 1;
        // the byte gate applies to AUTO mode only: an explicit count is
        // honored (tests exercise the threaded paths on small fixtures)
        int64_t by_bytes = data_len / (512 << 10) + 1;
        if (n_threads > by_bytes) n_threads = (int)by_bytes;
    }
    if (n_threads > n_segments) n_threads = n_segments;
    return n_threads < 1 ? 1 : n_threads;
}

// Byte-balanced partition of segments into `nt` contiguous ranges:
// bounds[t]..bounds[t+1]. Segment sizes vary with content, so an equal-COUNT
// split can leave one thread with most of the bytes.
static void partition_segments(const std::vector<SegBounds>& segs, int nt,
                               std::vector<int>& bounds) {
    int n = (int)segs.size();
    int64_t total = 0;
    for (const auto& sb : segs) total += sb.end - sb.start;
    bounds.assign(nt + 1, n);
    bounds[0] = 0;
    int64_t acc = 0;
    int t = 1;
    for (int s = 0; s < n && t < nt; ++s) {
        acc += segs[s].end - segs[s].start;
        while (t < nt && acc * nt >= total * t)
            bounds[t++] = s + 1;
    }
}

// Shared prologue of the dense and sparse entry points: table build +
// validation + segment discovery. Returns 0 or a negative error.
static int decode_prologue(int n_comps,
                           const int32_t* comp_dc_tab,
                           const int32_t* comp_ac_tab,
                           const uint8_t* dc_bits, const uint8_t* dc_vals,
                           const uint8_t* ac_bits, const uint8_t* ac_vals,
                           const uint8_t* data, int64_t data_len,
                           int n_segments, HuffDecoder* dc, HuffDecoder* ac,
                           std::vector<SegBounds>& segs) {
    for (int t = 0; t < 4; ++t) {
        dc[t].build(dc_bits + 16 * t, dc_vals + 256 * t);
        ac[t].build(ac_bits + 16 * t, ac_vals + 256 * t);
    }
    // Table ids index the 4-element decoder arrays (T.81 allows Th 0-3 in
    // baseline files); reject anything else up front (the SOS parser
    // accepts Th up to 15 — an unvalidated id here would read out of
    // bounds). The Python callers additionally validate that each
    // referenced slot was actually defined in the file; an undefined slot
    // here is an empty decoder whose first use marks the stream bad.
    for (int c = 0; c < n_comps && c < 4; ++c) {
        if (comp_dc_tab[c] < 0 || comp_dc_tab[c] > 3 ||
            comp_ac_tab[c] < 0 || comp_ac_tab[c] > 3)
            return -8;
    }
    if (!find_segments(data, data_len, n_segments, segs)) return -6;
    return 0;
}

// Shared packed-emission step (serial and threaded paths): phantom hops
// across gaps > 255, |v| > 127 escaped to the exception sink, the entry
// itself last. `put(delta, val)` / `exc(idx, val)` return false to abort
// (capacity overflow in the serial sink; growable vectors never abort).
template <typename PutPair, typename PutExc>
static inline bool emit_packed_entry(int64_t pos, int64_t i, int32_t v,
                                     int64_t& prev, PutPair&& put,
                                     PutExc&& exc) {
    int64_t gap = pos - prev;
    while (gap > 255) {
        if (!put((uint8_t)255, (uint8_t)0)) return false;
        gap -= 255;
    }
    uint8_t vb;
    if (v >= -127 && v <= 127) {
        vb = (uint8_t)(int8_t)v;
    } else {
        vb = (uint8_t)(int8_t)(-128);
        if (!exc(i, v)) return false;
    }
    if (!put((uint8_t)gap, vb)) return false;
    prev = pos;
    return true;
}

}  // namespace

extern "C" {

// ABI version of the exported functions; the Python loader refuses a
// library whose value differs from native.ABI_VERSION.
int scan_codec_abi() { return 3; }

// data: full stuffed scan (with RSTn markers).
// comp_dc/ac_tab: table id (0-3) per component.
// dc_bits/dc_vals: [4][16]/[4][256]; likewise ac.
// n_threads: segment-parallel worker count (0 = auto). Restart segments are
// independent (DC-reset, byte-aligned), so threads decode disjoint segment
// ranges; each coefficient index belongs to exactly one block of one
// segment, so concurrent writes into `out` are disjoint by construction.
// out: [n_total_blocks * 64] int32, pre-zeroed by caller.
int decode_scan(const uint8_t* data, int64_t data_len,
                int n_comps,
                const int32_t* scan_comp, const int32_t* scan_flat,
                int64_t n_scan,
                const int32_t* comp_dc_tab, const int32_t* comp_ac_tab,
                const uint8_t* dc_bits, const uint8_t* dc_vals,
                const uint8_t* ac_bits, const uint8_t* ac_vals,
                int64_t blocks_per_segment, int n_segments, int n_threads,
                int32_t* out) {
    HuffDecoder dc[4], ac[4];
    std::vector<SegBounds> segs;
    int rc = decode_prologue(n_comps, comp_dc_tab, comp_ac_tab,
                             dc_bits, dc_vals, ac_bits, ac_vals,
                             data, data_len, n_segments, dc, ac, segs);
    if (rc) return rc;

    auto emit = [&](int64_t, int64_t i, int32_t v) { out[i] = v; return true; };
    int nt = pick_threads(n_threads, n_segments, data_len);
    if (nt <= 1)
        return (int)decode_segment_range(
            data, segs.data(), 0, n_segments, n_comps, scan_comp, scan_flat,
            n_scan, comp_dc_tab, comp_ac_tab, dc, ac, blocks_per_segment,
            emit);

    std::vector<int> bounds;
    partition_segments(segs, nt, bounds);
    std::vector<int64_t> rcs(nt, 0);
    std::vector<std::thread> workers;
    workers.reserve(nt);
    for (int t = 0; t < nt; ++t) {
        workers.emplace_back([&, t]() {
            rcs[t] = decode_segment_range(
                data, segs.data(), bounds[t], bounds[t + 1], n_comps,
                scan_comp, scan_flat, n_scan, comp_dc_tab, comp_ac_tab,
                dc, ac, blocks_per_segment, emit);
        });
    }
    for (auto& w : workers) w.join();
    for (int t = 0; t < nt; ++t)
        if (rcs[t]) return (int)rcs[t];
    return 0;
}

// Final host pass of the production pipeline (the one piece of host work the
// capability contract keeps on host): the device downloads a COMPACT
// unstuffed stream — per-segment byte runs (already 1-padded) packed
// back-to-back without markers — and this inserts FF00 stuffing plus RSTn
// joins at memcpy speed. u: concatenated segment bytes; seg_nbytes[s] bytes
// per segment; RSTn after segment s for s < n_rst, numbered (first_rst+s)%8.
// out must hold 2x total bytes + 2*n_seg. Returns output length.
int64_t finalize_compact(const uint8_t* u, const int32_t* seg_nbytes,
                         int n_seg, int first_rst, int n_rst,
                         uint8_t* out) {
    int64_t o = 0, p = 0;
    for (int s = 0; s < n_seg; ++s) {
        for (int32_t j = 0; j < seg_nbytes[s]; ++j) {
            uint8_t b = u[p++];
            out[o++] = b;
            if (b == 0xFF) out[o++] = 0x00;
        }
        if (s < n_rst) {
            out[o++] = 0xFF;
            out[o++] = (uint8_t)(0xD0 + ((first_rst + s) & 7));
        }
    }
    return o;
}

// Word-compact variant of finalize_compact: the device byte-swapped each
// u32 so the downloaded buffer's memory image IS the byte stream, with
// segment s's ceil(bits/8) bytes starting at byte offset 4*wbase[s]
// (wbase = exclusive cumsum of ceil(bits/32) rounded up to walign-word
// chunks — walign MUST equal ops.pack.walign_for(blocks_per_segment) for
// the layout that produced the stream). This sets each segment's
// T.81 F.1.2.3 1-padding in its final byte, stuffs FF->FF00 and joins
// segments with RSTn. out must hold 2x total bytes + 2*n_seg.
int64_t finalize_wcompact(const uint8_t* u, const int32_t* seg_nbits,
                          int n_seg, int first_rst, int n_rst, int walign,
                          uint8_t* out) {
    int64_t o = 0, wbase = 0;
    for (int s = 0; s < n_seg; ++s) {
        int64_t nbits = seg_nbits[s];
        int64_t nbytes = (nbits + 7) >> 3;
        int pad = (int)(nbytes * 8 - nbits);
        const uint8_t* seg = u + 4 * wbase;
        for (int64_t j = 0; j < nbytes; ++j) {
            uint8_t b = seg[j];
            if (j == nbytes - 1 && pad) b |= (uint8_t)((1 << pad) - 1);
            out[o++] = b;
            if (b == 0xFF) out[o++] = 0x00;
        }
        if (s < n_rst) {
            out[o++] = 0xFF;
            out[o++] = (uint8_t)(0xD0 + ((first_rst + s) & 7));
        }
        // walign chunks — matches ops.pack.seg_nwords_aligned
        wbase += (((nbits + 31) >> 5) + walign - 1) & ~(int64_t)(walign - 1);
    }
    return o;
}

// T.81 Annex K.2 optimal Huffman table construction (SURVEY.md component
// #14), exact port of the Python jpgenc_tpu.huffman.optimize_tables: merge
// the two least-frequent nonzero entries (ties -> highest symbol value,
// matching libjpeg's convention) chaining code sizes, ADJUST_BITS to fold
// lengths above 16 down, drop the reserved all-ones phantom symbol, then
// SORT_INPUT by (code size, symbol value). Per-image optimized encode calls
// this 4x per image; the Python version's ~6 ms/call made the 1024-image
// batch config host-bound.
// freq256: [256] counts. bits16: out [16]. vals: out [256] (symbol order).
// Returns the number of symbols, or -1 on internal inconsistency (caller
// falls back to the Python path).
int optimize_tables(const int64_t* freq256, int32_t* bits16, int32_t* vals) {
    int64_t f[257];
    for (int i = 0; i < 256; ++i) f[i] = freq256[i];
    f[256] = 1;  // reserved: guarantees the all-ones code is never assigned
    int32_t codesize[257];
    int32_t others[257];
    for (int i = 0; i < 257; ++i) { codesize[i] = 0; others[i] = -1; }

    for (;;) {
        // two least-frequent nonzero entries; ties -> highest symbol value
        int c1 = -1;
        int64_t m1 = INT64_MAX;
        for (int i = 0; i < 257; ++i)
            if (f[i] > 0 && f[i] <= m1) { m1 = f[i]; c1 = i; }
        if (c1 < 0) break;
        int c2 = -1;
        int64_t m2 = INT64_MAX;
        for (int i = 0; i < 257; ++i)
            if (f[i] > 0 && i != c1 && f[i] <= m2) { m2 = f[i]; c2 = i; }
        if (c2 < 0) break;

        f[c1] += f[c2];
        f[c2] = 0;
        codesize[c1] += 1;
        while (others[c1] >= 0) { c1 = others[c1]; codesize[c1] += 1; }
        others[c1] = c2;
        codesize[c2] += 1;
        while (others[c2] >= 0) { c2 = others[c2]; codesize[c2] += 1; }
    }

    int max_size = 0;
    for (int i = 0; i < 257; ++i)
        if (codesize[i] > max_size) max_size = codesize[i];
    if (max_size > 256) return -1;
    int counts_top = max_size > 16 ? max_size : 16;  // counts[0..counts_top]
    int64_t counts[258];
    for (int i = 0; i <= counts_top; ++i) counts[i] = 0;
    for (int i = 0; i < 257; ++i)
        if (codesize[i] > 0) counts[codesize[i]] += 1;

    // ADJUST_BITS (T.81 Figure K.3): fold lengths > 16 down
    int i = counts_top;
    while (i > 16) {
        while (counts[i] > 0) {
            int j = i - 2;
            while (j >= 0 && counts[j] == 0) --j;
            if (j < 0) return -1;
            counts[i] -= 2;
            counts[i - 1] += 1;
            counts[j + 1] += 2;
            counts[j] -= 1;
        }
        --i;
    }
    // remove the reserved symbol's code from the longest used length
    while (i >= 0 && counts[i] == 0) --i;
    if (i < 0) {  // empty histogram: empty table (mirrors the Python path)
        for (int k = 0; k < 16; ++k) bits16[k] = 0;
        return 0;
    }
    counts[i] -= 1;

    for (int k = 0; k < 16; ++k) bits16[k] = 0;
    int lim = i < 16 ? i : 16;
    for (int k = 0; k < lim; ++k) bits16[k] = (int32_t)counts[k + 1];

    // SORT_INPUT (T.81 Figure K.4): by original code size, then symbol value
    int n = 0;
    for (int size = 1; size <= max_size; ++size)
        for (int sym = 0; sym < 256; ++sym)
            if (codesize[sym] == size) vals[n++] = sym;

    int64_t total = 0;
    for (int k = 0; k < 16; ++k) total += bits16[k];
    if (total != n) return -1;
    return n;
}

// FF->FF00 stuffing + per-segment assembly used by the host fallback path:
// words: [n_seg * w] u32 (MSB-first), bits: [n_seg].
// out must hold worst case (2x bytes + 2 per segment). Returns output length.
int64_t finalize_scan(const uint32_t* words, const int32_t* bits,
                      int n_seg, int64_t w, int first_rst,
                      uint8_t* out) {
    int64_t o = 0;
    for (int s = 0; s < n_seg; ++s) {
        int64_t nbits = bits[s];
        int64_t nbytes = (nbits + 7) >> 3;
        int pad = (int)(nbytes * 8 - nbits);
        const uint32_t* seg = words + (int64_t)s * w;
        for (int64_t j = 0; j < nbytes; ++j) {
            uint8_t b = (uint8_t)(seg[j >> 2] >> (8 * (3 - (j & 3))));
            if (j == nbytes - 1 && pad) b |= (uint8_t)((1 << pad) - 1);
            out[o++] = b;
            if (b == 0xFF) out[o++] = 0x00;
        }
        if (s < n_seg - 1) {
            out[o++] = 0xFF;
            out[o++] = (uint8_t)(0xD0 + ((first_rst + s) & 7));
        }
    }
    return o;
}


// Sparse variant: emit (flat coefficient index, value) pairs — the form
// the device decode path uploads (decoder._rows_from_pairs, no dense round
// trip). n_threads: segment-parallel worker count (0 = auto); each worker
// fills a private pair buffer for its contiguous segment range, and the
// buffers concatenate in segment order afterward (same emit order as the
// single-threaded walk). idx_out/val_out hold `cap` entries; returns the
// pair count, a negative decode error, or -9 when cap is exceeded (the
// Python wrapper then falls back to the dense path, keeping
// malformed-stream behavior identical between the two).
int64_t decode_scan_sparse(const uint8_t* data, int64_t data_len,
                           int n_comps,
                           const int32_t* scan_comp, const int32_t* scan_flat,
                           int64_t n_scan,
                           const int32_t* comp_dc_tab,
                           const int32_t* comp_ac_tab,
                           const uint8_t* dc_bits, const uint8_t* dc_vals,
                           const uint8_t* ac_bits, const uint8_t* ac_vals,
                           int64_t blocks_per_segment, int n_segments,
                           int n_threads, int64_t cap,
                           int32_t* idx_out, int16_t* val_out) {
    HuffDecoder dc[4], ac[4];
    std::vector<SegBounds> segs;
    int prc = decode_prologue(n_comps, comp_dc_tab, comp_ac_tab,
                              dc_bits, dc_vals, ac_bits, ac_vals,
                              data, data_len, n_segments, dc, ac, segs);
    if (prc) return prc;

    int nt = pick_threads(n_threads, n_segments, data_len);
    if (nt <= 1) {
        int64_t n = 0;
        int64_t rc = decode_segment_range(
            data, segs.data(), 0, n_segments, n_comps, scan_comp, scan_flat,
            n_scan, comp_dc_tab, comp_ac_tab, dc, ac, blocks_per_segment,
            [&](int64_t, int64_t i, int32_t v) {
                if (n >= cap) return false;
                idx_out[n] = (int32_t)i;
                val_out[n++] = (int16_t)v;
                return true;
            });
        return rc ? rc : n;
    }

    std::vector<int> bounds;
    partition_segments(segs, nt, bounds);
    std::vector<int64_t> rcs(nt, 0);
    std::vector<std::vector<int32_t>> tidx(nt);
    std::vector<std::vector<int16_t>> tval(nt);
    std::vector<std::thread> workers;
    workers.reserve(nt);
    for (int t = 0; t < nt; ++t) {
        workers.emplace_back([&, t]() {
            int64_t bytes = 0;
            for (int s = bounds[t]; s < bounds[t + 1]; ++s)
                bytes += segs[s].end - segs[s].start;
            // WORKER-LOCAL vectors: the elements of the shared outer
            // vectors are 24-byte headers packed into the same cache
            // lines, and push_back stores to the header — false sharing
            // on every emitted coefficient (measured 5x slowdown).
            // Reserve for the TYPICAL density (~4 bits/coefficient), not
            // the 2-bit worst-case cap (whose page faults dwarf the
            // decode); push_back growth handles denser content.
            std::vector<int32_t> li;
            std::vector<int16_t> lv;
            int64_t hint = bytes / 2 + 64 * (bounds[t + 1] - bounds[t]) + 64;
            int64_t slots =
                (int64_t)(bounds[t + 1] - bounds[t]) * blocks_per_segment * 64;
            if (hint > slots) hint = slots;
            li.reserve((size_t)hint);
            lv.reserve((size_t)hint);
            int64_t rc = decode_segment_range(
                data, segs.data(), bounds[t], bounds[t + 1], n_comps,
                scan_comp, scan_flat, n_scan, comp_dc_tab, comp_ac_tab,
                dc, ac, blocks_per_segment,
                [&](int64_t, int64_t i, int32_t v) {
                    li.push_back((int32_t)i);
                    lv.push_back((int16_t)v);
                    return true;
                });
            tidx[t] = std::move(li);
            tval[t] = std::move(lv);
            rcs[t] = rc;
        });
    }
    for (auto& w : workers) w.join();
    for (int t = 0; t < nt; ++t)
        if (rcs[t]) return rcs[t];
    int64_t n = 0;
    for (int t = 0; t < nt; ++t) n += (int64_t)tidx[t].size();
    if (n > cap) return -9;
    int64_t o = 0;
    for (int t = 0; t < nt; ++t) {
        if (!tidx[t].empty()) {
            std::memcpy(idx_out + o, tidx[t].data(),
                        tidx[t].size() * sizeof(int32_t));
            std::memcpy(val_out + o, tval[t].data(),
                        tval[t].size() * sizeof(int16_t));
            o += (int64_t)tidx[t].size();
        }
    }
    return n;
}

// Packed variant: emit the nonzero coefficients as a 2-byte-per-entry
// (delta u8, value s8) stream plus a small exception list — the MINIMAL
// host->device form (3x smaller than the (idx,val) pair rows). Semantics, reconstructed on device by decoder._densify_packed:
//   idx = cumsum(delta) - 1;  flat[idx] = value   (strictly increasing idx)
// - a gap > 255 between nonzeros is bridged by PHANTOM entries
//   (delta=255, value=0): they write 0 into positions inside the gap,
//   which are zero anyway — harmless by construction;
// - |value| > 127 emits value as the entry's sign-preserved clamp escape
//   (-128) AND appends (flat idx, true value) to the exception list; the
//   device scatters exceptions AFTER the main stream, overwriting the
//   escape byte. Trailing pad entries use the same phantom form.
// n_threads: segment-parallel workers (0 = auto, gated like decode_scan):
// each worker's delta chain anchors at its range's first scan position,
// and the sequential concat re-bridges the chains (adjust the range's
// first delta, insert phantom hops) so the merged stream is identical in
// meaning to the serial walk.
// Returns packed entry count; n_exc_out gets the exception count; -9 when
// either capacity is exceeded (caller falls back to the pair form); other
// negative codes as decode_scan.
int64_t decode_scan_packed(const uint8_t* data, int64_t data_len,
                           int n_comps,
                           const int32_t* scan_comp, const int32_t* scan_flat,
                           int64_t n_scan,
                           const int32_t* comp_dc_tab,
                           const int32_t* comp_ac_tab,
                           const uint8_t* dc_bits, const uint8_t* dc_vals,
                           const uint8_t* ac_bits, const uint8_t* ac_vals,
                           int64_t blocks_per_segment, int n_segments,
                           int n_threads, int64_t cap_main, int64_t cap_exc,
                           uint8_t* main_out /*[cap_main*2]*/,
                           int32_t* exc_idx, int16_t* exc_val,
                           int64_t* n_exc_out) {
    HuffDecoder dc[4], ac[4];
    std::vector<SegBounds> segs;
    int prc = decode_prologue(n_comps, comp_dc_tab, comp_ac_tab,
                              dc_bits, dc_vals, ac_bits, ac_vals,
                              data, data_len, n_segments, dc, ac, segs);
    if (prc) return prc;

    int nt = pick_threads(n_threads, n_segments, data_len);
    if (nt <= 1) {
        int64_t n = 0, ne = 0, prev = -1;
        bool overflow = false;
        auto put = [&](uint8_t d, uint8_t vb) {
            if (n >= cap_main) { overflow = true; return false; }
            main_out[2 * n] = d;
            main_out[2 * n + 1] = vb;
            ++n;
            return true;
        };
        auto exc = [&](int64_t i, int32_t v) {
            if (ne >= cap_exc) { overflow = true; return false; }
            exc_idx[ne] = (int32_t)i;
            exc_val[ne] = (int16_t)v;
            ++ne;
            return true;
        };
        int64_t rc = decode_segment_range(
            data, segs.data(), 0, n_segments, n_comps, scan_comp, scan_flat,
            n_scan, comp_dc_tab, comp_ac_tab, dc, ac, blocks_per_segment,
            [&](int64_t pos, int64_t i, int32_t v) {
                return emit_packed_entry(pos, i, v, prev, put, exc);
            });
        if (overflow) return -9;
        if (rc) return rc;
        *n_exc_out = ne;
        return n;
    }

    // threaded: worker-local streams anchored at each range's first scan
    // position; the merge below re-bridges the delta chains
    std::vector<int> bounds;
    partition_segments(segs, nt, bounds);
    std::vector<int64_t> rcs(nt, 0);
    std::vector<std::vector<uint8_t>> tmain(nt);   // (delta, val) pairs
    std::vector<std::vector<int32_t>> tei(nt);
    std::vector<std::vector<int16_t>> tev(nt);
    std::vector<int64_t> tlast(nt, 0);   // each worker's final global pos
    std::vector<std::thread> workers;
    workers.reserve(nt);
    for (int t = 0; t < nt; ++t) {
        workers.emplace_back([&, t]() {
            int64_t bytes = 0;
            for (int s = bounds[t]; s < bounds[t + 1]; ++s)
                bytes += segs[s].end - segs[s].start;
            std::vector<uint8_t> lm;            // worker-local (see sparse
            std::vector<int32_t> li;            // variant: false sharing)
            std::vector<int16_t> lv;
            lm.reserve((size_t)(bytes + 128));  // ~4 bits/coef typical
            int64_t prev =
                (int64_t)bounds[t] * blocks_per_segment * 64 - 1;
            auto put = [&](uint8_t d, uint8_t vb) {
                lm.push_back(d);
                lm.push_back(vb);
                return true;
            };
            auto exc = [&](int64_t i, int32_t v) {
                li.push_back((int32_t)i);
                lv.push_back((int16_t)v);
                return true;
            };
            int64_t rc = decode_segment_range(
                data, segs.data(), bounds[t], bounds[t + 1], n_comps,
                scan_comp, scan_flat, n_scan, comp_dc_tab, comp_ac_tab,
                dc, ac, blocks_per_segment,
                [&](int64_t pos, int64_t i, int32_t v) {
                    return emit_packed_entry(pos, i, v, prev, put, exc);
                });
            tmain[t] = std::move(lm);
            tei[t] = std::move(li);
            tev[t] = std::move(lv);
            tlast[t] = prev;
            rcs[t] = rc;
        });
    }
    for (auto& w : workers) w.join();
    for (int t = 0; t < nt; ++t)
        if (rcs[t]) return rcs[t];

    // sequential merge with delta re-bridging (same math as the Python
    // _flatten_packed frame bridging)
    int64_t n = 0, ne = 0, prev = -1;
    for (int t = 0; t < nt; ++t) {
        const auto& m = tmain[t];
        int64_t cnt = (int64_t)m.size() / 2;
        if (cnt) {
            int64_t base = (int64_t)bounds[t] * blocks_per_segment * 64 - 1;
            int64_t first = base + m[0];        // global pos of 1st entry
            int64_t gap = first - prev;
            int64_t k = (gap - 1) / 255;        // bridge phantom hops
            if (n + k + cnt > cap_main) return -9;
            for (int64_t p = 0; p < k; ++p) {
                main_out[2 * n] = 255;
                main_out[2 * n + 1] = 0;
                ++n;
            }
            std::memcpy(main_out + 2 * n, m.data(), m.size());
            main_out[2 * n] = (uint8_t)(gap - 255 * k);
            n += cnt;
            // each worker recorded its final global position — no
            // re-summing of the stream's deltas here
            prev = tlast[t];
        }
        if (!tei[t].empty()) {
            if (ne + (int64_t)tei[t].size() > cap_exc) return -9;
            std::memcpy(exc_idx + ne, tei[t].data(),
                        tei[t].size() * sizeof(int32_t));
            std::memcpy(exc_val + ne, tev[t].data(),
                        tev[t].size() * sizeof(int16_t));
            ne += (int64_t)tei[t].size();
        }
    }
    *n_exc_out = ne;
    return n;
}

}  // extern "C"
