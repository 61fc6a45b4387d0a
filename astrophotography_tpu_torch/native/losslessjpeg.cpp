// Lossless JPEG (ITU-T81 process 14, SOF3) decoder.
//
// Native replacement for the LibRaw decode path the reference uses via
// rawpy (reference core/RawConv.py:82): Canon CR2 and compressed DNG
// files store the Bayer mosaic as Huffman-coded lossless JPEG.  This
// implements the full SOF3 feature set needed for raw stills:
// predictors 1-7, 2-16 bit precision, 1-4 interleaved components,
// restart markers, byte stuffing, and point transform.
//
// Exposed as a C ABI for ctypes (no pybind11 in this environment).
//
// Build: g++ -O3 -shared -fPIC -o liblosslessjpeg.so losslessjpeg.cpp

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct BitReader {
    const uint8_t* data;
    size_t size;
    size_t pos = 0;
    uint32_t bitbuf = 0;
    int bitcount = 0;
    bool hit_marker = false;
    // bits fed as pad (past a marker or hard EOF).  A well-formed
    // stream needs only final-byte padding plus decoder look-ahead
    // (< ~64 bits); a TRUNCATED stream decodes its remaining samples
    // entirely from pad, so the counter exposes it.
    size_t pad_bits = 0;

    explicit BitReader(const uint8_t* d, size_t n) : data(d), size(n) {}

    // Refill with JPEG byte stuffing: 0xFF 0x00 -> literal 0xFF;
    // 0xFF other -> marker (stop); hard EOF -> pad with ones.
    inline void refill() {
        while (bitcount <= 24) {
            if (pos >= size) {
                // hard EOF (no trailing marker): spec pad, counted
                pad_bits += 8;
                bitbuf |= 0xFFu << (24 - bitcount);
                bitcount += 8;
                continue;
            }
            uint8_t b = data[pos];
            if (b == 0xFF) {
                if (pos + 1 < size && data[pos + 1] == 0x00) {
                    pos += 2;
                } else {
                    // marker: feed ones (spec pad); flag it
                    hit_marker = true;
                    pad_bits += 8;
                    bitbuf |= 0xFFu << (24 - bitcount);
                    bitcount += 8;
                    continue;
                }
            } else {
                pos += 1;
            }
            bitbuf |= static_cast<uint32_t>(b) << (24 - bitcount);
            bitcount += 8;
        }
    }

    inline int get_bits(int n) {
        if (n == 0) return 0;
        if (bitcount < n) refill();
        int v = static_cast<int>(bitbuf >> (32 - n));
        bitbuf <<= n;
        bitcount -= n;
        return v;
    }

    inline int peek16() {
        if (bitcount < 16) refill();
        return static_cast<int>(bitbuf >> 16);
    }

    inline void skip(int n) {
        bitbuf <<= n;
        bitcount -= n;
    }

    // Reset at a restart marker: discard partial byte, skip RSTn.
    void restart_sync() {
        bitbuf = 0;
        bitcount = 0;
        hit_marker = false;
        pad_bits = 0;  // look-ahead pad at an interval boundary is legit
        // scan forward to the RST marker and skip it
        while (pos + 1 < size) {
            if (data[pos] == 0xFF && data[pos + 1] >= 0xD0 &&
                data[pos + 1] <= 0xD7) {
                pos += 2;
                return;
            }
            pos += 1;
        }
    }
};

struct Huffman {
    // value and length lookup by 16-bit peek
    uint8_t value[65536];
    uint8_t length[65536];
    bool valid = false;

    // Returns false (and stays !valid) when the counts do not form a
    // canonical prefix code — a corrupt DHT would otherwise index the
    // lookup tables out of bounds (code << (16 - len) past 65536).
    bool build(const uint8_t counts[16], const uint8_t* symbols) {
        memset(length, 0, sizeof(length));
        int code = 0;
        int k = 0;
        for (int len = 1; len <= 16; ++len) {
            for (int i = 0; i < counts[len - 1]; ++i) {
                if (code >= (1 << len)) return false;  // Kraft violated
                int lo = code << (16 - len);
                int hi = lo + (1 << (16 - len));
                for (int c = lo; c < hi; ++c) {
                    value[c] = symbols[k];
                    length[c] = static_cast<uint8_t>(len);
                }
                ++code;
                ++k;
            }
            code <<= 1;
        }
        valid = true;
        return true;
    }
};

inline int extend(int v, int ssss) {
    // ITU-T81 F.2.2.1 EXTEND: map magnitude-coded value to signed
    if (ssss == 0) return 0;
    if (v < (1 << (ssss - 1))) return v - (1 << ssss) + 1;
    return v;
}

// INT32_MIN signals an invalid (unassigned) code — a corrupt or
// truncated stream; real diffs are within [-65535, 65535].
constexpr int kBadCode = INT32_MIN;

inline int decode_diff(BitReader& br, const Huffman& h) {
    int peek = br.peek16();
    int len = h.length[peek];
    if (len == 0) return kBadCode;
    int ssss = h.value[peek];
    br.skip(len);
    if (ssss == 0) return 0;
    if (ssss == 16) return -32768;  // special case: diff = 32768
    int bits = br.get_bits(ssss);
    return extend(bits, ssss);
}

}  // namespace

extern "C" {

// Decode a lossless JPEG payload.
//   data/size    : the JPEG stream (starting at SOI)
//   out          : caller buffer of out_capacity uint16 samples
//   out_capacity : buffer length in samples (int64: sensor geometries
//                  can exceed 2^31 samples only via corrupt headers,
//                  which the bound check must still reject, not wrap)
// Returns 0 on success, negative error code otherwise:
//   -1 no SOI  -2 bad SOF fields  -3 EOI before SOS  -4 incomplete
//   headers  -5 frame exceeds out buffer  -6 missing/corrupt Huffman
//   table  -7 segment overruns the payload  -8 truncated scan data
//   -9 invalid Huffman code in scan
// On success, *jw/*jh/*jc receive the JPEG frame geometry.
int lljpeg_decode(const uint8_t* data, size_t size, uint16_t* out,
                  int64_t out_capacity, int* jw, int* jh, int* jc) {
    if (size < 4 || data[0] != 0xFF || data[1] != 0xD8) return -1;  // no SOI
    size_t pos = 2;
    Huffman tables[4];
    int precision = 0, height = 0, width = 0, ncomp = 0;
    int comp_table[4] = {0, 0, 0, 0};
    int predictor = 1, pt = 0;
    int restart_interval = 0;
    size_t scan_start = 0;

    while (pos + 4 <= size) {
        if (data[pos] != 0xFF) { ++pos; continue; }
        uint8_t marker = data[pos + 1];
        if (marker == 0xD8 || marker == 0x01 ||
            (marker >= 0xD0 && marker <= 0xD7)) { pos += 2; continue; }
        if (marker == 0xD9) return -3;  // EOI before SOS
        size_t seglen = (data[pos + 2] << 8) | data[pos + 3];
        // every marker we parse below carries a length field; a length
        // running past the payload would read out of bounds
        if (seglen < 2 || pos + 2 + seglen > size) return -7;
        const uint8_t* seg = data + pos + 4;
        if (marker == 0xC3 || marker == 0xC7 || marker == 0xCB ||
            marker == 0xCF) {  // SOF3 (+ hierarchical variants)
            if (seglen < 8) return -7;
            precision = seg[0];
            height = (seg[1] << 8) | seg[2];
            width = (seg[3] << 8) | seg[4];
            ncomp = seg[5];
            if (ncomp < 1 || ncomp > 4) return -2;
            if (precision < 2 || precision > 16) return -2;
        } else if (marker == 0xC4) {  // DHT (possibly multiple tables)
            size_t off = 0;
            while (off + 17 <= seglen - 2) {
                int tc_th = seg[off];
                int id = tc_th & 0x0F;
                const uint8_t* counts = seg + off + 1;
                size_t total = 0;
                for (int i = 0; i < 16; ++i) total += counts[i];
                if (off + 17 + total > seglen - 2) return -7;
                if (id < 4 && !tables[id].build(counts, seg + off + 17))
                    return -6;  // non-canonical counts
                off += 17 + total;
            }
        } else if (marker == 0xDD) {  // DRI
            if (seglen < 4) return -7;
            restart_interval = (seg[0] << 8) | seg[1];
        } else if (marker == 0xDA) {  // SOS
            if (seglen < 3) return -7;
            size_t ns = seg[0];
            if (seglen < 2 + 1 + 2 * ns + 3) return -7;
            for (size_t i = 0; i < ns && i < 4; ++i)
                comp_table[i] = seg[1 + 2 * i + 1] >> 4;
            predictor = seg[1 + 2 * ns];
            pt = seg[3 + 2 * ns] & 0x0F;
            scan_start = pos + 4 + (seglen - 2);
            break;
        }
        pos += 2 + seglen;
    }
    if (height == 0 || width == 0 || ncomp == 0 || scan_start == 0) return -4;
    if (pt >= precision) return -2;
    if (static_cast<int64_t>(height) * width * ncomp > out_capacity)
        return -5;
    for (int c = 0; c < ncomp; ++c)
        if (!tables[comp_table[c]].valid) return -6;

    *jw = width;
    *jh = height;
    *jc = ncomp;

    BitReader br(data + scan_start, size - scan_start);
    const int default_pred = 1 << (precision - 1 - pt);
    const int rowlen = width * ncomp;
    std::vector<int> diff(ncomp);

    int mcu_count = 0;
    // Prediction origin: at the start of the scan and after each restart
    // marker, prediction restarts as at the start of a scan (ITU-T81
    // H.2.2): the first line from the origin uses the 1-D left predictor
    // (Ra), its first sample the default 2^(P-Pt-1).  (restart_row,
    // restart_col) is the origin; decoding is sequential, so samples
    // before the origin in the same row are already written.
    int restart_row = 0, restart_col = 0;
    for (int row = 0; row < height; ++row) {
        uint16_t* cur = out + static_cast<size_t>(row) * rowlen;
        const uint16_t* prev = out + static_cast<size_t>(row - 1) * rowlen;
        for (int col = 0; col < width; ++col) {
            for (int c = 0; c < ncomp; ++c) {
                int d = decode_diff(br, tables[comp_table[c]]);
                if (d == kBadCode)
                    // unassigned prefix: pad ones past EOF decode as an
                    // invalid code (truncated scan), and mid-stream it
                    // means corruption
                    return br.pad_bits > 0 ? -8 : -9;
                int pred;
                if (row == restart_row && col >= restart_col) {
                    // first line of the scan / restart interval
                    pred = (col == restart_col)
                               ? default_pred
                               : cur[(col - 1) * ncomp + c];  // Ra
                } else if (col == 0) {
                    pred = prev[c];  // first sample of row: above (Rb)
                } else {
                    int Ra = cur[(col - 1) * ncomp + c];
                    int Rb = prev[col * ncomp + c];
                    int Rc = prev[(col - 1) * ncomp + c];
                    switch (predictor) {
                        case 1: pred = Ra; break;
                        case 2: pred = Rb; break;
                        case 3: pred = Rc; break;
                        case 4: pred = Ra + Rb - Rc; break;
                        case 5: pred = Ra + ((Rb - Rc) >> 1); break;
                        case 6: pred = Rb + ((Ra - Rc) >> 1); break;
                        case 7: pred = (Ra + Rb) >> 1; break;
                        default: pred = Ra; break;
                    }
                }
                int val = (pred + d) & 0xFFFF;
                cur[col * ncomp + c] = static_cast<uint16_t>(val << pt);
            }
            if (restart_interval) {
                ++mcu_count;
                if (mcu_count == restart_interval &&
                    !(row == height - 1 && col == width - 1)) {
                    br.restart_sync();
                    mcu_count = 0;
                    // prediction restarts as at a new scan from the
                    // next sample (ITU-T81 H.2.2)
                    restart_row = (col == width - 1) ? row + 1 : row;
                    restart_col = (col == width - 1) ? 0 : col + 1;
                }
            }
        }
    }
    // a complete scan consumes real bits to its last sample; needing
    // more than ~64 pad bits means the stream ended early and the tail
    // of the image decoded from padding, not data
    if (br.pad_bits > 64) return -8;
    return 0;
}


// Entropy-encode one lossless-JPEG scan interval.
//   diffs/ssss  : n mapped differences (in [-32768, 32767]) and their
//                 bit categories; ssss==16 carries no extra bits.
//   code/len    : Huffman code and code length per category (17 entries).
//   out/out_cap : caller buffer; worst case ~n*33/8 bits plus stuffing.
// Returns bytes written (stuffed, 1-padded to a byte) or -1 on overflow.
// Byte-identical to the Python _BitWriter path in io/losslessjpeg.py.
long lljpeg_entropy_encode(const int32_t* diffs, const int32_t* ssss,
                           size_t n, const uint32_t* code,
                           const int32_t* len, uint8_t* out,
                           size_t out_cap) {
    size_t w = 0;
    uint64_t acc = 0;     // bit accumulator, bits fill from LSB end
    int nbits = 0;
    for (size_t i = 0; i < n; ++i) {
        int s = ssss[i];
        uint64_t v = code[s];
        int l = len[s];
        if (s > 0 && s < 16) {
            int32_t d = diffs[i];
            uint32_t extra =
                (uint32_t)(d >= 0 ? d : d + (1 << s) - 1) & ((1u << s) - 1u);
            v = (v << s) | extra;
            l += s;
        }
        acc = (acc << l) | v;
        nbits += l;
        while (nbits >= 8) {
            uint8_t b = (uint8_t)(acc >> (nbits - 8));
            nbits -= 8;
            if (w + 2 > out_cap) return -1;
            out[w++] = b;
            if (b == 0xFF) out[w++] = 0x00;  // byte stuffing
        }
        // acc keeps only nbits < 8 live bits plus stale high bits; the
        // next shift-left never overflows 64 since l <= 31 and the live
        // window is < 8 bits -- mask to keep the arithmetic clean
        acc &= (1ull << nbits) - 1ull;
    }
    if (nbits) {
        int pad = 8 - nbits;
        uint8_t b = (uint8_t)((acc << pad) | ((1u << pad) - 1u));
        if (w + 2 > out_cap) return -1;
        out[w++] = b;
        if (b == 0xFF) out[w++] = 0x00;
    }
    return (long)w;
}

}  // extern "C"
