// Host image decoding for the dataset readers: a JPEG decoder whose
// greyscale output equals Pillow's Image.open(path).convert("L") on
// libjpeg-turbo (ISLOW IDCT, fancy upsampling, libjpeg's YCbCr->RGB tables,
// then Pillow's rgb2l), and the PNG row unfiltering of the PNG reader in
// ../../utils/render.py. Loaded through ctypes by ../imageio.py, which
// builds it with g++ at first use.
//
// JPEG scope: 8-bit baseline and extended-sequential Huffman (SOF0, SOF1)
// and progressive Huffman (SOF2), one component (greyscale), three (YCbCr,
// or RGB when an Adobe APP14 marker says transform 0 or the component ids
// are 'R', 'G', 'B') or four (CMYK, or YCCK when an Adobe marker says a
// transform other than 0: libjpeg's rule), sampling ratios 1 or 2 per
// axis, restart intervals, multi-scan sequential files. Four components
// reach grey as Pillow takes them: libjpeg's YCCK->CMYK, Pillow's
// inversion of Adobe CMYK ("CMYK;I"), then its cmyk2rgb and rgb2l.
// Arithmetic coding, lossless and hierarchical frames, 12-bit samples,
// other component counts and truncated files raise. Progressive files decode
// without libjpeg's block smoothing, which libjpeg applies only while the
// low AC coefficients are not yet fully refined (never once every scan of
// a standard progression has been read).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libimagecodec.so imagecodec.cpp

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct JpegError : std::runtime_error {
    using std::runtime_error::runtime_error;
};

// Zigzag position -> natural (row-major) position, with libjpeg's 16
// extra entries so that corrupt run lengths cannot index past the block.
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

std::string hex_marker(int m) {
    char buf[8];
    snprintf(buf, sizeof buf, "0xFF%02X", m);
    return buf;
}

struct Huffman {
    bool defined = false;
    int32_t maxcode[18];
    int32_t valoffset[18];
    uint8_t vals[256];
    // 9-bit lookahead: (length << 8) | symbol, length 0 when longer.
    uint16_t look[1 << 9];

    void build(const uint8_t* counts, const uint8_t* symbols, int nsym) {
        std::memcpy(vals, symbols, nsym);
        int huffsize[257], huffcode[257];
        int p = 0;
        for (int l = 1; l <= 16; l++)
            for (int i = 0; i < counts[l - 1]; i++) huffsize[p++] = l;
        huffsize[p] = 0;
        int code = 0, si = huffsize[0];
        p = 0;
        while (huffsize[p]) {
            while (huffsize[p] == si) huffcode[p++] = code++;
            if (code >= (1 << si)) throw JpegError("bad Huffman table (DHT)");
            code <<= 1;
            si++;
        }
        p = 0;
        for (int l = 1; l <= 16; l++) {
            if (counts[l - 1]) {
                valoffset[l] = p - huffcode[p];
                p += counts[l - 1];
                maxcode[l] = huffcode[p - 1];
            } else {
                maxcode[l] = -1;
            }
        }
        valoffset[17] = 0;
        maxcode[17] = 0x7FFFFFFF;
        std::memset(look, 0, sizeof look);
        p = 0;
        for (int l = 1; l <= 9; l++) {
            for (int i = 0; i < counts[l - 1]; i++, p++) {
                int lookbits = huffcode[p] << (9 - l);
                for (int c = 0; c < (1 << (9 - l)); c++)
                    look[lookbits + c] = static_cast<uint16_t>((l << 8) | vals[p]);
            }
        }
        defined = true;
    }
};

// Entropy-coded data with libjpeg's byte rules: 0xFF 0x00 is a 0xFF datum,
// runs of 0xFF fill bytes are skipped, and a marker ends the data: zeros
// are fed past it. Running off the end of the file is truncation.
struct BitReader {
    const uint8_t* d;
    size_t n;
    size_t pos;
    uint64_t acc = 0;  // left-aligned
    int cnt = 0;
    int pad = 0;        // zero bits fed past a marker, at the bottom of acc
    int marker = -1;    // marker code that ended the data
    size_t marker_end = 0;  // byte after the marker code
    bool eof = false;

    void fill() {
        while (cnt <= 56) {
            uint32_t b = 0;
            if (marker < 0 && !eof) {
                if (pos >= n) {
                    eof = true;
                } else if (d[pos] != 0xFF) {
                    b = d[pos++];
                } else {
                    size_t q = pos + 1;
                    while (q < n && d[q] == 0xFF) q++;
                    if (q >= n) {
                        eof = true;
                    } else if (d[q] == 0x00) {
                        b = 0xFF;
                        pos = q + 1;
                    } else {
                        marker = d[q];
                        marker_end = q + 1;
                        pos = q;
                    }
                }
            }
            if (marker >= 0 || eof) pad += 8;
            acc |= static_cast<uint64_t>(b) << (56 - cnt);
            cnt += 8;
        }
    }

    void consume(int k) {
        acc <<= k;
        cnt -= k;
        if (cnt < pad) {
            if (eof && marker < 0) throw JpegError("truncated file: the entropy-coded data ends early");
            pad = cnt;
        }
    }

    int bits(int k) {
        if (k == 0) return 0;
        if (cnt < k) fill();
        int v = static_cast<int>(acc >> (64 - k));
        consume(k);
        return v;
    }

    int decode(const Huffman& h) {
        if (cnt < 16) fill();
        int look = h.look[acc >> (64 - 9)];
        if (look >> 8) {
            consume(look >> 8);
            return look & 0xFF;
        }
        int l = 10;
        int32_t code = static_cast<int32_t>(acc >> (64 - l));
        while (l <= 16 && code > h.maxcode[l]) {
            l++;
            code = static_cast<int32_t>(acc >> (64 - l));
        }
        if (l > 16) {  // libjpeg: warn, return symbol 0
            consume(16);
            return 0;
        }
        consume(l);
        return h.vals[(code + h.valoffset[l]) & 0xFF];
    }

    void reset_bits() {
        acc = 0;
        cnt = 0;
        pad = 0;
    }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v + (-1 << s) + 1 : v; }

struct Component {
    int id, h, v, tq;
    int bw, bh;      // coefficient blocks allocated (MCU-padded)
    int cw, ch;      // downsampled size (libjpeg's downsampled_width/height)
    int wib, hib;    // blocks holding the component's samples
    std::vector<int16_t> coef;
    uint16_t qt[64];
    bool qt_latched = false;
    int dc_pred = 0;
    int dc_tbl = 0, ac_tbl = 0;
    int16_t* block(int by, int bx) { return &coef[(static_cast<size_t>(by) * bw + bx) * 64]; }
};

// libjpeg-turbo's jpeg_idct_islow (jidctint.c) with its range limit.
using jlong = int64_t;  // libjpeg-turbo's JLONG on 64-bit hosts
const int CONST_BITS = 13, PASS1_BITS = 2;
const jlong FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
            FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
            FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
            FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int descale(jlong x, int n) { return static_cast<int>((x + (jlong{1} << (n - 1))) >> n); }

struct RangeLimit {
    uint8_t t[1024];  // post-IDCT table, indexed by value & 1023
    RangeLimit() {
        for (int i = 0; i < 1024; i++) {
            int v = i < 512 ? i : i - 1024;  // value - 128, wrapped as libjpeg's
            int s = v + 128;
            t[i] = static_cast<uint8_t>(s < 0 ? 0 : (s > 255 ? 255 : s));
        }
    }
};
const RangeLimit kRange;

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
    int ws[64];
    for (int c = 0; c < 8; c++) {
        const int16_t* ip = in + c;
        const uint16_t* qp = q + c;
        int* wp = ws + c;
        if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
            int dc = (ip[0] * qp[0]) * (1 << PASS1_BITS);
            for (int r = 0; r < 8; r++) wp[r * 8] = dc;
            continue;
        }
        jlong z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
        jlong z1 = (z2 + z3) * FIX_0_541196100;
        jlong tmp2 = z1 + z3 * -FIX_1_847759065;
        jlong tmp3 = z1 + z2 * FIX_0_765366865;
        z2 = ip[0] * qp[0];
        z3 = ip[32] * qp[32];
        jlong tmp0 = (z2 + z3) * (1 << CONST_BITS);
        jlong tmp1 = (z2 - z3) * (1 << CONST_BITS);
        jlong tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = ip[56] * qp[56];
        tmp1 = ip[40] * qp[40];
        tmp2 = ip[24] * qp[24];
        tmp3 = ip[8] * qp[8];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        jlong z4 = tmp1 + tmp3;
        jlong z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 *= FIX_0_298631336;
        tmp1 *= FIX_2_053119869;
        tmp2 *= FIX_3_072711026;
        tmp3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        const int sh = CONST_BITS - PASS1_BITS;
        wp[0] = descale(tmp10 + tmp3, sh);
        wp[56] = descale(tmp10 - tmp3, sh);
        wp[8] = descale(tmp11 + tmp2, sh);
        wp[48] = descale(tmp11 - tmp2, sh);
        wp[16] = descale(tmp12 + tmp1, sh);
        wp[40] = descale(tmp12 - tmp1, sh);
        wp[24] = descale(tmp13 + tmp0, sh);
        wp[32] = descale(tmp13 - tmp0, sh);
    }
    const uint8_t* rl = kRange.t;
    for (int r = 0; r < 8; r++) {
        const int* wp = ws + r * 8;
        uint8_t* op = out + static_cast<size_t>(r) * stride;
        if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
            uint8_t dc = rl[descale(wp[0], PASS1_BITS + 3) & 1023];
            for (int c = 0; c < 8; c++) op[c] = dc;
            continue;
        }
        jlong z2 = wp[2], z3 = wp[6];
        jlong z1 = (z2 + z3) * FIX_0_541196100;
        jlong tmp2 = z1 + z3 * -FIX_1_847759065;
        jlong tmp3 = z1 + z2 * FIX_0_765366865;
        jlong tmp0 = (static_cast<jlong>(wp[0]) + wp[4]) * (1 << CONST_BITS);
        jlong tmp1 = (static_cast<jlong>(wp[0]) - wp[4]) * (1 << CONST_BITS);
        jlong tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = wp[7];
        tmp1 = wp[5];
        tmp2 = wp[3];
        tmp3 = wp[1];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        jlong z4 = tmp1 + tmp3;
        jlong z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 *= FIX_0_298631336;
        tmp1 *= FIX_2_053119869;
        tmp2 *= FIX_3_072711026;
        tmp3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        const int sh = CONST_BITS + PASS1_BITS + 3;
        op[0] = rl[descale(tmp10 + tmp3, sh) & 1023];
        op[7] = rl[descale(tmp10 - tmp3, sh) & 1023];
        op[1] = rl[descale(tmp11 + tmp2, sh) & 1023];
        op[6] = rl[descale(tmp11 - tmp2, sh) & 1023];
        op[2] = rl[descale(tmp12 + tmp1, sh) & 1023];
        op[5] = rl[descale(tmp12 - tmp1, sh) & 1023];
        op[3] = rl[descale(tmp13 + tmp0, sh) & 1023];
        op[4] = rl[descale(tmp13 - tmp0, sh) & 1023];
    }
}

// One component's samples upsampled to the full [H, W] grid, following
// libjpeg-turbo's jdsample.c: h2v1, h1v2 and h2v2 "fancy" (triangle)
// upsampling, box replication for 2x ratios of a component at most 2
// samples wide, rows past the component's height replicating its last
// row and the row above its first being the first.
std::vector<uint8_t> upsample(const std::vector<uint8_t>& plane, int stride, const Component& c,
                              int hmax, int vmax, int W, int H) {
    const int rh = hmax / c.h, rv = vmax / c.v;
    const int cw = c.cw, ch = c.ch;
    std::vector<uint8_t> out(static_cast<size_t>(W) * H);
    auto row = [&](int y) { return &plane[static_cast<size_t>(y < ch ? y : ch - 1) * stride]; };
    // Horizontal pass of one input row into `dst` (2 * cw or cw samples).
    std::vector<uint8_t> wide(static_cast<size_t>(cw) * 2 + 2);
    if (rh == 1 && rv == 1) {
        for (int y = 0; y < H; y++) std::memcpy(&out[static_cast<size_t>(y) * W], row(y), W);
        return out;
    }
    const bool fancy_h = cw > 2;
    if (rv == 1) {  // h2v1
        for (int y = 0; y < H; y++) {
            const uint8_t* in = row(y);
            uint8_t* o = wide.data();
            if (fancy_h) {
                int v = in[0];
                *o++ = static_cast<uint8_t>(v);
                *o++ = static_cast<uint8_t>((v * 3 + in[1] + 2) >> 2);
                for (int x = 1; x < cw - 1; x++) {
                    int t = in[x] * 3;
                    *o++ = static_cast<uint8_t>((t + in[x - 1] + 1) >> 2);
                    *o++ = static_cast<uint8_t>((t + in[x + 1] + 2) >> 2);
                }
                v = in[cw - 1];
                *o++ = static_cast<uint8_t>((v * 3 + in[cw - 2] + 1) >> 2);
                *o++ = static_cast<uint8_t>(v);
            } else {
                for (int x = 0; x < cw; x++) o[2 * x] = o[2 * x + 1] = in[x];
            }
            std::memcpy(&out[static_cast<size_t>(y) * W], wide.data(), W);
        }
        return out;
    }
    if (rh == 1) {  // h1v2 (always fancy)
        for (int y = 0; y < H; y++) {
            int r = y >> 1;
            const uint8_t* in0 = row(r);
            const uint8_t* in1 = (y & 1) ? row(r + 1) : row(r > 0 ? r - 1 : 0);
            int bias = (y & 1) ? 2 : 1;
            uint8_t* o = &out[static_cast<size_t>(y) * W];
            for (int x = 0; x < W; x++) o[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
        }
        return out;
    }
    // h2v2
    for (int y = 0; y < H; y++) {
        int r = y >> 1;
        const uint8_t* in0 = row(r);
        uint8_t* o = wide.data();
        if (!fancy_h) {
            for (int x = 0; x < cw; x++) o[2 * x] = o[2 * x + 1] = in0[x];
        } else {
            const uint8_t* in1 = (y & 1) ? row(r + 1) : row(r > 0 ? r - 1 : 0);
            int thiscol = in0[0] * 3 + in1[0];
            int nextcol = in0[1] * 3 + in1[1];
            *o++ = static_cast<uint8_t>((thiscol * 4 + 8) >> 4);
            *o++ = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
            int lastcol = thiscol;
            thiscol = nextcol;
            for (int x = 2; x < cw; x++) {
                nextcol = in0[x] * 3 + in1[x];
                *o++ = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
                *o++ = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
                lastcol = thiscol;
                thiscol = nextcol;
            }
            *o++ = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
            *o++ = static_cast<uint8_t>((thiscol * 4 + 7) >> 4);
        }
        std::memcpy(&out[static_cast<size_t>(y) * W], wide.data(), W);
    }
    return out;
}

struct Decoder {
    const uint8_t* d;
    size_t n;
    size_t pos = 0;
    int W = 0, H = 0;
    bool progressive = false;
    bool frame = false;
    bool saw_jfif = false, saw_adobe = false;
    int adobe_transform = -1;
    int restart_interval = 0;
    uint16_t qt[4][64];
    bool qt_defined[4] = {false, false, false, false};
    Huffman dc[4], ac[4];
    std::vector<Component> comps;
    int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
    int eobrun = 0;

    Decoder(const uint8_t* data, size_t len) : d(data), n(len) {}

    int u8() {
        if (pos >= n) throw JpegError("truncated file: a marker segment ends early");
        return d[pos++];
    }
    int u16() {
        int a = u8();
        return (a << 8) | u8();
    }

    // The next marker code; garbage bytes before it are skipped, as
    // libjpeg does (with a warning).
    int next_marker() {
        for (;;) {
            while (pos < n && d[pos] != 0xFF) pos++;
            while (pos < n && d[pos] == 0xFF) pos++;
            if (pos >= n) throw JpegError("truncated file: no EOI marker");
            int m = d[pos++];
            if (m != 0) return m;
        }
    }

    void read_sof(int marker) {
        size_t end = pos + u16();
        if (u8() != 8) throw JpegError("sample precision other than 8 bits (12-bit) in " + hex_marker(marker));
        H = u16();
        W = u16();
        int nc = u8();
        if (H == 0) throw JpegError("image height 0 (a DNL marker), which is not supported");
        if (W == 0) throw JpegError("image width 0 in " + hex_marker(marker));
        if (nc != 1 && nc != 3 && nc != 4) throw JpegError(std::to_string(nc) + " components in " + hex_marker(marker));
        comps.resize(nc);
        for (auto& c : comps) {
            c.id = u8();
            int hv = u8();
            c.h = hv >> 4;
            c.v = hv & 15;
            c.tq = u8();
            if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
                throw JpegError("bad component in " + hex_marker(marker));
        }
        pos = end;
        for (auto& c : comps) {
            hmax = std::max(hmax, c.h);
            vmax = std::max(vmax, c.v);
        }
        for (auto& c : comps) {
            if ((hmax / c.h != 1 && hmax / c.h != 2) || hmax % c.h || (vmax / c.v != 1 && vmax / c.v != 2) ||
                vmax % c.v)
                throw JpegError("sampling factors other than 1 or 2 to 1 in " + hex_marker(marker));
        }
        mcux = (W + 8 * hmax - 1) / (8 * hmax);
        mcuy = (H + 8 * vmax - 1) / (8 * vmax);
        for (auto& c : comps) {
            c.bw = mcux * c.h;
            c.bh = mcuy * c.v;
            c.cw = static_cast<int>((static_cast<int64_t>(W) * c.h + hmax - 1) / hmax);
            c.ch = static_cast<int>((static_cast<int64_t>(H) * c.v + vmax - 1) / vmax);
            c.wib = (c.cw + 7) / 8;
            c.hib = (c.ch + 7) / 8;
            c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
        }
        frame = true;
    }

    void read_dqt() {
        size_t end = pos + u16();
        while (pos < end) {
            int pq = u8();
            int t = pq & 15;
            if (t > 3) throw JpegError("bad quantization table id (DQT)");
            for (int i = 0; i < 64; i++) qt[t][kNatural[i]] = static_cast<uint16_t>((pq >> 4) ? u16() : u8());
            qt_defined[t] = true;
        }
        pos = end;
    }

    void read_dht() {
        size_t end = pos + u16();
        while (pos < end) {
            int tc = u8();
            int cls = tc >> 4, t = tc & 15;
            if (cls > 1 || t > 3) throw JpegError("bad Huffman table id (DHT)");
            uint8_t counts[16], syms[256];
            int total = 0;
            for (int i = 0; i < 16; i++) total += counts[i] = static_cast<uint8_t>(u8());
            if (total > 256) throw JpegError("bad Huffman table (DHT)");
            for (int i = 0; i < total; i++) syms[i] = static_cast<uint8_t>(u8());
            (cls ? ac[t] : dc[t]).build(counts, syms, total);
        }
        pos = end;
    }

    void read_app(int marker) {
        size_t len = u16();
        size_t end = pos + len - 2;
        if (end > n) throw JpegError("truncated file: a marker segment ends early");
        if (marker == 0xE0 && len - 2 >= 14 && std::memcmp(d + pos, "JFIF\0", 5) == 0) saw_jfif = true;
        if (marker == 0xEE && len - 2 >= 12 && std::memcmp(d + pos, "Adobe", 5) == 0) {
            saw_adobe = true;
            adobe_transform = d[pos + 11];
        }
        pos = end;
    }

    void skip_segment() {
        size_t len = u16();
        if (pos + len - 2 > n) throw JpegError("truncated file: a marker segment ends early");
        pos += len - 2;
    }

    void decode_block_baseline(BitReader& br, Component& c, int16_t* blk) {
        int s = br.decode(dc[c.dc_tbl]);
        int diff = s ? extend(br.bits(s), s) : 0;
        c.dc_pred += diff;
        blk[0] = static_cast<int16_t>(c.dc_pred);
        const Huffman& t = ac[c.ac_tbl];
        for (int k = 1; k < 64; k++) {
            int rs = br.decode(t);
            int r = rs >> 4;
            s = rs & 15;
            if (s) {
                k += r;
                blk[kNatural[k]] = static_cast<int16_t>(extend(br.bits(s), s));
            } else {
                if (r != 15) break;
                k += 15;
            }
        }
    }

    void decode_dc_first(BitReader& br, Component& c, int16_t* blk, int al) {
        int s = br.decode(dc[c.dc_tbl]);
        int diff = s ? extend(br.bits(s), s) : 0;
        c.dc_pred += diff;
        blk[0] = static_cast<int16_t>(static_cast<int>(static_cast<unsigned>(c.dc_pred) << al));
    }

    void decode_ac_first(BitReader& br, Component& c, int16_t* blk, int ss, int se, int al) {
        if (eobrun > 0) {
            eobrun--;
            return;
        }
        const Huffman& t = ac[c.ac_tbl];
        for (int k = ss; k <= se; k++) {
            int rs = br.decode(t);
            int r = rs >> 4, s = rs & 15;
            if (s) {
                k += r;
                int v = extend(br.bits(s), s);
                blk[kNatural[k]] = static_cast<int16_t>(static_cast<int>(static_cast<unsigned>(v) << al));
            } else if (r == 15) {
                k += 15;
            } else {
                eobrun = 1 << r;
                if (r) eobrun += br.bits(r);
                eobrun--;
                break;
            }
        }
    }

    void decode_ac_refine(BitReader& br, Component& c, int16_t* blk, int ss, int se, int al) {
        const int p1 = 1 << al, m1 = -1 * (1 << al);
        int k = ss;
        if (eobrun == 0) {
            const Huffman& t = ac[c.ac_tbl];
            for (; k <= se; k++) {
                int rs = br.decode(t);
                int r = rs >> 4, s = rs & 15;
                if (s) {
                    s = br.bits(1) ? p1 : m1;
                } else if (r != 15) {
                    eobrun = 1 << r;
                    if (r) eobrun += br.bits(r);
                    break;
                }
                do {
                    int16_t* coef = blk + kNatural[k];
                    if (*coef != 0) {
                        if (br.bits(1) && (*coef & p1) == 0)
                            *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
                    } else {
                        if (--r < 0) break;
                    }
                    k++;
                } while (k <= se);
                if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
            }
        }
        if (eobrun > 0) {
            for (; k <= se; k++) {
                int16_t* coef = blk + kNatural[k];
                if (*coef != 0 && br.bits(1) && (*coef & p1) == 0)
                    *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
            }
            eobrun--;
        }
    }

    void read_sos() {
        if (!frame) throw JpegError("SOS before a frame header");
        size_t end = pos + u16();
        int ns = u8();
        if (ns < 1 || ns > 4) throw JpegError("bad component count in SOS");
        std::vector<Component*> sc;
        for (int i = 0; i < ns; i++) {
            int id = u8(), tt = u8();
            Component* found = nullptr;
            for (auto& c : comps)
                if (c.id == id) found = &c;
            if (!found) throw JpegError("SOS names an unknown component");
            found->dc_tbl = tt >> 4;
            found->ac_tbl = tt & 15;
            if (found->dc_tbl > 3 || found->ac_tbl > 3) throw JpegError("bad table id in SOS");
            sc.push_back(found);
        }
        if (ns > 1) {
            int blocks = 0;
            for (Component* c : sc) blocks += c->h * c->v;
            if (blocks > 10) throw JpegError("more than 10 blocks in an interleaved MCU (SOS)");
        }
        int ss = u8(), se = u8(), a = u8();
        int ah = a >> 4, al = a & 15;
        pos = end;
        if (progressive) {
            bool dc_scan = ss == 0;
            if ((dc_scan && se != 0) || (!dc_scan && (se < ss || se > 63 || ns != 1)) || al > 13)
                throw JpegError("bad progression parameters in SOS");
        } else if (ss != 0 || se != 63 || ah != 0 || al != 0) {
            throw JpegError("bad spectral selection in a sequential SOS");
        }
        for (Component* c : sc) {
            if (!c->qt_latched) {  // libjpeg latches each table at its component's first scan
                if (!qt_defined[c->tq]) throw JpegError("a component's quantization table is not defined");
                std::memcpy(c->qt, qt[c->tq], sizeof c->qt);
                c->qt_latched = true;
            }
            bool need_dc = !progressive || ss == 0;
            bool need_ac = !progressive || ss > 0;
            if ((need_dc && (!progressive || ah == 0) && !dc[c->dc_tbl].defined) ||
                (need_ac && !ac[c->ac_tbl].defined))
                throw JpegError("a scan uses an undefined Huffman table");
            c->dc_pred = 0;
        }
        eobrun = 0;

        BitReader br{d, n, pos};
        // MCU geometry: interleaved scans cover the MCU grid, a single
        // component's scan its own blocks one at a time.
        int mcus_x, mcus_y;
        if (ns == 1) {
            mcus_x = sc[0]->wib;
            mcus_y = sc[0]->hib;
        } else {
            mcus_x = mcux;
            mcus_y = mcuy;
        }
        const long total = static_cast<long>(mcus_x) * mcus_y;
        int next_rst = 0;
        for (long m = 0; m < total; m++) {
            if (restart_interval && m > 0 && m % restart_interval == 0) {
                br.reset_bits();
                if (br.marker < 0) {  // find the marker after the data
                    size_t p = br.pos;
                    for (;;) {
                        while (p < n && d[p] != 0xFF) p++;
                        size_t q = p;
                        while (q < n && d[q] == 0xFF) q++;
                        if (q >= n) throw JpegError("truncated file: the entropy-coded data ends early");
                        if (d[q] != 0) {
                            br.marker = d[q];
                            br.marker_end = q + 1;
                            break;
                        }
                        p = q + 1;
                    }
                }
                if (br.marker != 0xD0 + next_rst)
                    throw JpegError("expected RST" + std::to_string(next_rst) + ", found marker " +
                                    hex_marker(br.marker));
                br.pos = br.marker_end;
                br.marker = -1;
                br.eof = false;
                next_rst = (next_rst + 1) & 7;
                for (Component* c : sc) c->dc_pred = 0;
                eobrun = 0;
            }
            int my = static_cast<int>(m / mcus_x), mx = static_cast<int>(m % mcus_x);
            for (Component* c : sc) {
                int nh = ns == 1 ? 1 : c->h, nv = ns == 1 ? 1 : c->v;
                for (int by = 0; by < nv; by++) {
                    for (int bx = 0; bx < nh; bx++) {
                        int16_t* blk = c->block(my * nv + by, mx * nh + bx);
                        if (!progressive) {
                            decode_block_baseline(br, *c, blk);
                        } else if (ss == 0) {
                            if (ah == 0)
                                decode_dc_first(br, *c, blk, al);
                            else if (br.bits(1))
                                blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
                        } else if (ah == 0) {
                            decode_ac_first(br, *c, blk, ss, se, al);
                        } else {
                            decode_ac_refine(br, *c, blk, ss, se, al);
                        }
                    }
                }
            }
        }
        // Continue at the marker that ended the data (or after the data).
        if (br.marker >= 0) {
            pos = br.marker_end - 2;
        } else {
            pos = br.pos;
        }
    }

    std::vector<uint8_t> decode() {
        if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) throw JpegError("not a JPEG file (no SOI marker)");
        pos = 2;
        bool scanned = false;
        for (;;) {
            int m = next_marker();
            if (m == 0xD9) break;  // EOI
            switch (m) {
                case 0xC0:
                case 0xC1:
                case 0xC2:
                    if (frame) throw JpegError("a second frame header " + hex_marker(m));
                    progressive = m == 0xC2;
                    read_sof(m);
                    break;
                case 0xC3:
                    throw JpegError("lossless JPEG (SOF3, " + hex_marker(m) + ") is not supported");
                case 0xC5: case 0xC6: case 0xC7:
                    throw JpegError("hierarchical JPEG (" + hex_marker(m) + ") is not supported");
                case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
                    throw JpegError("arithmetic-coded JPEG (" + hex_marker(m) + ") is not supported");
                case 0xCC:
                    throw JpegError("arithmetic-coded JPEG (DAC, " + hex_marker(m) + ") is not supported");
                case 0xC4:
                    read_dht();
                    break;
                case 0xDB:
                    read_dqt();
                    break;
                case 0xDD: {
                    size_t end = pos + u16();
                    restart_interval = u16();
                    pos = end;
                    break;
                }
                case 0xDA:
                    read_sos();
                    scanned = true;
                    break;
                case 0xDC:
                    throw JpegError("DNL marker " + hex_marker(m) + " is not supported");
                case 0xD8:
                    throw JpegError("a second SOI marker");
                case 0xD0: case 0xD1: case 0xD2: case 0xD3:
                case 0xD4: case 0xD5: case 0xD6: case 0xD7: case 0x01:
                    break;  // stray RSTn / TEM: no segment
                default:
                    if (m >= 0xE0 && m <= 0xEF)
                        read_app(m);
                    else
                        skip_segment();
            }
        }
        if (!frame || !scanned) throw JpegError("no image data before EOI");
        return render();
    }

    std::vector<uint8_t> render() {
        // libjpeg's default_decompress_parms: JFIF, then Adobe, then the ids.
        bool rgb = false;
        if (comps.size() == 3) {
            if (saw_jfif) {
                rgb = false;
            } else if (saw_adobe) {
                rgb = adobe_transform == 0;
            } else {
                rgb = comps[0].id == 82 && comps[1].id == 71 && comps[2].id == 66;
            }
        }
        std::vector<std::vector<uint8_t>> full;
        for (auto& c : comps) {
            int stride = c.bw * 8;
            std::vector<uint8_t> plane(static_cast<size_t>(stride) * c.bh * 8);
            for (int by = 0; by < c.hib; by++)
                for (int bx = 0; bx < c.wib; bx++)
                    idct_islow(c.block(by, bx), c.qt, &plane[static_cast<size_t>(by) * 8 * stride + bx * 8],
                               stride);
            full.push_back(upsample(plane, stride, c, hmax, vmax, W, H));
        }
        const size_t npix = static_cast<size_t>(W) * H;
        if (comps.size() == 1) return std::move(full[0]);
        std::vector<uint8_t> out(npix);
        const uint8_t* c0 = full[0].data();
        const uint8_t* c1 = full[1].data();
        const uint8_t* c2 = full[2].data();
        auto rgb2l = [](int r, int g, int b) {
            return static_cast<uint8_t>((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16);
        };
        if (rgb) {
            for (size_t i = 0; i < npix; i++) out[i] = rgb2l(c0[i], c1[i], c2[i]);
            return out;
        }
        // jdcolor.c's build_ycc_rgb_table (SCALEBITS 16).
        const int SCALEBITS = 16;
        const int32_t ONE_HALF = 1 << (SCALEBITS - 1);
        auto fix = [](double x) { return static_cast<int32_t>(x * (1L << 16) + 0.5); };
        int cr_r[256], cb_b[256];
        int32_t cr_g[256], cb_g[256];
        for (int i = 0, x = -128; i < 256; i++, x++) {
            cr_r[i] = static_cast<int>((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
            cb_b[i] = static_cast<int>((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
            cr_g[i] = -fix(0.71414) * x;
            cb_g[i] = -fix(0.34414) * x + ONE_HALF;
        }
        auto clamp = [](int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); };
        if (comps.size() == 4) {
            // libjpeg: no Adobe marker or transform 0 is CMYK, any other
            // transform YCCK (ycck_cmyk_convert: C = 255 - R of the YCbCr
            // colour, K as it is). Pillow reads either as "CMYK;I" (every
            // byte inverted), so after it C, M, Y are R, G, B for YCCK and
            // 255 - C, 255 - M, 255 - Y for CMYK, and K is 255 - K. Then
            // its cmyk2rgb (MULDIV255) and rgb2l.
            const bool ycck = saw_adobe && adobe_transform != 0;
            const uint8_t* c3 = full[3].data();
            auto muldiv255 = [](int a, int b) {
                const int t = a * b + 128;
                return ((t >> 8) + t) >> 8;
            };
            for (size_t i = 0; i < npix; i++) {
                int c, m, y;
                if (ycck) {
                    const int luma = c0[i], cb = c1[i], cr = c2[i];
                    c = clamp(luma + cr_r[cr]);
                    m = clamp(luma + static_cast<int>((cb_g[cb] + cr_g[cr]) >> SCALEBITS));
                    y = clamp(luma + cb_b[cb]);
                } else {
                    c = 255 - c0[i];
                    m = 255 - c1[i];
                    y = 255 - c2[i];
                }
                const int nk = c3[i];  // 255 - (255 - K)
                out[i] = rgb2l(clamp(nk - muldiv255(c, nk)), clamp(nk - muldiv255(m, nk)),
                               clamp(nk - muldiv255(y, nk)));
            }
            return out;
        }
        for (size_t i = 0; i < npix; i++) {
            int y = c0[i], cb = c1[i], cr = c2[i];
            int r = clamp(y + cr_r[cr]);
            int g = clamp(y + static_cast<int>((cb_g[cb] + cr_g[cr]) >> SCALEBITS));
            int b = clamp(y + cb_b[cb]);
            out[i] = rgb2l(r, g, b);
        }
        return out;
    }
};

void set_error(char* err, int errlen, const std::string& msg) {
    if (errlen <= 0) return;
    std::strncpy(err, msg.c_str(), static_cast<size_t>(errlen) - 1);
    err[errlen - 1] = '\0';
}

}  // namespace

extern "C" {

// Decode a JPEG to greyscale: on success returns 0, sets *out to a
// malloc'd [h, w] uint8 buffer (free it with codec_free) and *w, *h; on
// failure returns 1 and writes the reason to err.
int codec_jpeg_grey(const uint8_t* data, size_t n, uint8_t** out, int* w, int* h, char* err,
                    int errlen) {
    try {
        Decoder dec(data, n);
        std::vector<uint8_t> px = dec.decode();
        auto* buf = static_cast<uint8_t*>(std::malloc(px.size() ? px.size() : 1));
        if (!buf) throw JpegError("out of memory");
        std::memcpy(buf, px.data(), px.size());
        *out = buf;
        *w = dec.W;
        *h = dec.H;
        return 0;
    } catch (const std::exception& e) {
        set_error(err, errlen, e.what());
        return 1;
    }
}

void codec_free(void* p) { std::free(p); }

// PNG row unfiltering: raw holds h rows of (1 filter byte + stride bytes);
// out receives h * stride bytes. Returns -1, or the first row whose
// filter type is unknown.
int codec_png_unfilter(const uint8_t* raw, int h, int stride, int bpp, uint8_t* out) {
    for (int y = 0; y < h; y++) {
        const uint8_t* in = raw + static_cast<size_t>(y) * (stride + 1);
        int kind = in[0];
        in++;
        uint8_t* cur = out + static_cast<size_t>(y) * stride;
        const uint8_t* up = y ? cur - stride : nullptr;
        switch (kind) {
            case 0:
                std::memcpy(cur, in, stride);
                break;
            case 1:
                for (int x = 0; x < stride; x++) cur[x] = static_cast<uint8_t>(in[x] + (x >= bpp ? cur[x - bpp] : 0));
                break;
            case 2:
                for (int x = 0; x < stride; x++) cur[x] = static_cast<uint8_t>(in[x] + (up ? up[x] : 0));
                break;
            case 3:
                for (int x = 0; x < stride; x++) {
                    int a = x >= bpp ? cur[x - bpp] : 0, b = up ? up[x] : 0;
                    cur[x] = static_cast<uint8_t>(in[x] + ((a + b) >> 1));
                }
                break;
            case 4:
                for (int x = 0; x < stride; x++) {
                    int a = x >= bpp ? cur[x - bpp] : 0, b = up ? up[x] : 0;
                    int c = (up && x >= bpp) ? up[x - bpp] : 0;
                    int pa = std::abs(b - c), pb = std::abs(a - c), pc = std::abs(a + b - 2 * c);
                    int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                    cur[x] = static_cast<uint8_t>(in[x] + pred);
                }
                break;
            default:
                return y;
        }
    }
    return -1;
}

}  // extern "C"
