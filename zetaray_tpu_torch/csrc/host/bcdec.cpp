// BCn block-compression decoder (BC1-BC5, BC6H, BC7), on the host.
//
// ZetaRay ships BC-compressed DDS textures (Tools/BCnCompressglTF). The
// port decodes them once at scene-load time into RGBA8 (BC6H: float RGBA)
// mips, which the texture fetches then sample as linear floats.
//
// Built at first use by zetaray_tpu_torch.native (g++ -O2 -shared -fPIC)
// into the package's _build/ under a name hashed from this file and
// bptc_tables.inc. ABI: plain C, bound with ctypes.

#include <cstdint>
#include <cstring>

namespace {

inline void decode_color_block(const uint8_t* b, uint8_t out[16][4], bool bc1) {
    const uint16_t c0 = uint16_t(b[0] | (b[1] << 8));
    const uint16_t c1 = uint16_t(b[2] | (b[3] << 8));
    uint8_t pal[4][4];
    auto expand = [](uint16_t c, uint8_t* rgb) {
        rgb[0] = uint8_t(((c >> 11) & 31) * 255 / 31);
        rgb[1] = uint8_t(((c >> 5) & 63) * 255 / 63);
        rgb[2] = uint8_t((c & 31) * 255 / 31);
    };
    expand(c0, pal[0]);
    expand(c1, pal[1]);
    pal[0][3] = pal[1][3] = 255;
    if (!bc1 || c0 > c1) {
        for (int k = 0; k < 3; ++k) {
            pal[2][k] = uint8_t((2 * pal[0][k] + pal[1][k]) / 3);
            pal[3][k] = uint8_t((pal[0][k] + 2 * pal[1][k]) / 3);
        }
        pal[2][3] = pal[3][3] = 255;
    } else {
        for (int k = 0; k < 3; ++k) {
            pal[2][k] = uint8_t((pal[0][k] + pal[1][k]) / 2);
            pal[3][k] = 0;
        }
        pal[2][3] = 255;
        pal[3][3] = 0;  // 1-bit transparent black
    }
    const uint32_t idx = uint32_t(b[4]) | (uint32_t(b[5]) << 8) |
                         (uint32_t(b[6]) << 16) | (uint32_t(b[7]) << 24);
    for (int t = 0; t < 16; ++t) {
        const uint32_t s = (idx >> (2 * t)) & 3;
        std::memcpy(out[t], pal[s], 4);
    }
}

inline void decode_alpha_block_bc3(const uint8_t* b, uint8_t out[16]) {
    const uint8_t a0 = b[0], a1 = b[1];
    uint8_t pal[8];
    pal[0] = a0;
    pal[1] = a1;
    if (a0 > a1) {
        for (int k = 1; k < 7; ++k)
            pal[k + 1] = uint8_t(((7 - k) * a0 + k * a1) / 7);
    } else {
        for (int k = 1; k < 5; ++k)
            pal[k + 1] = uint8_t(((5 - k) * a0 + k * a1) / 5);
        pal[6] = 0;
        pal[7] = 255;
    }
    uint64_t bits = 0;
    for (int k = 0; k < 6; ++k) bits |= uint64_t(b[2 + k]) << (8 * k);
    for (int t = 0; t < 16; ++t) out[t] = pal[(bits >> (3 * t)) & 7];
}

// Write a decoded 4x4 block into the output image (RGBA8, row-major).
inline void store_block(uint8_t* img, int w, int h, int bx, int by,
                        const uint8_t px[16][4]) {
    for (int y = 0; y < 4; ++y) {
        const int iy = by * 4 + y;
        if (iy >= h) break;
        for (int x = 0; x < 4; ++x) {
            const int ix = bx * 4 + x;
            if (ix >= w) break;
            std::memcpy(img + 4 * (size_t(iy) * w + ix), px[4 * y + x], 4);
        }
    }
}

}  // namespace

extern "C" {

// blocks: compressed data; w, h: image dims; out: RGBA8 [h * w * 4].
void bc1_decode(const uint8_t* blocks, int w, int h, uint8_t* out) {
    const int bw = (w + 3) / 4, bh = (h + 3) / 4;
    for (int by = 0; by < bh; ++by)
        for (int bx = 0; bx < bw; ++bx) {
            uint8_t px[16][4];
            decode_color_block(blocks + 8 * (size_t(by) * bw + bx), px, true);
            store_block(out, w, h, bx, by, px);
        }
}

void bc2_decode(const uint8_t* blocks, int w, int h, uint8_t* out) {
    const int bw = (w + 3) / 4, bh = (h + 3) / 4;
    for (int by = 0; by < bh; ++by)
        for (int bx = 0; bx < bw; ++bx) {
            const uint8_t* b = blocks + 16 * (size_t(by) * bw + bx);
            uint8_t px[16][4];
            decode_color_block(b + 8, px, false);
            for (int t = 0; t < 16; ++t) {
                const uint8_t nib = (b[t / 2] >> (4 * (t & 1))) & 15;
                px[t][3] = uint8_t(nib * 17);
            }
            store_block(out, w, h, bx, by, px);
        }
}

void bc3_decode(const uint8_t* blocks, int w, int h, uint8_t* out) {
    const int bw = (w + 3) / 4, bh = (h + 3) / 4;
    for (int by = 0; by < bh; ++by)
        for (int bx = 0; bx < bw; ++bx) {
            const uint8_t* b = blocks + 16 * (size_t(by) * bw + bx);
            uint8_t px[16][4];
            uint8_t alpha[16];
            decode_color_block(b + 8, px, false);
            decode_alpha_block_bc3(b, alpha);
            for (int t = 0; t < 16; ++t) px[t][3] = alpha[t];
            store_block(out, w, h, bx, by, px);
        }
}

void bc4_decode(const uint8_t* blocks, int w, int h, uint8_t* out) {
    // single channel -> R, GB = 0, A = 255
    const int bw = (w + 3) / 4, bh = (h + 3) / 4;
    for (int by = 0; by < bh; ++by)
        for (int bx = 0; bx < bw; ++bx) {
            const uint8_t* b = blocks + 8 * (size_t(by) * bw + bx);
            uint8_t r[16];
            decode_alpha_block_bc3(b, r);
            uint8_t px[16][4];
            for (int t = 0; t < 16; ++t) {
                px[t][0] = r[t];
                px[t][1] = 0;
                px[t][2] = 0;
                px[t][3] = 255;
            }
            store_block(out, w, h, bx, by, px);
        }
}

void bc5_decode(const uint8_t* blocks, int w, int h, uint8_t* out) {
    const int bw = (w + 3) / 4, bh = (h + 3) / 4;
    for (int by = 0; by < bh; ++by)
        for (int bx = 0; bx < bw; ++bx) {
            const uint8_t* b = blocks + 16 * (size_t(by) * bw + bx);
            uint8_t r[16], g[16];
            decode_alpha_block_bc3(b, r);
            decode_alpha_block_bc3(b + 8, g);
            uint8_t px[16][4];
            for (int t = 0; t < 16; ++t) {
                px[t][0] = r[t];
                px[t][1] = g[t];
                px[t][2] = 0;
                px[t][3] = 255;
            }
            store_block(out, w, h, bx, by, px);
        }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// BC7 + BC6H (BPTC). Spec constant tables live in bptc_tables.inc; the
// decode logic below is an original implementation of the published BPTC
// decoding algorithm (Khronos Data Format spec / D3D11 functional spec).
// ---------------------------------------------------------------------------

#include "bptc_tables.inc"

namespace {

static const int kW2[4] = {0, 21, 43, 64};
static const int kW3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
static const int kW4[16] = {0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64};

struct BitReader {
    const uint8_t* p;
    int pos = 0;
    explicit BitReader(const uint8_t* block) : p(block) {}
    uint32_t get(int n) {
        uint32_t v = 0;
        for (int i = 0; i < n; ++i, ++pos)
            v |= uint32_t((p[pos >> 3] >> (pos & 7)) & 1) << i;
        return v;
    }
};

inline int bc7_interp(int a, int b, int w) { return (a * (64 - w) + b * w + 32) >> 6; }

// Is pixel t the anchor (one fewer index bit) for its subset?
inline bool bc7_is_anchor(int nsub, int shape, int t) {
    if (t == 0) return true;
    if (nsub == 2) return t == kFix2[shape][1];
    if (nsub == 3) return t == kFix3[shape][1] || t == kFix3[shape][2];
    return false;
}

// BC7 per-mode parameters (spec table): subsets, partition bits, p-bits,
// rotation bits, index-selector bits, index precisions, RGBA endpoint bits.
struct Bc7Mode {
    int nsub, pbits_part, pbits, rot, isel, iprec, iprec2;
    int rb, gb, bb, ab;
    bool p_unique;  // one p-bit per endpoint (else shared per subset)
};
static const Bc7Mode kBc7Modes[8] = {
    {3, 4, 6, 0, 0, 3, 0, 4, 4, 4, 0, true},
    {2, 6, 2, 0, 0, 3, 0, 6, 6, 6, 0, false},
    {3, 6, 0, 0, 0, 2, 0, 5, 5, 5, 0, true},
    {2, 6, 4, 0, 0, 2, 0, 7, 7, 7, 0, true},
    {1, 0, 0, 2, 1, 2, 3, 5, 5, 5, 6, true},
    {1, 0, 0, 2, 0, 2, 2, 7, 7, 7, 8, true},
    {1, 0, 2, 0, 0, 4, 0, 7, 7, 7, 7, true},
    {2, 6, 4, 0, 0, 2, 0, 5, 5, 5, 5, true},
};

inline uint8_t expand8(uint32_t v, int bits) {
    if (bits >= 8) return uint8_t(v);
    v <<= (8 - bits);
    return uint8_t(v | (v >> bits));
}

void bc7_block(const uint8_t* block, uint8_t out[16][4]) {
    BitReader br(block);
    int mode = 0;
    while (mode < 8 && br.get(1) == 0) ++mode;
    if (mode >= 8) {  // reserved: opaque black per spec
        for (int t = 0; t < 16; ++t) { out[t][0] = out[t][1] = out[t][2] = 0; out[t][3] = 255; }
        return;
    }
    const Bc7Mode& m = kBc7Modes[mode];
    const int ne = 2 * m.nsub;  // endpoints

    const int shape = m.pbits_part ? int(br.get(m.pbits_part)) : 0;
    const int rot = m.rot ? int(br.get(m.rot)) : 0;
    const int isel = m.isel ? int(br.get(m.isel)) : 0;

    int ep[6][4] = {};
    for (int e = 0; e < ne; ++e) ep[e][0] = int(br.get(m.rb));
    for (int e = 0; e < ne; ++e) ep[e][1] = int(br.get(m.gb));
    for (int e = 0; e < ne; ++e) ep[e][2] = int(br.get(m.bb));
    if (m.ab) for (int e = 0; e < ne; ++e) ep[e][3] = int(br.get(m.ab));

    int pb[6] = {};
    if (m.pbits) {
        const int np = m.p_unique ? ne : m.nsub;
        for (int i = 0; i < np; ++i) pb[i] = int(br.get(1));
    }

    // dequantize endpoints: append p-bit then expand to 8 bits
    uint8_t pal_ep[6][4];
    for (int e = 0; e < ne; ++e) {
        const int p = m.pbits ? (m.p_unique ? pb[e] : pb[e / 2]) : -1;
        for (int c = 0; c < 4; ++c) {
            int bits = c == 3 ? m.ab : (c == 0 ? m.rb : (c == 1 ? m.gb : m.bb));
            if (bits == 0) { pal_ep[e][c] = 255; continue; }
            uint32_t v = uint32_t(ep[e][c]);
            if (p >= 0) { v = (v << 1) | uint32_t(p); ++bits; }
            pal_ep[e][c] = expand8(v, bits);
        }
        if (!m.ab) pal_ep[e][3] = 255;
    }

    // indices (anchor positions drop the top bit)
    int idx1[16], idx2[16];
    for (int t = 0; t < 16; ++t) {
        const int nb = m.iprec - (bc7_is_anchor(m.nsub, shape, t) ? 1 : 0);
        idx1[t] = int(br.get(nb));
    }
    if (m.iprec2) {
        for (int t = 0; t < 16; ++t) {
            const int nb = m.iprec2 - (t == 0 ? 1 : 0);
            idx2[t] = int(br.get(nb));
        }
    }

    const int* w1 = m.iprec == 2 ? kW2 : (m.iprec == 3 ? kW3 : kW4);
    const int* w2 = m.iprec2 == 2 ? kW2 : kW3;

    for (int t = 0; t < 16; ++t) {
        int sub = 0;
        if (m.nsub == 2) sub = kPart2[shape][t];
        else if (m.nsub == 3) sub = kPart3[shape][t];
        const uint8_t* a = pal_ep[2 * sub];
        const uint8_t* b = pal_ep[2 * sub + 1];
        int px[4];
        if (m.iprec2 == 0) {
            const int w = w1[idx1[t]];
            for (int c = 0; c < 4; ++c) px[c] = bc7_interp(a[c], b[c], w);
        } else {
            // mode 4/5: separate color/alpha index sets; index selector
            // swaps which set drives color vs alpha (mode 4)
            const int wc = (isel ? w2[idx2[t]] : w1[idx1[t]]);
            const int wa = (isel ? w1[idx1[t]] : w2[idx2[t]]);
            for (int c = 0; c < 3; ++c) px[c] = bc7_interp(a[c], b[c], wc);
            px[3] = bc7_interp(a[3], b[3], wa);
        }
        // channel rotation: swap alpha with one color channel
        if (rot == 1) { int tmp = px[0]; px[0] = px[3]; px[3] = tmp; }
        else if (rot == 2) { int tmp = px[1]; px[1] = px[3]; px[3] = tmp; }
        else if (rot == 3) { int tmp = px[2]; px[2] = px[3]; px[3] = tmp; }
        for (int c = 0; c < 4; ++c) out[t][c] = uint8_t(px[c]);
    }
}

// ---------------------------------------------------------------------------
// BC6H (HDR, half-float output as float32)
// ---------------------------------------------------------------------------

struct Bc6Mode {
    int mode_id, partitions;
    bool transformed;
    int iprec;
    int prec[4][3];  // endpoint precisions: [e][rgb]
};
static const Bc6Mode kBc6Modes[14] = {
    {0x00, 1, true, 3, {{10,10,10},{5,5,5},{5,5,5},{5,5,5}}},
    {0x01, 1, true, 3, {{7,7,7},{6,6,6},{6,6,6},{6,6,6}}},
    {0x02, 1, true, 3, {{11,11,11},{5,4,4},{5,4,4},{5,4,4}}},
    {0x06, 1, true, 3, {{11,11,11},{4,5,4},{4,5,4},{4,5,4}}},
    {0x0a, 1, true, 3, {{11,11,11},{4,4,5},{4,4,5},{4,4,5}}},
    {0x0e, 1, true, 3, {{9,9,9},{5,5,5},{5,5,5},{5,5,5}}},
    {0x12, 1, true, 3, {{8,8,8},{6,5,5},{6,5,5},{6,5,5}}},
    {0x16, 1, true, 3, {{8,8,8},{5,6,5},{5,6,5},{5,6,5}}},
    {0x1a, 1, true, 3, {{8,8,8},{5,5,6},{5,5,6},{5,5,6}}},
    {0x1e, 1, false, 3, {{6,6,6},{6,6,6},{6,6,6},{6,6,6}}},
    {0x03, 0, false, 4, {{10,10,10},{10,10,10},{0,0,0},{0,0,0}}},
    {0x07, 0, true, 4, {{11,11,11},{9,9,9},{0,0,0},{0,0,0}}},
    {0x0b, 0, true, 4, {{12,12,12},{8,8,8},{0,0,0},{0,0,0}}},
    {0x0f, 0, true, 4, {{16,16,16},{4,4,4},{0,0,0},{0,0,0}}},
};
static const int kBc6ModeToInfo[32] = {
    0, 1, 2, 10, -1, -1, 3, 11, -1, -1, 4, 12, -1, -1, 5, 13,
    -1, -1, 6, -1, -1, -1, 7, -1, -1, -1, 8, -1, -1, -1, 9, -1,
};

inline int sign_extend(int v, int bits) {
    const int sbit = 1 << (bits - 1);
    return (v & sbit) ? (v | ~(sbit - 1)) : v;
}

inline int bc6_unquantize(int comp, int bits, bool is_signed) {
    if (is_signed) {
        if (bits >= 16) return comp;
        int s = 0;
        if (comp < 0) { s = 1; comp = -comp; }
        int unq;
        if (comp == 0) unq = 0;
        else if (comp >= ((1 << (bits - 1)) - 1)) unq = 0x7FFF;
        else unq = ((comp << 15) + 0x4000) >> (bits - 1);
        return s ? -unq : unq;
    }
    if (bits >= 15) return comp;
    if (comp == 0) return 0;
    if (comp == ((1 << bits) - 1)) return 0xFFFF;
    return ((comp << 16) + 0x8000) >> bits;
}

inline uint16_t bc6_finish(int comp, bool is_signed) {
    // final 31/32 (signed) or 31/64 (unsigned) magnitude scale; the result
    // IS the half-float bit pattern per spec
    if (is_signed) {
        int v = (comp < 0) ? -(((-comp) * 31) >> 5) : (comp * 31) >> 5;
        int sign = 0;
        if (v < 0) { sign = 0x8000; v = -v; }
        return uint16_t(sign | v);
    }
    return uint16_t((comp * 31) >> 6);
}

inline float half_to_float(uint16_t h) {
    const uint32_t sign = uint32_t(h & 0x8000) << 16;
    uint32_t exp = (h >> 10) & 0x1F;
    uint32_t man = h & 0x3FF;
    uint32_t bits;
    if (exp == 0) {
        if (man == 0) bits = sign;
        else {
            // subnormal: normalize
            int e = -1;
            uint32_t mm = man;
            do { ++e; mm <<= 1; } while ((mm & 0x400) == 0);
            bits = sign | uint32_t(127 - 15 - e) << 23 | ((mm & 0x3FF) << 13);
        }
    } else if (exp == 31) {
        bits = sign | 0x7F800000u | (man << 13);
    } else {
        bits = sign | ((exp - 15 + 127) << 23) | (man << 13);
    }
    float f;
    std::memcpy(&f, &bits, 4);
    return f;
}

void bc6h_block(const uint8_t* block, bool is_signed, float out[16][4]) {
    BitReader br(block);
    int mode = int(br.get(2));
    if (mode > 1) mode |= int(br.get(3)) << 2;
    const int info = kBc6ModeToInfo[mode];
    if (info < 0) {  // reserved: opaque black per spec
        for (int t = 0; t < 16; ++t) { out[t][0] = out[t][1] = out[t][2] = 0.0f; out[t][3] = 1.0f; }
        return;
    }
    const Bc6Mode& m = kBc6Modes[info];

    // header bits via the per-mode layout table (fields scattered per spec)
    int ep[4][3] = {};  // [RW RX RY RZ][...] as (e, ch): e0A e0B e1A e1B
    int shape = 0;
    const int header_bits = m.partitions > 0 ? 82 : 65;
    while (br.pos < header_bits) {
        const uint8_t d = kBc6Layout[info][br.pos];
        const int field = d >> 4, bit = d & 15;
        const uint32_t v = br.get(1);
        if (!v) continue;
        if (field == 2) shape |= 1 << bit;            // D (shape)
        else if (field >= 3 && field <= 6) ep[field - 3][0] |= 1 << bit;   // R w/x/y/z
        else if (field >= 7 && field <= 10) ep[field - 7][1] |= 1 << bit;  // G
        else if (field >= 11 && field <= 14) ep[field - 11][2] |= 1 << bit;  // B
        // field 1 (mode) bits were consumed before the loop; NA ignored
    }

    // sign-extension (spec: base endpoint if signed; deltas if transformed)
    for (int c = 0; c < 3; ++c) {
        if (is_signed) ep[0][c] = sign_extend(ep[0][c], m.prec[0][c]);
        const int n_ep = m.partitions > 0 ? 4 : 2;
        for (int e = 1; e < n_ep; ++e)
            if (is_signed || m.transformed)
                ep[e][c] = sign_extend(ep[e][c], m.prec[e][c]);
    }
    // inverse delta transform
    if (m.transformed) {
        const int n_ep = m.partitions > 0 ? 4 : 2;
        for (int c = 0; c < 3; ++c) {
            const int mask = (1 << m.prec[0][c]) - 1;
            for (int e = 1; e < n_ep; ++e) {
                ep[e][c] = (ep[e][c] + ep[0][c]) & mask;
                if (is_signed) ep[e][c] = sign_extend(ep[e][c], m.prec[0][c]);
            }
        }
    }

    const int* wt = m.partitions > 0 ? kW3 : kW4;
    for (int t = 0; t < 16; ++t) {
        int nb = m.iprec;
        if (m.partitions > 0) {
            if (t == 0 || t == kFix2[shape][1]) nb -= 1;
        } else if (t == 0) {
            nb -= 1;
        }
        const int idx = int(br.get(nb));
        const int region = m.partitions > 0 ? kPart2[shape][t] : 0;
        const int w = wt[idx];
        for (int c = 0; c < 3; ++c) {
            const int a = bc6_unquantize(ep[2 * region][c], m.prec[0][c], is_signed);
            const int b = bc6_unquantize(ep[2 * region + 1][c], m.prec[0][c], is_signed);
            const int v = (a * (64 - w) + b * w + 32) >> 6;
            out[t][c] = half_to_float(bc6_finish(v, is_signed));
        }
        out[t][3] = 1.0f;
    }
}

inline void store_block_f(float* img, int w, int h, int bx, int by,
                          const float px[16][4]) {
    for (int y = 0; y < 4; ++y) {
        const int iy = by * 4 + y;
        if (iy >= h) break;
        for (int x = 0; x < 4; ++x) {
            const int ix = bx * 4 + x;
            if (ix >= w) break;
            std::memcpy(img + 4 * (size_t(iy) * w + ix), px[4 * y + x], 16);
        }
    }
}

}  // namespace

extern "C" {

void bc7_decode(const uint8_t* blocks, int w, int h, uint8_t* out) {
    const int bw = (w + 3) / 4, bh = (h + 3) / 4;
    for (int by = 0; by < bh; ++by)
        for (int bx = 0; bx < bw; ++bx) {
            uint8_t px[16][4];
            bc7_block(blocks + 16 * (size_t(by) * bw + bx), px);
            store_block(out, w, h, bx, by, px);
        }
}

// out: RGBA32F [h * w * 4]; is_signed: BC6H_SF16 vs UF16
void bc6h_decode(const uint8_t* blocks, int w, int h, int is_signed, float* out) {
    const int bw = (w + 3) / 4, bh = (h + 3) / 4;
    for (int by = 0; by < bh; ++by)
        for (int bx = 0; bx < bw; ++bx) {
            float px[16][4];
            bc6h_block(blocks + 16 * (size_t(by) * bw + bx), is_signed != 0, px);
            store_block_f(out, w, h, bx, by, px);
        }
}

}  // extern "C"
