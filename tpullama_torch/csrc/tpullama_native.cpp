// Native (C++) host library of the port's loader: threaded GGUF block
// dequantization and planar repacking (the host-side hot path of model
// loading). A copy of native/tpullama_native.cpp.
//
// Host code, not a kernel of the card: tpullama_torch/native.py builds it
// with `g++ -O3 -fopenmp -shared -fPIC` into tpullama_torch/csrc/build/ and
// binds its plain C ABI with ctypes. It implements the block codecs of llama.cpp's
// ggml/src/ggml-quants.c (dequantize_row_*) and writes the planar layout of
// tpullama_torch/ops/qweights.py (global-stripe sub-byte fields,
// group-transposed element order, exact f32 effective scale/min planes).
//
// Numerics: fp16 decode is bit-exact IEEE half->float; effective scales
// are computed in f32 exactly as ops/qweights.py does (d * sc products of
// fp16-derived f32 and <=6-bit ints are exact in f32).

#include <cstdint>
#include <cstring>
#include <cmath>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// ggml type ids (subset)
enum {
    T_F32 = 0, T_F16 = 1, T_Q4_0 = 2, T_Q4_1 = 3, T_Q5_0 = 6, T_Q5_1 = 7,
    T_Q8_0 = 8, T_Q2_K = 10, T_Q3_K = 11, T_Q4_K = 12, T_Q5_K = 13,
    T_Q6_K = 14, T_BF16 = 30, T_MXFP4 = 39,
};

static inline float fp16_to_f32(uint16_t h) {
    uint32_t sign = (uint32_t)(h & 0x8000) << 16;
    uint32_t exp  = (h >> 10) & 0x1F;
    uint32_t man  = h & 0x3FF;
    uint32_t bits;
    if (exp == 0) {
        if (man == 0) {
            bits = sign;
        } else {
            // subnormal: normalize
            int e = -1;
            do { man <<= 1; e++; } while (!(man & 0x400));
            man &= 0x3FF;
            bits = sign | ((uint32_t)(127 - 15 - e) << 23) | (man << 13);
        }
    } else if (exp == 31) {
        bits = sign | 0x7F800000u | (man << 13);
    } else {
        bits = sign | ((exp + 112) << 23) | (man << 13);
    }
    float f;
    std::memcpy(&f, &bits, 4);
    return f;
}

static inline float e8m0_half(uint8_t e) {
    uint32_t bits;
    if (e == 0)      bits = 0x00200000u;       // 2^-128 subnormal
    else if (e == 1) bits = 0x00400000u;       // 2^-127 subnormal
    else             bits = (uint32_t)(e - 1) << 23;
    float f;
    std::memcpy(&f, &bits, 4);
    return f;
}

static const int8_t KV_MXFP4[16] = {0,1,2,3,4,6,8,12,0,-1,-2,-3,-4,-6,-8,-12};

static inline void get_scale_min_k4(int j, const uint8_t * q, uint8_t * d, uint8_t * m) {
    if (j < 4) {
        *d = q[j] & 63; *m = q[j + 4] & 63;
    } else {
        *d = (q[j+4] & 0xF) | ((q[j-4] >> 6) << 4);
        *m = (q[j+4] >>  4) | ((q[j-0] >> 6) << 4);
    }
}

// ---------------------------------------------------------------------
// per-block dequantization into a 256/32-element buffer (element order)
// ---------------------------------------------------------------------

static void deq_block_q4_0(const uint8_t * b, float * y) {
    const float d = fp16_to_f32(*(const uint16_t *)b);
    const uint8_t * qs = b + 2;
    for (int j = 0; j < 16; ++j) {
        y[j]      = d * (float)((qs[j] & 0xF) - 8);
        y[j + 16] = d * (float)((qs[j] >> 4) - 8);
    }
}

static void deq_block_q4_1(const uint8_t * b, float * y) {
    const float d = fp16_to_f32(*(const uint16_t *)b);
    const float m = fp16_to_f32(*(const uint16_t *)(b + 2));
    const uint8_t * qs = b + 4;
    for (int j = 0; j < 16; ++j) {
        y[j]      = d * (float)(qs[j] & 0xF) + m;
        y[j + 16] = d * (float)(qs[j] >> 4) + m;
    }
}

static void deq_block_q5_0(const uint8_t * b, float * y) {
    const float d = fp16_to_f32(*(const uint16_t *)b);
    uint32_t qh; std::memcpy(&qh, b + 2, 4);
    const uint8_t * qs = b + 6;
    for (int j = 0; j < 16; ++j) {
        const int xh0 = ((qh >> j) << 4) & 0x10;
        const int xh1 = (qh >> (j + 12)) & 0x10;
        y[j]      = d * (float)(((qs[j] & 0xF) | xh0) - 16);
        y[j + 16] = d * (float)(((qs[j] >> 4) | xh1) - 16);
    }
}

static void deq_block_q5_1(const uint8_t * b, float * y) {
    const float d = fp16_to_f32(*(const uint16_t *)b);
    const float m = fp16_to_f32(*(const uint16_t *)(b + 2));
    uint32_t qh; std::memcpy(&qh, b + 4, 4);
    const uint8_t * qs = b + 8;
    for (int j = 0; j < 16; ++j) {
        const int xh0 = ((qh >> j) << 4) & 0x10;
        const int xh1 = (qh >> (j + 12)) & 0x10;
        y[j]      = d * (float)((qs[j] & 0xF) | xh0) + m;
        y[j + 16] = d * (float)((qs[j] >> 4) | xh1) + m;
    }
}

static void deq_block_q8_0(const uint8_t * b, float * y) {
    const float d = fp16_to_f32(*(const uint16_t *)b);
    const int8_t * qs = (const int8_t *)(b + 2);
    for (int j = 0; j < 32; ++j) y[j] = d * (float)qs[j];
}

static void deq_block_mxfp4(const uint8_t * b, float * y) {
    const float d = e8m0_half(b[0]);
    const uint8_t * qs = b + 1;
    for (int j = 0; j < 16; ++j) {
        y[j]      = d * (float)KV_MXFP4[qs[j] & 0xF];
        y[j + 16] = d * (float)KV_MXFP4[qs[j] >> 4];
    }
}

static void deq_block_q2_K(const uint8_t * b, float * y) {
    const uint8_t * sc = b;
    const uint8_t * qs = b + 16;
    const float d    = fp16_to_f32(*(const uint16_t *)(b + 80));
    const float dmin = fp16_to_f32(*(const uint16_t *)(b + 82));
    int is = 0;
    const uint8_t * q = qs;
    float * out = y;
    for (int n = 0; n < 256; n += 128) {
        int shift = 0;
        for (int j = 0; j < 4; ++j) {
            uint8_t s = sc[is++];
            float dl = d * (s & 0xF), ml = dmin * (s >> 4);
            for (int l = 0; l < 16; ++l) *out++ = dl * ((q[l] >> shift) & 3) - ml;
            s = sc[is++];
            dl = d * (s & 0xF); ml = dmin * (s >> 4);
            for (int l = 0; l < 16; ++l) *out++ = dl * ((q[l+16] >> shift) & 3) - ml;
            shift += 2;
        }
        q += 32;
    }
}

static void deq_block_q3_K(const uint8_t * b, float * y) {
    const uint8_t * hm = b;
    const uint8_t * qs = b + 32;
    const uint8_t * scb = b + 96;
    const float d_all = fp16_to_f32(*(const uint16_t *)(b + 108));
    uint32_t aux[4];
    std::memcpy(aux, scb, 12);
    const uint32_t kmask1 = 0x03030303, kmask2 = 0x0F0F0F0F;
    uint32_t tmp = aux[2];
    aux[2] = ((aux[0] >> 4) & kmask2) | (((tmp >> 4) & kmask1) << 4);
    aux[3] = ((aux[1] >> 4) & kmask2) | (((tmp >> 6) & kmask1) << 4);
    aux[0] = (aux[0] & kmask2) | (((tmp >> 0) & kmask1) << 4);
    aux[1] = (aux[1] & kmask2) | (((tmp >> 2) & kmask1) << 4);
    const int8_t * scales = (const int8_t *)aux;
    int is = 0;
    uint8_t m = 1;
    const uint8_t * q = qs;
    float * out = y;
    for (int n = 0; n < 256; n += 128) {
        int shift = 0;
        for (int j = 0; j < 4; ++j) {
            float dl = d_all * (scales[is++] - 32);
            for (int l = 0; l < 16; ++l)
                *out++ = dl * (float)((int)((q[l] >> shift) & 3) - ((hm[l] & m) ? 0 : 4));
            dl = d_all * (scales[is++] - 32);
            for (int l = 0; l < 16; ++l)
                *out++ = dl * (float)((int)((q[l+16] >> shift) & 3) - ((hm[l+16] & m) ? 0 : 4));
            shift += 2;
            m <<= 1;
        }
        q += 32;
    }
}

static void deq_block_q4_K(const uint8_t * b, float * y) {
    const float d    = fp16_to_f32(*(const uint16_t *)b);
    const float dmin = fp16_to_f32(*(const uint16_t *)(b + 2));
    const uint8_t * scales = b + 4;
    const uint8_t * q = b + 16;
    int is = 0;
    for (int j = 0; j < 256; j += 64) {
        uint8_t sc, m;
        get_scale_min_k4(is + 0, scales, &sc, &m);
        const float d1 = d * sc, m1 = dmin * m;
        get_scale_min_k4(is + 1, scales, &sc, &m);
        const float d2 = d * sc, m2 = dmin * m;
        for (int l = 0; l < 32; ++l) *y++ = d1 * (q[l] & 0xF) - m1;
        for (int l = 0; l < 32; ++l) *y++ = d2 * (q[l] >> 4) - m2;
        q += 32; is += 2;
    }
}

static void deq_block_q5_K(const uint8_t * b, float * y) {
    const float d    = fp16_to_f32(*(const uint16_t *)b);
    const float dmin = fp16_to_f32(*(const uint16_t *)(b + 2));
    const uint8_t * scales = b + 4;
    const uint8_t * qh = b + 16;
    const uint8_t * ql = b + 48;
    int is = 0;
    uint8_t u1 = 1, u2 = 2;
    for (int j = 0; j < 256; j += 64) {
        uint8_t sc, m;
        get_scale_min_k4(is + 0, scales, &sc, &m);
        const float d1 = d * sc, m1 = dmin * m;
        get_scale_min_k4(is + 1, scales, &sc, &m);
        const float d2 = d * sc, m2 = dmin * m;
        for (int l = 0; l < 32; ++l) *y++ = d1 * ((ql[l] & 0xF) + ((qh[l] & u1) ? 16 : 0)) - m1;
        for (int l = 0; l < 32; ++l) *y++ = d2 * ((ql[l] >> 4)  + ((qh[l] & u2) ? 16 : 0)) - m2;
        ql += 32; is += 2; u1 <<= 2; u2 <<= 2;
    }
}

static void deq_block_q6_K(const uint8_t * b, float * y) {
    const uint8_t * ql = b;
    const uint8_t * qh = b + 128;
    const int8_t * sc = (const int8_t *)(b + 192);
    const float d = fp16_to_f32(*(const uint16_t *)(b + 208));
    for (int n = 0; n < 256; n += 128) {
        for (int l = 0; l < 32; ++l) {
            const int is = l / 16;
            const int8_t q1 = (int8_t)((ql[l +  0] & 0xF) | (((qh[l] >> 0) & 3) << 4)) - 32;
            const int8_t q2 = (int8_t)((ql[l + 32] & 0xF) | (((qh[l] >> 2) & 3) << 4)) - 32;
            const int8_t q3 = (int8_t)((ql[l +  0] >>  4) | (((qh[l] >> 4) & 3) << 4)) - 32;
            const int8_t q4 = (int8_t)((ql[l + 32] >>  4) | (((qh[l] >> 6) & 3) << 4)) - 32;
            y[l +  0] = d * sc[is + 0] * q1;
            y[l + 32] = d * sc[is + 2] * q2;
            y[l + 64] = d * sc[is + 4] * q3;
            y[l + 96] = d * sc[is + 6] * q4;
        }
        y += 128; ql += 64; qh += 32; sc += 8;
    }
}

struct TypeInfo { int block; int tsize; void (*fn)(const uint8_t *, float *); };

static bool type_info(int type, TypeInfo * ti) {
    switch (type) {
        case T_Q4_0:  *ti = {32, 18, deq_block_q4_0};  return true;
        case T_Q4_1:  *ti = {32, 20, deq_block_q4_1};  return true;
        case T_Q5_0:  *ti = {32, 22, deq_block_q5_0};  return true;
        case T_Q5_1:  *ti = {32, 24, deq_block_q5_1};  return true;
        case T_Q8_0:  *ti = {32, 34, deq_block_q8_0};  return true;
        case T_MXFP4: *ti = {32, 17, deq_block_mxfp4}; return true;
        case T_Q2_K:  *ti = {256, 84, deq_block_q2_K}; return true;
        case T_Q3_K:  *ti = {256, 110, deq_block_q3_K}; return true;
        case T_Q4_K:  *ti = {256, 144, deq_block_q4_K}; return true;
        case T_Q5_K:  *ti = {256, 176, deq_block_q5_K}; return true;
        case T_Q6_K:  *ti = {256, 210, deq_block_q6_K}; return true;
        default: return false;
    }
}

// Dequantize n_elems elements of `type` from raw block bytes, threaded.
int tpn_dequant(int type, const uint8_t * raw, float * out, int64_t n_elems) {
    if (type == T_F32) { std::memcpy(out, raw, n_elems * 4); return 0; }
    if (type == T_F16) {
        const uint16_t * h = (const uint16_t *)raw;
        #pragma omp parallel for schedule(static)
        for (int64_t i = 0; i < n_elems; ++i) out[i] = fp16_to_f32(h[i]);
        return 0;
    }
    if (type == T_BF16) {
        const uint16_t * h = (const uint16_t *)raw;
        #pragma omp parallel for schedule(static)
        for (int64_t i = 0; i < n_elems; ++i) {
            uint32_t bits = (uint32_t)h[i] << 16;
            std::memcpy(&out[i], &bits, 4);
        }
        return 0;
    }
    TypeInfo ti;
    if (!type_info(type, &ti)) return -1;
    if (n_elems % ti.block) return -2;
    const int64_t nb = n_elems / ti.block;
    #pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < nb; ++i) {
        ti.fn(raw + i * ti.tsize, out + i * ti.block);
    }
    return 0;
}

// ---------------------------------------------------------------------
// planar repack (matches tpullama_torch/ops/qweights.py):
//   vals in natural order -> group-transposed order -> stripe-packed
// fields written per type; unused pointers may be null.
// ---------------------------------------------------------------------

// helper: write one row's planar fields from element values + scale/min
struct RowScratch {
    int32_t vals[16384];     // group-permuted quant values
    float   dq[16384];       // dequantized (for q8 path unused)
};

static void stripe_pack_row(const int32_t * vals, int64_t K, int bits, uint8_t * out) {
    const int k = 8 / bits;
    const int64_t Kc = K / k;
    for (int64_t c = 0; c < Kc; ++c) {
        uint8_t byte = 0;
        for (int j = 0; j < k; ++j) {
            byte |= (uint8_t)((vals[j * Kc + c] & ((1 << bits) - 1)) << (bits * j));
        }
        out[c] = byte;
    }
}

// decode one row's quant VALUES (integer codes, element order) + per-group
// f32 scale/min. Returns group size, or 0 on unsupported.
static int row_codes(int type, const uint8_t * rowb, int64_t K,
                     int32_t * vals, float * scale, float * minv) {
    if (type == T_Q8_0) {
        for (int64_t i = 0; i < K / 32; ++i) {
            const uint8_t * b = rowb + i * 34;
            scale[i] = fp16_to_f32(*(const uint16_t *)b);
            const int8_t * qs = (const int8_t *)(b + 2);
            for (int j = 0; j < 32; ++j) vals[i * 32 + j] = qs[j];
            minv[i] = 0.0f;
        }
        return 32;
    }
    if (type == T_Q4_0 || type == T_Q4_1) {
        const int ts = type == T_Q4_0 ? 18 : 20;
        const int off = type == T_Q4_0 ? 2 : 4;
        for (int64_t i = 0; i < K / 32; ++i) {
            const uint8_t * b = rowb + i * ts;
            const float d = fp16_to_f32(*(const uint16_t *)b);
            scale[i] = d;
            minv[i] = type == T_Q4_0 ? 8.0f * d : -fp16_to_f32(*(const uint16_t *)(b + 2));
            const uint8_t * qs = b + off;
            for (int j = 0; j < 16; ++j) {
                vals[i * 32 + j]      = qs[j] & 0xF;
                vals[i * 32 + j + 16] = qs[j] >> 4;
            }
        }
        return 32;
    }
    if (type == T_Q5_0 || type == T_Q5_1) {
        const int ts = type == T_Q5_0 ? 22 : 24;
        const int off = type == T_Q5_0 ? 2 : 4;
        for (int64_t i = 0; i < K / 32; ++i) {
            const uint8_t * b = rowb + i * ts;
            const float d = fp16_to_f32(*(const uint16_t *)b);
            scale[i] = d;
            minv[i] = type == T_Q5_0 ? 16.0f * d : -fp16_to_f32(*(const uint16_t *)(b + 2));
            uint32_t qh; std::memcpy(&qh, b + off, 4);
            const uint8_t * qs = b + off + 4;
            for (int j = 0; j < 16; ++j) {
                vals[i * 32 + j]      = (qs[j] & 0xF) | ((((qh >> j) & 1)) << 4);
                vals[i * 32 + j + 16] = (qs[j] >> 4)  | ((((qh >> (j + 16)) & 1)) << 4);
            }
        }
        return 32;
    }
    if (type == T_MXFP4) {
        for (int64_t i = 0; i < K / 32; ++i) {
            const uint8_t * b = rowb + i * 17;
            scale[i] = e8m0_half(b[0]);
            minv[i] = 0.0f;
            const uint8_t * qs = b + 1;
            for (int j = 0; j < 16; ++j) {
                vals[i * 32 + j]      = qs[j] & 0xF;
                vals[i * 32 + j + 16] = qs[j] >> 4;
            }
        }
        return 32;
    }
    if (type == T_Q4_K || type == T_Q5_K) {
        const int ts = type == T_Q4_K ? 144 : 176;
        for (int64_t i = 0; i < K / 256; ++i) {
            const uint8_t * b = rowb + i * ts;
            const float d    = fp16_to_f32(*(const uint16_t *)b);
            const float dmin = fp16_to_f32(*(const uint16_t *)(b + 2));
            const uint8_t * scb = b + 4;
            const uint8_t * qh = b + 16;
            const uint8_t * ql = b + (type == T_Q4_K ? 16 : 48);
            for (int sb = 0; sb < 8; ++sb) {
                uint8_t sc, m;
                get_scale_min_k4(sb, scb, &sc, &m);
                scale[i * 8 + sb] = d * (float)sc;
                minv[i * 8 + sb]  = dmin * (float)m;
            }
            int32_t * v = vals + i * 256;
            for (int j64 = 0; j64 < 4; ++j64) {
                const uint8_t * q = ql + j64 * 32;
                for (int l = 0; l < 32; ++l) {
                    int lo = q[l] & 0xF, hi = q[l] >> 4;
                    if (type == T_Q5_K) {
                        lo |= ((qh[l] >> (2 * j64)) & 1) << 4;
                        hi |= ((qh[l] >> (2 * j64 + 1)) & 1) << 4;
                    }
                    v[j64 * 64 + l]      = lo;
                    v[j64 * 64 + 32 + l] = hi;
                }
            }
        }
        return 32;
    }
    if (type == T_Q6_K) {
        for (int64_t i = 0; i < K / 256; ++i) {
            const uint8_t * b = rowb + i * 210;
            const uint8_t * ql = b;
            const uint8_t * qh = b + 128;
            const int8_t * sc8 = (const int8_t *)(b + 192);
            const float d = fp16_to_f32(*(const uint16_t *)(b + 208));
            for (int g = 0; g < 16; ++g) {
                scale[i * 16 + g] = d * (float)sc8[g];
                minv[i * 16 + g]  = 32.0f * scale[i * 16 + g];
            }
            int32_t * v = vals + i * 256;
            for (int half = 0; half < 2; ++half) {
                const uint8_t * qlh = ql + half * 64;
                const uint8_t * qhh = qh + half * 32;
                int32_t * vh = v + half * 128;
                for (int l = 0; l < 32; ++l) {
                    vh[l +  0] = (qlh[l]      & 0xF) | (((qhh[l] >> 0) & 3) << 4);
                    vh[l + 32] = (qlh[l + 32] & 0xF) | (((qhh[l] >> 2) & 3) << 4);
                    vh[l + 64] = (qlh[l]      >>  4) | (((qhh[l] >> 4) & 3) << 4);
                    vh[l + 96] = (qlh[l + 32] >>  4) | (((qhh[l] >> 6) & 3) << 4);
                }
            }
        }
        return 16;
    }
    return 0;
}

// Repack a (N, K) tensor. Output pointers may be null when the type does
// not use that field. q4/q2/q1 sizes: N*K/2, N*K/4, N*K/8 bytes.
int tpn_repack(int type, const uint8_t * raw, int64_t N, int64_t K,
               uint8_t * q4, uint8_t * q1, uint8_t * q2, int8_t * q8,
               float * scale, float * minv, int64_t * group_out) {
    TypeInfo ti;
    if (!type_info(type, &ti)) return -1;
    if (K % ti.block || K > 16384) return -2;
    const int64_t row_bytes = (K / ti.block) * ti.tsize;

    int group_probe = 0;
    {   // probe group size with row 0
        int32_t tmpv[16384]; float tmps[1024], tmpm[1024];
        group_probe = row_codes(type, raw, K, tmpv, tmps, tmpm);
        if (!group_probe) return -3;
    }
    const int g = group_probe;
    const int64_t Kg = K / g;
    if (group_out) *group_out = g;

    #pragma omp parallel
    {
        int32_t vals[16384];
        int32_t perm[16384];
        #pragma omp for schedule(static)
        for (int64_t r = 0; r < N; ++r) {
            float * srow = scale + r * Kg;
            float * mrow = minv ? minv + r * Kg : nullptr;
            float mtmp[1024];
            row_codes(type, raw + r * row_bytes, K, vals, srow, mrow ? mrow : mtmp);
            // group transpose: stored p = (e % g) * Kg + e / g ... inverse:
            // stored position p holds element (p % Kg) * g + p / Kg
            for (int64_t p = 0; p < K; ++p) {
                perm[p] = vals[(p % Kg) * g + p / Kg];
            }
            if (type == T_Q8_0) {
                int8_t * out = q8 + r * K;
                for (int64_t p = 0; p < K; ++p) out[p] = (int8_t)perm[p];
                continue;
            }
            if (type == T_Q6_K) {
                int32_t low[16384], high[16384];
                for (int64_t p = 0; p < K; ++p) { low[p] = perm[p] & 0xF; high[p] = perm[p] >> 4; }
                stripe_pack_row(low, K, 4, q4 + r * K / 2);
                stripe_pack_row(high, K, 2, q2 + r * K / 4);
                continue;
            }
            if (type == T_Q5_0 || type == T_Q5_1 || type == T_Q5_K) {
                int32_t low[16384], high[16384];
                for (int64_t p = 0; p < K; ++p) { low[p] = perm[p] & 0xF; high[p] = perm[p] >> 4; }
                stripe_pack_row(low, K, 4, q4 + r * K / 2);
                stripe_pack_row(high, K, 1, q1 + r * K / 8);
                continue;
            }
            // 4-bit single field (q4_0/q4_1/q4_k/mxfp4)
            stripe_pack_row(perm, K, 4, q4 + r * K / 2);
        }
    }
    return 0;
}

int tpn_version(void) { return 1; }

int tpn_num_threads(void) {
#if defined(_OPENMP)
    return omp_get_max_threads();
#else
    return 1;
#endif
}

} // extern "C"
