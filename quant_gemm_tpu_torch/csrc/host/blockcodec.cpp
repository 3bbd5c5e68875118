// blockcodec: native host-side codec for llama.cpp 32-element block formats
// and the K-quant super-blocks.
//
// The port's copy of the JAX package's native/blockcodec.cpp: bulk weight
// conversion at the GGUF boundary (quantize, dequantize, AoS <-> planar
// repack, K-quant decode) is host work, implemented here in C++ for speed
// and exposed to Python via ctypes (quant_gemm_tpu_torch/native.py, which
// builds it with g++ on first use).
//
// Semantics are identical to quant_gemm_tpu_torch/formats/numpy_ref.py:
//   * rounding: nearest-even (nearbyintf under default FP env);
//   * scales stored as IEEE f16 bit patterns (uint16);
//   * q8_1: s = f16(f32(d) * sum(q)), codes clamped to [-127, 127];
//   * planar device layout: byte c of a row holds x[c] (low nibble) and
//     x[c + K/2] (high nibble); q5 high bits: bit (c%8) of byte c/8.
//
// Layouts are row-major [rows, K]; planar outputs [rows, K/2] etc.

#include <cmath>
#ifdef _OPENMP
#include <omp.h>
#endif
#include <cstdint>
#include <cstring>
#include <algorithm>

using std::int8_t;
using std::int64_t;
using std::uint16_t;
using std::uint32_t;
using std::uint8_t;

namespace {

inline uint16_t f16_bits(float x) {
    _Float16 h = (_Float16)x;
    uint16_t b;
    std::memcpy(&b, &h, 2);
    return b;
}

inline float f16_val(uint16_t b) {
    _Float16 h;
    std::memcpy(&h, &b, 2);
    return (float)h;
}

inline float rne(float x) { return nearbyintf(x); }  // round-to-nearest-even

struct Block {
    float amax = 0.f, mn = 0.f, mx = 0.f;
};

inline Block scan(const float* x, int n) {
    Block b;
    b.mn = b.mx = x[0];
    for (int i = 0; i < n; i++) {
        b.amax = std::max(b.amax, std::fabs(x[i]));
        b.mn = std::min(b.mn, x[i]);
        b.mx = std::max(b.mx, x[i]);
    }
    return b;
}

constexpr int QK = 32;

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// quantize: float32 [rows, k] -> planar SoA
// ---------------------------------------------------------------------------

void qgt_quantize_q4_0(const float* x, int64_t rows, int64_t k,
                       uint8_t* packed /*[rows, k/2]*/, uint16_t* d /*[rows, k/32]*/) {
    const int64_t nb = k / QK, kh = k / 2;
    #ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t r = 0; r < rows; r++) {
        const float* row = x + r * k;
        // temp codes in natural order, then planar pack
        for (int64_t b = 0; b < nb; b++) {
            const float* blk = row + b * QK;
            float amax = 0.f;
            for (int i = 0; i < QK; i++) amax = std::max(amax, std::fabs(blk[i]));
            uint16_t db = f16_bits(amax / 7.0f);
            d[r * nb + b] = db;
            float dv = f16_val(db);
            float inv = dv > 0 ? 1.0f / dv : 0.0f;
            for (int i = 0; i < QK; i++) {
                int q = (int)rne(blk[i] * inv);
                q = std::max(-8, std::min(7, q)) + 8;
                int64_t c = b * QK + i;  // natural column
                uint8_t* byte = packed + r * kh + (c < kh ? c : c - kh);
                if (c < kh)
                    *byte = (*byte & 0xF0) | (uint8_t)q;
                else
                    *byte = (*byte & 0x0F) | ((uint8_t)q << 4);
            }
        }
    }
}

void qgt_quantize_q8_0(const float* x, int64_t rows, int64_t k,
                       int8_t* qs /*[rows, k]*/, uint16_t* d) {
    const int64_t nb = k / QK;
    #ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t r = 0; r < rows; r++) {
        for (int64_t b = 0; b < nb; b++) {
            const float* blk = x + r * k + b * QK;
            float amax = 0.f;
            for (int i = 0; i < QK; i++) amax = std::max(amax, std::fabs(blk[i]));
            uint16_t db = f16_bits(amax / 127.0f);
            d[r * nb + b] = db;
            float dv = f16_val(db);
            float inv = dv > 0 ? 1.0f / dv : 0.0f;
            int8_t* out = qs + r * k + b * QK;
            for (int i = 0; i < QK; i++) {
                int q = (int)rne(blk[i] * inv);
                out[i] = (int8_t)std::max(-127, std::min(127, q));
            }
        }
    }
}

void qgt_quantize_q8_1(const float* x, int64_t rows, int64_t k,
                       int8_t* qs, uint16_t* d, uint16_t* s) {
    const int64_t nb = k / QK;
    qgt_quantize_q8_0(x, rows, k, qs, d);
    for (int64_t r = 0; r < rows; r++) {
        for (int64_t b = 0; b < nb; b++) {
            const int8_t* q = qs + r * k + b * QK;
            int sum = 0;
            for (int i = 0; i < QK; i++) sum += q[i];
            s[r * nb + b] = f16_bits(f16_val(d[r * nb + b]) * (float)sum);
        }
    }
}

// ---------------------------------------------------------------------------
// dequantize: planar SoA -> float32
// ---------------------------------------------------------------------------

void qgt_dequantize_q4_0(const uint8_t* packed, const uint16_t* d,
                         int64_t rows, int64_t k, float* out) {
    const int64_t nb = k / QK, kh = k / 2;
    #ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t r = 0; r < rows; r++) {
        for (int64_t c = 0; c < k; c++) {
            uint8_t byte = packed[r * kh + (c < kh ? c : c - kh)];
            int q = (c < kh) ? (byte & 0x0F) : (byte >> 4);
            float dv = f16_val(d[r * nb + c / QK]);
            out[r * k + c] = (float)(q - 8) * dv;
        }
    }
}

void qgt_dequantize_q8_0(const int8_t* qs, const uint16_t* d,
                         int64_t rows, int64_t k, float* out) {
    const int64_t nb = k / QK;
    #ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t r = 0; r < rows; r++)
        for (int64_t c = 0; c < k; c++)
            out[r * k + c] = (float)qs[r * k + c] * f16_val(d[r * nb + c / QK]);
}

// ---------------------------------------------------------------------------
// AoS (llama.cpp / GGUF block bytes) <-> planar SoA, q4_0
//   AoS: per block 18 B = d (f16 LE) + qs[16] (low nibble j = x[j],
//   high nibble j = x[j+16])    (compat/ggml_types.h:62-88)
// ---------------------------------------------------------------------------

void qgt_q4_0_aos_to_planar(const uint8_t* aos /*[rows, nb, 18]*/, int64_t rows,
                            int64_t k, uint8_t* packed, uint16_t* d) {
    const int64_t nb = k / QK, kh = k / 2;
    #ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t r = 0; r < rows; r++) {
        for (int64_t b = 0; b < nb; b++) {
            const uint8_t* blk = aos + (r * nb + b) * 18;
            std::memcpy(&d[r * nb + b], blk, 2);
            for (int j = 0; j < 16; j++) {
                uint8_t lo = blk[2 + j] & 0x0F;        // x[32b + j]
                uint8_t hi = blk[2 + j] >> 4;          // x[32b + 16 + j]
                int64_t c0 = b * QK + j, c1 = b * QK + 16 + j;
                uint8_t* p0 = packed + r * kh + (c0 < kh ? c0 : c0 - kh);
                uint8_t* p1 = packed + r * kh + (c1 < kh ? c1 : c1 - kh);
                if (c0 < kh) *p0 = (*p0 & 0xF0) | lo; else *p0 = (*p0 & 0x0F) | (lo << 4);
                if (c1 < kh) *p1 = (*p1 & 0xF0) | hi; else *p1 = (*p1 & 0x0F) | (hi << 4);
            }
        }
    }
}

void qgt_q4_0_planar_to_aos(const uint8_t* packed, const uint16_t* d,
                            int64_t rows, int64_t k, uint8_t* aos) {
    const int64_t nb = k / QK, kh = k / 2;
    #ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t r = 0; r < rows; r++) {
        for (int64_t b = 0; b < nb; b++) {
            uint8_t* blk = aos + (r * nb + b) * 18;
            std::memcpy(blk, &d[r * nb + b], 2);
            for (int j = 0; j < 16; j++) {
                int64_t c0 = b * QK + j, c1 = b * QK + 16 + j;
                uint8_t b0 = packed[r * kh + (c0 < kh ? c0 : c0 - kh)];
                uint8_t b1 = packed[r * kh + (c1 < kh ? c1 : c1 - kh)];
                uint8_t lo = (c0 < kh) ? (b0 & 0x0F) : (b0 >> 4);
                uint8_t hi = (c1 < kh) ? (b1 & 0x0F) : (b1 >> 4);
                blk[2 + j] = lo | (hi << 4);
            }
        }
    }
}

// ---------------------------------------------------------------------------
// K-quant super-blocks (QK_K = 256): AoS (llama.cpp bytes) -> planar SoA.
// The model-LOAD direction — real Q4_K_M / Q5_K_M GGUF checkpoints are
// multi-GB of these blocks and the decode is pure byte shuffling, so it
// runs here at memcpy-class speed instead of through numpy fancy indexing.
// Layouts per compat-with-llama.cpp (see formats/kquants.py):
//   block_q4_K (144 B): d f16 | dmin f16 | scales[12] | qs[128]
//   block_q5_K (176 B): d f16 | dmin f16 | scales[12] | qh[32] | qs[128]
// scales[12] packs eight 6-bit (ls, lm) pairs (get_scale_min_k4); qs is
// per-64-chunk interleaved (byte l of chunk c = elems 64c+l / 64c+32+l);
// q5 qh byte l carries bits 2c / 2c+1 for those two elements.
// Planar outputs follow the project layout: packed byte c of a row holds
// codes c (lo nibble) and c+K/2 (hi); qh bit c%8 of byte c/8 is elem c.
// ---------------------------------------------------------------------------

}  // extern "C" (templates cannot carry C linkage; reopened below)

namespace {

constexpr int QK_K = 256;

inline void scale_min_k4(const uint8_t* sc, int j, uint8_t* ls, uint8_t* lm) {
    if (j < 4) {
        *ls = sc[j] & 63;
        *lm = sc[j + 4] & 63;
    } else {
        *ls = (sc[j + 4] & 0xF) | ((sc[j - 4] >> 6) << 4);
        *lm = (sc[j + 4] >> 4) | ((sc[j] >> 6) << 4);
    }
}

// OR a 32-element nibble run into the planar row (zero-initialized by the
// caller; every column is written exactly once, so |= needs no mask).
// `get` extracts the 4-bit code from source byte l.  K % 256 == 0 keeps a
// 32-run entirely on one side of the kh split, so the branch hoists out.
template <typename Get>
inline void or_nibble_run(uint8_t* row, int64_t kh, int64_t base,
                          const uint8_t* src, Get get) {
    if (base < kh) {
        uint8_t* p = row + base;
        for (int l = 0; l < 32; l++) p[l] |= get(src[l]);
    } else {
        uint8_t* p = row + (base - kh);
        for (int l = 0; l < 32; l++) p[l] |= (uint8_t)(get(src[l]) << 4);
    }
}

}  // namespace

extern "C" {

void qgt_q4_k_aos_to_planar(const uint8_t* aos /*[rows, nsb, 144]*/,
                            int64_t rows, int64_t k, uint8_t* packed,
                            uint16_t* d, uint16_t* dmin, uint8_t* ls,
                            uint8_t* lm) {
    const int64_t nsb = k / QK_K, kh = k / 2;
    #ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t r = 0; r < rows; r++) {
        uint8_t* prow = packed + r * kh;
        for (int64_t sb = 0; sb < nsb; sb++) {
            const uint8_t* blk = aos + (r * nsb + sb) * 144;
            std::memcpy(&d[r * nsb + sb], blk, 2);
            std::memcpy(&dmin[r * nsb + sb], blk + 2, 2);
            for (int j = 0; j < 8; j++)
                scale_min_k4(blk + 4, j, &ls[(r * nsb + sb) * 8 + j],
                             &lm[(r * nsb + sb) * 8 + j]);
            const uint8_t* qs = blk + 16;
            for (int c = 0; c < 4; c++) {
                int64_t base = sb * QK_K + c * 64;
                or_nibble_run(prow, kh, base, qs + c * 32,
                              [](uint8_t b) -> uint8_t { return b & 0x0F; });
                or_nibble_run(prow, kh, base + 32, qs + c * 32,
                              [](uint8_t b) -> uint8_t { return b >> 4; });
            }
        }
    }
}

void qgt_q5_k_aos_to_planar(const uint8_t* aos /*[rows, nsb, 176]*/,
                            int64_t rows, int64_t k, uint8_t* packed,
                            uint8_t* qh_out, uint16_t* d, uint16_t* dmin,
                            uint8_t* ls, uint8_t* lm) {
    const int64_t nsb = k / QK_K, kh = k / 2, k8 = k / 8;
    #ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t r = 0; r < rows; r++) {
        uint8_t* prow = packed + r * kh;
        uint8_t* hrow = qh_out + r * k8;
        for (int64_t sb = 0; sb < nsb; sb++) {
            const uint8_t* blk = aos + (r * nsb + sb) * 176;
            std::memcpy(&d[r * nsb + sb], blk, 2);
            std::memcpy(&dmin[r * nsb + sb], blk + 2, 2);
            for (int j = 0; j < 8; j++)
                scale_min_k4(blk + 4, j, &ls[(r * nsb + sb) * 8 + j],
                             &lm[(r * nsb + sb) * 8 + j]);
            const uint8_t* qh = blk + 16;
            const uint8_t* qs = blk + 48;
            for (int c = 0; c < 4; c++) {
                int64_t base = sb * QK_K + c * 64;
                or_nibble_run(prow, kh, base, qs + c * 32,
                              [](uint8_t b) -> uint8_t { return b & 0x0F; });
                or_nibble_run(prow, kh, base + 32, qs + c * 32,
                              [](uint8_t b) -> uint8_t { return b >> 4; });
                // 5th bits: the two 32-runs stay byte-aligned (base % 8 ==
                // 0).  Gather bit `shift` of 8 qh bytes into one output
                // byte with the multiply trick: y = (v >> shift) & LSBS has
                // the wanted bits at positions 8i; y * GATHER sums them
                // into bits 56..63 (GATHER bit 56-7i per i, carry-free).
                constexpr uint64_t LSBS = 0x0101010101010101ULL;
                constexpr uint64_t GATHER = 0x0102040810204080ULL;
                for (int half = 0; half < 2; half++) {
                    uint8_t* hb = hrow + (base + half * 32) / 8;
                    const int shift = 2 * c + half;
                    for (int l8 = 0; l8 < 4; l8++) {
                        uint64_t v;
                        std::memcpy(&v, qh + l8 * 8, 8);
                        hb[l8] |= (uint8_t)((((v >> shift) & LSBS) * GATHER)
                                            >> 56);
                    }
                }
            }
        }
    }
}

void qgt_q6_k_aos_to_soa(const uint8_t* aos /*[rows, nsb, 210]*/,
                         int64_t rows, int64_t k, uint16_t* d, int8_t* sc,
                         int8_t* qs) {
    // block_q6_K -> the serving SoA (formats/kquants.Q6_KTensor): f16 d per
    // super-block, per-16 int8 sub-scales, and the SHIFTED codes q-32 as
    // int8 (dequantize_row_q6_K's ql/qh segment structure) — the model-load
    // hot path for Q4_K_M files (q6_K output.weight + attn_v tensors).
    const int64_t nsb = k / QK_K;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t r = 0; r < rows; r++) {
        int8_t* qrow = qs + r * k;
        for (int64_t sb = 0; sb < nsb; sb++) {
            const uint8_t* blk = aos + (r * nsb + sb) * 210;
            const uint8_t* ql = blk;        // 128 B low nibbles
            const uint8_t* qh = blk + 128;  // 64 B high bit-pairs
            std::memcpy(sc + (r * nsb + sb) * 16, blk + 192, 16);
            std::memcpy(&d[r * nsb + sb], blk + 208, 2);
            int8_t* q = qrow + sb * QK_K;
            for (int half = 0; half < 2; half++) {
                const uint8_t* lql = ql + half * 64;
                const uint8_t* lqh = qh + half * 32;
                int base = half * 128;
                for (int l = 0; l < 32; l++) {
                    const uint8_t h = lqh[l];
                    q[base + l] =
                        (int8_t)(((lql[l] & 0xF) | ((h & 3) << 4)) - 32);
                    q[base + 32 + l] =
                        (int8_t)(((lql[32 + l] & 0xF) | (((h >> 2) & 3) << 4)) - 32);
                    q[base + 64 + l] =
                        (int8_t)(((lql[l] >> 4) | (((h >> 4) & 3) << 4)) - 32);
                    q[base + 96 + l] =
                        (int8_t)(((lql[32 + l] >> 4) | (((h >> 6) & 3) << 4)) - 32);
                }
            }
        }
    }
}

void qgt_q2_k_aos_to_soa(const uint8_t* aos /*[rows, nsb, 84]*/,
                         int64_t rows, int64_t k, uint16_t* d,
                         uint16_t* dmin, uint8_t* sc, uint8_t* mn,
                         int8_t* qs_out) {
    // block_q2_K -> Q2_KTensor: element e of a super-block lives in qs
    // byte (e/128)*32 + e%32 at bit 2*((e%128)/32); per-16 4-bit
    // scale/min pairs share one byte (lo=scale, hi=min).
    const int64_t nsb = k / QK_K;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t r = 0; r < rows; r++) {
        for (int64_t sb = 0; sb < nsb; sb++) {
            const uint8_t* blk = aos + (r * nsb + sb) * 84;
            const uint8_t* scales = blk;
            const uint8_t* qsb = blk + 16;
            std::memcpy(&d[r * nsb + sb], blk + 80, 2);
            std::memcpy(&dmin[r * nsb + sb], blk + 82, 2);
            for (int j = 0; j < 16; j++) {
                sc[(r * nsb + sb) * 16 + j] = scales[j] & 0xF;
                mn[(r * nsb + sb) * 16 + j] = scales[j] >> 4;
            }
            int8_t* q = qs_out + r * k + sb * QK_K;
            for (int half = 0; half < 2; half++)
                for (int g = 0; g < 4; g++)
                    for (int l = 0; l < 32; l++)
                        q[half * 128 + g * 32 + l] =
                            (int8_t)((qsb[half * 32 + l] >> (2 * g)) & 3);
        }
    }
}

void qgt_q3_k_aos_to_soa(const uint8_t* aos /*[rows, nsb, 110]*/,
                         int64_t rows, int64_t k, uint16_t* d, int8_t* sc,
                         int8_t* qs_out) {
    // block_q3_K -> Q3_KTensor: 2-bit codes as q2_K plus a 256-bit hmask
    // (bit e/32 of byte e%32); SHIFTED codes q2 - (hbit ? 0 : 4) stored
    // int8, 6-bit scales unpacked per llama.cpp kmask scheme minus 32.
    const int64_t nsb = k / QK_K;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t r = 0; r < rows; r++) {
        for (int64_t sb = 0; sb < nsb; sb++) {
            const uint8_t* blk = aos + (r * nsb + sb) * 110;
            const uint8_t* hmask = blk;
            const uint8_t* qsb = blk + 32;
            const uint8_t* s12 = blk + 96;
            std::memcpy(&d[r * nsb + sb], blk + 108, 2);
            int8_t* scp = sc + (r * nsb + sb) * 16;
            for (int i = 0; i < 4; i++) {
                scp[i] = (int8_t)(((s12[i] & 0xF) | ((s12[8 + i] & 3) << 4)) - 32);
                scp[4 + i] = (int8_t)(((s12[4 + i] & 0xF)
                                       | (((s12[8 + i] >> 2) & 3) << 4)) - 32);
                scp[8 + i] = (int8_t)(((s12[i] >> 4)
                                       | (((s12[8 + i] >> 4) & 3) << 4)) - 32);
                scp[12 + i] = (int8_t)(((s12[4 + i] >> 4)
                                        | (((s12[8 + i] >> 6) & 3) << 4)) - 32);
            }
            int8_t* q = qs_out + r * k + sb * QK_K;
            for (int half = 0; half < 2; half++)
                for (int g = 0; g < 4; g++)
                    for (int l = 0; l < 32; l++) {
                        int q2 = (qsb[half * 32 + l] >> (2 * g)) & 3;
                        int hbit = (hmask[l] >> (half * 4 + g)) & 1;
                        q[half * 128 + g * 32 + l] =
                            (int8_t)(q2 - (hbit ? 0 : 4));
                    }
        }
    }
}

int qgt_version(void) { return 4; }

}  // extern "C"
