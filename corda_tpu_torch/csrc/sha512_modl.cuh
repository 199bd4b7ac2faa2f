// Per-lane challenge scalar of ed25519 verification: h = SHA-512(R || A || M)
// over one padded block, reduced mod L, cut into 64 little-endian 4-bit
// windows. Shared by kernel A (ed25519_challenge.cu) and host_check.cpp;
// kernel A runs the split formulas (ct_sha512_wk_chunk on its schedule
// warp, ct_sha512_rounds_chunk on its rounds warp), host_check both those
// and the one-thread block (ct_sha512_block) they must equal.
//
// SHA-512 runs on native 64-bit words (the card emulates each 64-bit
// rotate/add with two 32-bit instructions; the TPU reference carried the
// same words as explicit (hi, lo) uint32 pairs). The reduction is Barrett
// with m = floor(2^516 / L) over 32-bit limbs with 64-bit products: q^ is at
// most one short of the true quotient, so two conditional subtracts of L
// leave the exact residue. Every step is exact integer arithmetic.
#pragma once

#include "common.cuh"

#define CT_SHA512_K_INIT {                                                  \
    0x428a2f98d728ae22ull, 0x7137449123ef65cdull, 0xb5c0fbcfec4d3b2full,     \
    0xe9b5dba58189dbbcull, 0x3956c25bf348b538ull, 0x59f111f1b605d019ull,     \
    0x923f82a4af194f9bull, 0xab1c5ed5da6d8118ull, 0xd807aa98a3030242ull,     \
    0x12835b0145706fbeull, 0x243185be4ee4b28cull, 0x550c7dc3d5ffb4e2ull,     \
    0x72be5d74f27b896full, 0x80deb1fe3b1696b1ull, 0x9bdc06a725c71235ull,     \
    0xc19bf174cf692694ull, 0xe49b69c19ef14ad2ull, 0xefbe4786384f25e3ull,     \
    0x0fc19dc68b8cd5b5ull, 0x240ca1cc77ac9c65ull, 0x2de92c6f592b0275ull,     \
    0x4a7484aa6ea6e483ull, 0x5cb0a9dcbd41fbd4ull, 0x76f988da831153b5ull,     \
    0x983e5152ee66dfabull, 0xa831c66d2db43210ull, 0xb00327c898fb213full,     \
    0xbf597fc7beef0ee4ull, 0xc6e00bf33da88fc2ull, 0xd5a79147930aa725ull,     \
    0x06ca6351e003826full, 0x142929670a0e6e70ull, 0x27b70a8546d22ffcull,     \
    0x2e1b21385c26c926ull, 0x4d2c6dfc5ac42aedull, 0x53380d139d95b3dfull,     \
    0x650a73548baf63deull, 0x766a0abb3c77b2a8ull, 0x81c2c92e47edaee6ull,     \
    0x92722c851482353bull, 0xa2bfe8a14cf10364ull, 0xa81a664bbc423001ull,     \
    0xc24b8b70d0f89791ull, 0xc76c51a30654be30ull, 0xd192e819d6ef5218ull,     \
    0xd69906245565a910ull, 0xf40e35855771202aull, 0x106aa07032bbd1b8ull,     \
    0x19a4c116b8d2d0c8ull, 0x1e376c085141ab53ull, 0x2748774cdf8eeb99ull,     \
    0x34b0bcb5e19b48a8ull, 0x391c0cb3c5c95a63ull, 0x4ed8aa4ae3418acbull,     \
    0x5b9cca4f7763e373ull, 0x682e6ff3d6b2b8a3ull, 0x748f82ee5defb2fcull,     \
    0x78a5636f43172f60ull, 0x84c87814a1f0ab72ull, 0x8cc702081a6439ecull,     \
    0x90befffa23631e28ull, 0xa4506cebde82bde9ull, 0xbef9a3f7b2c67915ull,     \
    0xc67178f2e372532bull, 0xca273eceea26619cull, 0xd186b8c721c0c207ull,     \
    0xeada7dd6cde0eb1eull, 0xf57d4f7fee6ed178ull, 0x06f067aa72176fbaull,     \
    0x0a637dc5a2c898a6ull, 0x113f9804bef90daeull, 0x1b710b35131c471bull,     \
    0x28db77f523047d84ull, 0x32caab7b40c72493ull, 0x3c9ebe0a15c9bebcull,     \
    0x431d67c49c100d4cull, 0x4cc5d4becb3e42b6ull, 0x597f299cfc657e2aull,     \
    0x5fcb6fab3ad6faecull, 0x6c44198c4a475817ull}

#define CT_SHA512_IV_INIT {                                                 \
    0x6a09e667f3bcc908ull, 0xbb67ae8584caa73bull, 0x3c6ef372fe94f82bull,     \
    0xa54ff53a5f1d36f1ull, 0x510e527fade682d1ull, 0x9b05688c2b3e6c1full,     \
    0x1f83d9abfb41bd6bull, 0x5be0cd19137e2179ull}

// L = 2^252 + 27742317777372353535851937790883648493, 32-bit limbs
#define CT_L_INIT {0x5cf5d3edu, 0x5812631au, 0xa2f79cd6u, 0x14def9deu,       \
                   0x00000000u, 0x00000000u, 0x00000000u, 0x10000000u, 0u}
// m = floor(2^516 / L), 264 bits
#define CT_BARRETT_M_INIT {0xa2c131b3u, 0xd9ce5a30u, 0x86329a7eu,            \
                           0x106215d0u, 0xfffffeb2u, 0xffffffffu,            \
                           0xffffffffu, 0xffffffffu, 0x000000ffu}

CT_HD uint64_t ct_rotr64(uint64_t x, int n) {
    return (x >> n) | (x << (64 - n));
}

CT_HD uint64_t ct_load_be64(const uint8_t* p) {
    uint64_t v = 0;
    for (int i = 0; i < 8; i++) v = (v << 8) | p[i];
    return v;
}

// One SHA-512 compression of `blk` (128 bytes, already padded) from the
// standard initial state; `st` receives the 8 digest words.
CT_HD void ct_sha512_block(const uint8_t* blk, uint64_t st[8]) {
    const uint64_t K[80] = CT_SHA512_K_INIT;
    const uint64_t IV[8] = CT_SHA512_IV_INIT;
    uint64_t w[16];
#pragma unroll
    for (int i = 0; i < 16; i++) w[i] = ct_load_be64(blk + 8 * i);
    uint64_t a = IV[0], b = IV[1], c = IV[2], d = IV[3];
    uint64_t e = IV[4], f = IV[5], g = IV[6], h = IV[7];
#pragma unroll
    for (int t = 0; t < 80; t++) {
        uint64_t wt;
        if (t < 16) {
            wt = w[t];
        } else {
            uint64_t x = w[(t - 15) & 15];
            uint64_t y = w[(t - 2) & 15];
            uint64_t s0 = ct_rotr64(x, 1) ^ ct_rotr64(x, 8) ^ (x >> 7);
            uint64_t s1 = ct_rotr64(y, 19) ^ ct_rotr64(y, 61) ^ (y >> 6);
            wt = w[t & 15] + s0 + w[(t - 7) & 15] + s1;
            w[t & 15] = wt;
        }
        uint64_t S1 = ct_rotr64(e, 14) ^ ct_rotr64(e, 18) ^ ct_rotr64(e, 41);
        uint64_t ch = (e & f) ^ (~e & g);
        uint64_t t1 = h + S1 + ch + K[t] + wt;
        uint64_t S0 = ct_rotr64(a, 28) ^ ct_rotr64(a, 34) ^ ct_rotr64(a, 39);
        uint64_t maj = (a & b) ^ (a & c) ^ (b & c);
        uint64_t t2 = S0 + maj;
        h = g; g = f; f = e; e = d + t1;
        d = c; c = b; b = a; a = t1 + t2;
    }
    st[0] = IV[0] + a; st[1] = IV[1] + b; st[2] = IV[2] + c;
    st[3] = IV[3] + d; st[4] = IV[4] + e; st[5] = IV[5] + f;
    st[6] = IV[6] + g; st[7] = IV[7] + h;
}

// Kernel A's schedule warp, chunk c (0..4): W[t] + K[t] for t = 16c ..
// 16c + 15, K the 80 round constants (a local array: once the caller's
// loop over c is unrolled, immediates). The ring `w` holds the block's 16
// words before chunk 0 and the last 16 schedule words after each chunk.
CT_HD void ct_sha512_wk_chunk(uint64_t wk[16], uint64_t w[16], int c, const uint64_t* K) {
#pragma unroll
    for (int i = 0; i < 16; i++) {
        if (c > 0) {  // t = 16c + i >= 16: w[i] is W[t - 16]
            uint64_t x = w[(i + 1) & 15];
            uint64_t y = w[(i + 14) & 15];
            uint64_t s0 = ct_rotr64(x, 1) ^ ct_rotr64(x, 8) ^ (x >> 7);
            uint64_t s1 = ct_rotr64(y, 19) ^ ct_rotr64(y, 61) ^ (y >> 6);
            w[i] = w[i] + s0 + w[(i + 9) & 15] + s1;
        }
        wk[i] = w[i] + K[16 * c + i];
    }
}

// Kernel A's rounds warp: 16 rounds over the working variables v = (a..h)
// from their 16 sums W[t] + K[t].
CT_HD void ct_sha512_rounds_chunk(uint64_t v[8], const uint64_t wk[16]) {
    uint64_t a = v[0], b = v[1], c = v[2], d = v[3];
    uint64_t e = v[4], f = v[5], g = v[6], h = v[7];
#pragma unroll
    for (int i = 0; i < 16; i++) {
        uint64_t S1 = ct_rotr64(e, 14) ^ ct_rotr64(e, 18) ^ ct_rotr64(e, 41);
        uint64_t ch = (e & f) ^ (~e & g);
        uint64_t t1 = h + S1 + ch + wk[i];
        uint64_t S0 = ct_rotr64(a, 28) ^ ct_rotr64(a, 34) ^ ct_rotr64(a, 39);
        uint64_t maj = (a & b) ^ (a & c) ^ (b & c);
        uint64_t t2 = S0 + maj;
        h = g; g = f; f = e; e = d + t1;
        d = c; c = b; b = a; a = t1 + t2;
    }
    v[0] = a; v[1] = b; v[2] = c; v[3] = d;
    v[4] = e; v[5] = f; v[6] = g; v[7] = h;
}

// Rows a block of kernel A stages as one span: two warp pairs of 32.
#define CT_A_ROWS 64

// Kernel A's word assembly: the 16 big-endian words of the block of row r
// of a staged span of rows (`span`: the span's bytes as little-endian
// 32-bit words, as shared memory holds them). Row r starts at byte 161 r,
// word 40 r + r / 4, at byte r mod 4 of it; each big-endian word is one
// __byte_perm of two neighbouring aligned words. Across a warp's rows the
// word index 40 r + r / 4 + j falls in bank 8 (r mod 4) + r / 4 + j mod 32:
// 32 banks for 32 rows, so the reads are conflict-free.
CT_HD void ct_sha512_row_words(uint64_t w[16], const uint32_t* span, int r) {
    const uint32_t* p = span + ((CT_PACKED_ROW * r) >> 2);
    const uint32_t m = (uint32_t)((CT_PACKED_ROW * r) & 3);
    const uint32_t sel = (m << 12) | ((m + 1) << 8) | ((m + 2) << 4) | (m + 3);
    uint32_t lo = p[0];
#pragma unroll
    for (int i = 0; i < 16; i++) {
        uint32_t mid = p[2 * i + 1];
        uint32_t hi = p[2 * i + 2];  // at most row byte 131
        w[i] = ((uint64_t)ct_byte_perm(lo, mid, sel) << 32) | ct_byte_perm(mid, hi, sel);
        lo = hi;
    }
}

CT_HD uint32_t ct_bswap32(uint32_t v) {
    return (v >> 24) | ((v >> 8) & 0xff00u) | ((v << 8) & 0xff0000u) |
           (v << 24);
}

// (x0..x8) - (y0..y8) mod 2^288; returns the final borrow.
CT_HD uint32_t ct_sub9(uint32_t r[9], const uint32_t x[9],
                       const uint32_t y[9]) {
    uint64_t borrow = 0;
#pragma unroll
    for (int i = 0; i < 9; i++) {
        uint64_t d = (uint64_t)x[i] - y[i] - borrow;
        r[i] = (uint32_t)d;
        borrow = (d >> 63) & 1;
    }
    return (uint32_t)borrow;
}

// The 512-bit digest (read little-endian, RFC 8032's convention) mod L,
// as 8 little-endian 32-bit limbs of a value in [0, L).
CT_HD void ct_digest_mod_l(const uint64_t st[8], uint32_t r_out[8]) {
    const uint32_t Lc[9] = CT_L_INIT;
    const uint32_t M[9] = CT_BARRETT_M_INIT;
    uint32_t x[16];
    // digest byte j is byte j%8 (from the top) of word j/8; limb k holds
    // digest bytes 4k..4k+3 little-endian
#pragma unroll
    for (int k = 0; k < 16; k++) {
        uint64_t word = st[k >> 1];
        uint32_t half = (k & 1) ? (uint32_t)word : (uint32_t)(word >> 32);
        x[k] = ct_bswap32(half);
    }
    // x * m, schoolbook with 64-bit products and row carries
    uint32_t prod[25];
#pragma unroll
    for (int i = 0; i < 25; i++) prod[i] = 0;
#pragma unroll
    for (int i = 0; i < 16; i++) {
        uint64_t carry = 0;
#pragma unroll
        for (int j = 0; j < 9; j++) {
            uint64_t t = (uint64_t)x[i] * M[j] + prod[i + j] + carry;
            prod[i + j] = (uint32_t)t;
            carry = t >> 32;
        }
        prod[i + 9] = (uint32_t)carry;
    }
    // q^ = floor(x * m / 2^516): limbs 16.. shifted right by 4 bits
    uint32_t q[9];
#pragma unroll
    for (int i = 0; i < 9; i++) {
        uint32_t hi = (16 + i + 1 < 25) ? prod[16 + i + 1] : 0u;
        q[i] = (prod[16 + i] >> 4) | (hi << 28);
    }
    // q^ * L, low 288 bits
    uint32_t ql[9];
#pragma unroll
    for (int i = 0; i < 9; i++) ql[i] = 0;
#pragma unroll
    for (int i = 0; i < 9; i++) {
        uint64_t carry = 0;
#pragma unroll
        for (int j = 0; i + j < 9; j++) {
            uint64_t t = (uint64_t)q[i] * Lc[j] + ql[i + j] + carry;
            ql[i + j] = (uint32_t)t;
            carry = t >> 32;
        }
    }
    uint32_t r[9];
    ct_sub9(r, x, ql);  // exact: 0 <= x - q^ L < 2L < 2^288
#pragma unroll
    for (int pass = 0; pass < 2; pass++) {
        uint32_t d[9];
        uint32_t borrow = ct_sub9(d, r, Lc);
        uint32_t keep = 0u - borrow;  // all ones: r < L, keep r
#pragma unroll
        for (int i = 0; i < 9; i++) r[i] = (r[i] & keep) | (d[i] & ~keep);
    }
#pragma unroll
    for (int i = 0; i < 8; i++) r_out[i] = r[i];
}

// The digest → 64 windows of h mod L, window k written at win[k * stride].
CT_HD void ct_challenge_windows(const uint64_t st[8], int32_t* win, int stride) {
    uint32_t r[8];
    ct_digest_mod_l(st, r);
#pragma unroll
    for (int k = 0; k < CT_WINDOWS; k++) {
        win[k * stride] = (int32_t)((r[k >> 3] >> (4 * (k & 7))) & 15u);
    }
}

// One packed row's block → its 64 windows, reading the row byte by byte
// on one thread: the host's reference for kernel A's staged lanes.
CT_HD void ct_challenge_lane(const uint8_t* row, int32_t* win, int stride) {
    uint64_t st[8];
    ct_sha512_block(row, st);
    ct_challenge_windows(st, win, stride);
}
