// SHA-256 for kernels C and D, shared by sha256.cu and host_check.cpp.
//
// Words are big-endian 32-bit, as FIPS 180-4 and the reference
// (corda_tpu/ops/sha256.py) carry them; a digest leaves as 8 such words,
// which digest_words_to_bytes writes out as ">u4". The message schedule
// rolls through a 16-word ring, so with every loop unrolled each word and
// round constant sits in a register or an immediate.
//
// A compression is two halves: the schedule, expanded into W[t] + K[t]
// (ct_sha256_wk_chunk), and the rounds on those sums
// (ct_sha256_rounds_chunk), 16 of each a chunk. Kernel C runs them on two
// warps, kernel D both on one thread (ct_sha256_compress).
#pragma once

#include "common.cuh"

#define CT_SHA256_K_INIT {                                                  \
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu,         \
    0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u,         \
    0x243185beu, 0x550c7dc3u, 0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u,         \
    0xc19bf174u, 0xe49b69c1u, 0xefbe4786u, 0x0fc19dc6u, 0x240ca1ccu,         \
    0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau, 0x983e5152u,         \
    0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,         \
    0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu,         \
    0x53380d13u, 0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u,         \
    0xa2bfe8a1u, 0xa81a664bu, 0xc24b8b70u, 0xc76c51a3u, 0xd192e819u,         \
    0xd6990624u, 0xf40e3585u, 0x106aa070u, 0x19a4c116u, 0x1e376c08u,         \
    0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au, 0x5b9cca4fu,         \
    0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,         \
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u}

#define CT_SHA256_IV_INIT {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u,            \
                           0xa54ff53au, 0x510e527fu, 0x9b05688cu,            \
                           0x1f83d9abu, 0x5be0cd19u}

CT_HD uint32_t ct_rotr32(uint32_t x, int n) {
#if defined(__CUDA_ARCH__)
    return __funnelshift_r(x, x, n);
#else
    return (x >> n) | (x << (32 - n));
#endif
}

// The 16 big-endian words of a 64-byte block (the host's read; kernel C's
// producer reads its staged copy in shared memory).
CT_HD void ct_sha256_load_block(uint32_t w[16], const uint8_t* blk) {
    for (int i = 0; i < 16; i++) {
        const uint8_t* p = blk + 4 * i;
        w[i] = ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
               ((uint32_t)p[2] << 8) | (uint32_t)p[3];
    }
}

// Kernel C's producer, chunk c (0..3) of a block: W[t] + K[t] for t =
// 16c .. 16c + 15. The ring `w` holds the block's 16 words before chunk 0
// and the last 16 schedule words after each chunk. `c` must be a constant
// once the caller's loop is unrolled (K is indexed by it).
CT_HD void ct_sha256_wk_chunk(uint32_t wk[16], uint32_t w[16], int c) {
    const uint32_t K[64] = CT_SHA256_K_INIT;
#pragma unroll
    for (int i = 0; i < 16; i++) {
        if (c > 0) {  // t = 16c + i >= 16: w[i] is W[t - 16]
            uint32_t x = w[(i + 1) & 15], y = w[(i + 14) & 15];
            uint32_t s0 = ct_rotr32(x, 7) ^ ct_rotr32(x, 18) ^ (x >> 3);
            uint32_t s1 = ct_rotr32(y, 17) ^ ct_rotr32(y, 19) ^ (y >> 10);
            w[i] = w[i] + s0 + w[(i + 9) & 15] + s1;
        }
        wk[i] = w[i] + K[16 * c + i];
    }
}

// Kernel C's consumer: 16 rounds over the working variables v = (a..h),
// from their 16 sums W[t] + K[t].
CT_HD void ct_sha256_rounds_chunk(uint32_t v[8], const uint32_t wk[16]) {
    uint32_t a = v[0], b = v[1], c = v[2], d = v[3];
    uint32_t e = v[4], f = v[5], g = v[6], h = v[7];
#pragma unroll
    for (int i = 0; i < 16; i++) {
        uint32_t S1 = ct_rotr32(e, 6) ^ ct_rotr32(e, 11) ^ ct_rotr32(e, 25);
        uint32_t ch = (e & f) ^ (~e & g);
        uint32_t t1 = h + S1 + ch + wk[i];
        uint32_t S0 = ct_rotr32(a, 2) ^ ct_rotr32(a, 13) ^ ct_rotr32(a, 22);
        uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
        h = g;
        g = f;
        f = e;
        e = d + t1;
        d = c;
        c = b;
        b = a;
        a = t1 + S0 + maj;
    }
    v[0] = a; v[1] = b; v[2] = c; v[3] = d;
    v[4] = e; v[5] = f; v[6] = g; v[7] = h;
}

// One compression of the block words `w` (clobbered: they become the
// rolling schedule) into the chaining state `st`: the producer's four
// chunks and the consumer's in turn, on one thread (kernel D, and kernel
// C's lane on the host).
CT_HD void ct_sha256_compress(uint32_t st[8], uint32_t w[16]) {
    uint32_t v[8];
#pragma unroll
    for (int i = 0; i < 8; i++) v[i] = st[i];
#pragma unroll
    for (int c = 0; c < 4; c++) {
        uint32_t wk[16];
        ct_sha256_wk_chunk(wk, w, c);
        ct_sha256_rounds_chunk(v, wk);
    }
#pragma unroll
    for (int i = 0; i < 8; i++) st[i] += v[i];
}

// Kernel C's lane on one thread: the digest of a message already padded
// into `nblk` consecutive 64-byte blocks.
CT_HD void ct_sha256_blocks(uint32_t out[8], const uint8_t* blocks, int nblk) {
    const uint32_t iv[8] = CT_SHA256_IV_INIT;
#pragma unroll
    for (int i = 0; i < 8; i++) out[i] = iv[i];
#pragma unroll 1
    for (int k = 0; k < nblk; k++) {
        uint32_t w[16];
        ct_sha256_load_block(w, blocks + 64 * k);
        ct_sha256_compress(out, w);
    }
}

// Kernel C's work split, shared by its launch and host_check's copy of
// it: CT_C_PAIRS warp pairs a block, each block ordering CT_C_CHUNK of its
// messages at once, one a thread.
#define CT_C_PAIRS 2
#define CT_C_CHUNK (64 * CT_C_PAIRS)

// The launch's blocks: one for each 32 messages a pair, at most one an SM.
CT_HD int ct_c_grid(int n, int sms) {
    const int g = (n + 32 * CT_C_PAIRS - 1) / (32 * CT_C_PAIRS);
    return g < sms ? g : sms;
}

// Block b of g's messages of the n: the contiguous range [lo, hi).
CT_HD void ct_c_range(int n, int g, int b, int* lo, int* hi) {
    const int per = (n + g - 1) / g;
    *lo = b * per < n ? b * per : n;
    *hi = *lo + per < n ? *lo + per : n;
}

// Message t's place in the lane order of a chunk of m messages whose block
// counts are cnts: longest first, ties in message order.
CT_HD int ct_c_rank(const int* cnts, int m, int t) {
    const int c = cnts[t];
    int r = 0;
    for (int j = 0; j < m; j++) r += cnts[j] > c || (cnts[j] == c && j < t);
    return r;
}

// Kernel D's lane: SHA-256 of the 64-byte left || right. The second block
// is the constant padding block (0x80, zeros, bit length 512): its words
// are literals, so once the rounds are unrolled the compiler folds its
// whole message schedule into constants.
CT_HD void ct_sha256_pair(uint32_t out[8], const uint32_t left[8],
                          const uint32_t right[8]) {
    const uint32_t iv[8] = CT_SHA256_IV_INIT;
    uint32_t w[16];
#pragma unroll
    for (int i = 0; i < 8; i++) {
        out[i] = iv[i];
        w[i] = left[i];
        w[8 + i] = right[i];
    }
    ct_sha256_compress(out, w);
#pragma unroll
    for (int i = 0; i < 16; i++) w[i] = 0;
    w[0] = 0x80000000u;
    w[15] = 512u;
    ct_sha256_compress(out, w);
}
