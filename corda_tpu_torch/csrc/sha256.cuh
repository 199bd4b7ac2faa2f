// SHA-256 for kernels C and D, shared by sha256.cu and host_check.cpp.
//
// Words are big-endian 32-bit, as FIPS 180-4 and the reference
// (corda_tpu/ops/sha256.py) carry them; a digest leaves as 8 such words,
// which digest_words_to_bytes writes out as ">u4". The message schedule
// rolls through a 16-word ring, so with every loop unrolled each word and
// round constant sits in a register or an immediate.
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

// The 16 big-endian words of a 64-byte block (16-byte aligned on the card:
// blocks start at multiples of 64 bytes of a buffer PyTorch allocated).
CT_HD void ct_sha256_load_block(uint32_t w[16], const uint8_t* blk) {
#if defined(__CUDA_ARCH__)
    const uint4* q = reinterpret_cast<const uint4*>(blk);
#pragma unroll
    for (int i = 0; i < 4; i++) {
        uint4 v = __ldg(q + i);
        w[4 * i + 0] = __byte_perm(v.x, 0, 0x0123);
        w[4 * i + 1] = __byte_perm(v.y, 0, 0x0123);
        w[4 * i + 2] = __byte_perm(v.z, 0, 0x0123);
        w[4 * i + 3] = __byte_perm(v.w, 0, 0x0123);
    }
#else
    for (int i = 0; i < 16; i++) {
        const uint8_t* p = blk + 4 * i;
        w[i] = ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
               ((uint32_t)p[2] << 8) | (uint32_t)p[3];
    }
#endif
}

// One compression of the block words `w` (clobbered: they become the
// rolling schedule) into the chaining state `st`.
CT_HD void ct_sha256_compress(uint32_t st[8], uint32_t w[16]) {
    const uint32_t K[64] = CT_SHA256_K_INIT;
    uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
    uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
    for (int t = 0; t < 64; t++) {
        uint32_t wt;
        if (t < 16) {
            wt = w[t];
        } else {
            uint32_t x = w[(t - 15) & 15], y = w[(t - 2) & 15];
            uint32_t s0 = ct_rotr32(x, 7) ^ ct_rotr32(x, 18) ^ (x >> 3);
            uint32_t s1 = ct_rotr32(y, 17) ^ ct_rotr32(y, 19) ^ (y >> 10);
            wt = w[t & 15] + s0 + w[(t - 7) & 15] + s1;
            w[t & 15] = wt;
        }
        uint32_t S1 = ct_rotr32(e, 6) ^ ct_rotr32(e, 11) ^ ct_rotr32(e, 25);
        uint32_t ch = (e & f) ^ (~e & g);
        uint32_t t1 = h + S1 + ch + K[t] + wt;
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
    st[0] += a; st[1] += b; st[2] += c; st[3] += d;
    st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

// Kernel C's lane: the digest of a message already padded into `nblk`
// consecutive 64-byte blocks.
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
