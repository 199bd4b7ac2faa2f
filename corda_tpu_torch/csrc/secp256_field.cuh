// GF(p) on eight little-endian 32-bit words, every value kept canonical in
// [0, p) after each operation, for three primes: kernel F's two ECDSA primes
// and kernel G's p = 2^255 - 19. Shared by the CUDA kernels and
// host_check.cpp.
//
// Why not the TPU's 22 x 12-bit (or 32 x 8-bit) int32 limbs: those exist
// because the TPU's vector unit multiplies 32-bit lanes only, and their
// derived residue folds keep int32 sums in range. The card multiplies
// 32 x 32 -> 64 bits, so a product is 64 such multiplies, and each prime
// has a cheap reduction of its own:
// - secp256k1 (ct_secp256k1): 2^256 = 2^32 + 977 mod p, so the high half
//   folds in as hi * 977 + (hi << 32), and the top carry once more; its
//   3b = 21 is one word, so the formulas' b3 products are eight products;
// - secp256r1 (ct_secp256r1): the NIST P-256 Solinas reduction (FIPS 186-4
//   D.2.3), nine signed word sums, then the top carry through
//   2^256 = 2^224 - 2^192 - 2^96 + 1 mod p;
// - 2^255 - 19 (ct_p25519): 2^256 = 38 mod p, so the high half folds in as
//   hi * 38, then every bit from 255 up once more as 19 each.
// All end in a conditional subtraction of p. A squaring is 36 products
// (the cross products once, doubled, plus the squares) where a multiply is
// 64. No secret is involved in a verification, so branches and selects may
// depend on the data.
#pragma once

#include "common.cuh"

struct ct_u256 {
    uint32_t v[8];
};

struct ct_secp256k1 {
    static constexpr bool kAZero = true;
    static CT_HD uint32_t p(int i) {
        return i == 0 ? 0xFFFFFC2Fu : (i == 1 ? 0xFFFFFFFEu : 0xFFFFFFFFu);
    }
};

struct ct_secp256r1 {
    static constexpr bool kAZero = false;
    static CT_HD uint32_t p(int i) {
        return (i < 3 || i == 7) ? 0xFFFFFFFFu : (i == 6 ? 1u : 0u);
    }
};

struct ct_p25519 {
    static CT_HD uint32_t p(int i) {
        return i == 0 ? 0xFFFFFFEDu : (i == 7 ? 0x7FFFFFFFu : 0xFFFFFFFFu);
    }
};

CT_HD void ct_u256_zero(ct_u256& r) {
#pragma unroll
    for (int i = 0; i < 8; i++) r.v[i] = 0;
}

CT_HD void ct_u256_from_bytes(ct_u256& r, const uint8_t* b) {
#pragma unroll
    for (int i = 0; i < 8; i++)
        r.v[i] = (uint32_t)b[4 * i] | ((uint32_t)b[4 * i + 1] << 8) |
                 ((uint32_t)b[4 * i + 2] << 16) | ((uint32_t)b[4 * i + 3] << 24);
}

CT_HD void ct_u256_to_bytes(uint8_t* b, const ct_u256& r) {
#pragma unroll
    for (int i = 0; i < 8; i++) {
        b[4 * i] = (uint8_t)r.v[i];
        b[4 * i + 1] = (uint8_t)(r.v[i] >> 8);
        b[4 * i + 2] = (uint8_t)(r.v[i] >> 16);
        b[4 * i + 3] = (uint8_t)(r.v[i] >> 24);
    }
}

CT_HD void ct_u256_load(ct_u256& r, const int32_t* words) {
#pragma unroll
    for (int i = 0; i < 8; i++) r.v[i] = (uint32_t)ct_ldg(words + i);
}

CT_HD int ct_u256_is_zero(const ct_u256& a) {
    uint32_t acc = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) acc |= a.v[i];
    return acc == 0;
}

CT_HD int ct_u256_eq(const ct_u256& a, const ct_u256& b) {
    uint32_t acc = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) acc |= a.v[i] ^ b.v[i];
    return acc == 0;
}

// r = s - p when the value s + carry * 2^256 is >= p, else s (the value is
// below 2p, so one subtraction reaches [0, p)).
template <class C>
CT_HD void ct_sp_reduce_once(ct_u256& r, const uint32_t s[8], uint32_t carry) {
    uint32_t d[8];
    uint64_t borrow = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        uint64_t t = (uint64_t)s[i] - C::p(i) - borrow;
        d[i] = (uint32_t)t;
        borrow = t >> 63;
    }
    bool take = carry || !borrow;
#pragma unroll
    for (int i = 0; i < 8; i++) r.v[i] = take ? d[i] : s[i];
}

template <class C>
CT_HD void ct_sp_add(ct_u256& r, const ct_u256& a, const ct_u256& b) {
    uint32_t s[8];
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        c += (uint64_t)a.v[i] + b.v[i];
        s[i] = (uint32_t)c;
        c >>= 32;
    }
    ct_sp_reduce_once<C>(r, s, (uint32_t)c);
}

template <class C>
CT_HD void ct_sp_sub(ct_u256& r, const ct_u256& a, const ct_u256& b) {
    uint32_t d[8];
    uint64_t borrow = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        uint64_t t = (uint64_t)a.v[i] - b.v[i] - borrow;
        d[i] = (uint32_t)t;
        borrow = t >> 63;
    }
    // on a borrow add p back (the final carry out cancels the borrow)
    uint32_t mask = borrow ? 0xFFFFFFFFu : 0u;
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        c += (uint64_t)d[i] + (C::p(i) & mask);
        r.v[i] = (uint32_t)c;
        c >>= 32;
    }
}

// r = -a mod p.
template <class C>
CT_HD void ct_sp_neg(ct_u256& r, const ct_u256& a) {
    ct_u256 z;
    ct_u256_zero(z);
    ct_sp_sub<C>(r, z, a);
}

// The 512-bit product t of a and b: 64 products of 32 x 32 -> 64 bits.
CT_HD void ct_u256_mul_wide(uint32_t t[16], const ct_u256& a, const ct_u256& b) {
#pragma unroll
    for (int i = 0; i < 16; i++) t[i] = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; j < 8; j++) {
            uint64_t u = (uint64_t)a.v[i] * b.v[j] + t[i + j] + c;
            t[i + j] = (uint32_t)u;
            c = u >> 32;
        }
        t[i + 8] = (uint32_t)c;
    }
}

// The 512-bit square t of a: the 28 cross products a_i a_j (i < j) once,
// doubled by a one-bit shift, then the 8 squares a_i^2 added in: 36
// products of 32 x 32 -> 64 bits where the multiply takes 64.
CT_HD void ct_u256_sq_wide(uint32_t t[16], const ct_u256& a) {
#pragma unroll
    for (int i = 0; i < 16; i++) t[i] = 0;
#pragma unroll
    for (int i = 0; i < 7; i++) {
        uint64_t c = 0;
#pragma unroll
        for (int j = i + 1; j < 8; j++) {
            uint64_t u = (uint64_t)a.v[i] * a.v[j] + t[i + j] + c;
            t[i + j] = (uint32_t)u;
            c = u >> 32;
        }
        t[i + 8] = (uint32_t)c;
    }
    // the cross sum is below 2^511, so the shift loses nothing
#pragma unroll
    for (int i = 15; i > 0; i--) t[i] = (t[i] << 1) | (t[i - 1] >> 31);
    t[0] <<= 1;
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        uint64_t u = (uint64_t)a.v[i] * a.v[i];
        c += (uint64_t)t[2 * i] + (uint32_t)u;
        t[2 * i] = (uint32_t)c;
        c >>= 32;
        c += (uint64_t)t[2 * i + 1] + (u >> 32);
        t[2 * i + 1] = (uint32_t)c;
        c >>= 32;
    }
}

// secp256k1: r = w + c * 2^256 mod p for a top carry c < 2^34: w += c * 977
// + (c << 32), once more if that wraps past 2^256, then below p.
CT_HD void ct_k1_fold_top(ct_u256& r, uint32_t w[8], uint64_t c) {
    uint64_t d = (uint64_t)w[0] + c * 977u;
    w[0] = (uint32_t)d;
    d >>= 32;
    d += (uint64_t)w[1] + c;
    w[1] = (uint32_t)d;
    d >>= 32;
#pragma unroll
    for (int i = 2; i < 8; i++) {
        d += w[i];
        w[i] = (uint32_t)d;
        d >>= 32;
    }
    if (d) {
        // wrapped past 2^256 once more: w is below 2^67, so adding
        // 2^32 + 977 cannot carry out
        uint64_t e = (uint64_t)w[0] + 977u;
        w[0] = (uint32_t)e;
        e = (e >> 32) + w[1] + 1u;
        w[1] = (uint32_t)e;
        e >>= 32;
#pragma unroll
        for (int i = 2; i < 8; i++) {
            e += w[i];
            w[i] = (uint32_t)e;
            e >>= 32;
        }
    }
    ct_sp_reduce_once<ct_secp256k1>(r, w, 0);
}

// secp256k1: value = lo + hi * (2^32 + 977).
CT_HD void ct_k1_reduce(ct_u256& r, const uint32_t t[16]) {
    uint32_t w[8];
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        c += (uint64_t)t[i] + (uint64_t)t[8 + i] * 977u + (i ? t[7 + i] : 0u);
        w[i] = (uint32_t)c;
        c >>= 32;
    }
    c += t[15];  // hi's top word, shifted up one word, lands at 2^256
    ct_k1_fold_top(r, w, c);
}

// secp256k1: r = a * k mod p for a one-word k (the curve's 3b = 21): eight
// products, then the top word through the same fold.
CT_HD void ct_k1_mul_word(ct_u256& r, const ct_u256& a, uint32_t k) {
    uint32_t w[8];
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        c += (uint64_t)a.v[i] * k;
        w[i] = (uint32_t)c;
        c >>= 32;
    }
    ct_k1_fold_top(r, w, c);
}

// Signed carry propagation of eight int64 word sums into w; returns the
// signed carry out of word 7 (the multiple of 2^256 left over).
CT_HD int64_t ct_r1_propagate(uint32_t w[8], int64_t acc[8]) {
    int64_t carry = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
        int64_t v = acc[j] + carry;
        w[j] = (uint32_t)v;
        carry = (v - (int64_t)w[j]) / ((int64_t)1 << 32);  // exact: floor
    }
    return carry;
}

// secp256r1: FIPS 186-4 D.2.3, s1 + 2 s2 + 2 s3 + s4 + s5 - s6 - s7 - s8 - s9
// gathered word by word, then the top carry through
// 2^256 = 2^224 - 2^192 - 2^96 + 1 (mod p) until none is left (at most three
// rounds: the first leaves |carry| <= 6, the next at most one).
CT_HD void ct_r1_reduce(ct_u256& r, const uint32_t t[16]) {
    int64_t c[16];
#pragma unroll
    for (int i = 0; i < 16; i++) c[i] = t[i];
    int64_t acc[8];
    acc[0] = c[0] + c[8] + c[9] - c[11] - c[12] - c[13] - c[14];
    acc[1] = c[1] + c[9] + c[10] - c[12] - c[13] - c[14] - c[15];
    acc[2] = c[2] + c[10] + c[11] - c[13] - c[14] - c[15];
    acc[3] = c[3] + 2 * c[11] + 2 * c[12] + c[13] - c[15] - c[8] - c[9];
    acc[4] = c[4] + 2 * c[12] + 2 * c[13] + c[14] - c[9] - c[10];
    acc[5] = c[5] + 2 * c[13] + 2 * c[14] + c[15] - c[10] - c[11];
    acc[6] = c[6] + c[13] + 3 * c[14] + 2 * c[15] - c[8] - c[9];
    acc[7] = c[7] + c[8] + 3 * c[15] - c[10] - c[11] - c[12] - c[13];
    uint32_t w[8];
    int64_t top = ct_r1_propagate(w, acc);
#pragma unroll 1
    for (int round = 0; round < 3 && top != 0; round++) {
#pragma unroll
        for (int j = 0; j < 8; j++) acc[j] = w[j];
        acc[0] += top;
        acc[3] -= top;
        acc[6] -= top;
        acc[7] += top;
        top = ct_r1_propagate(w, acc);
    }
    ct_sp_reduce_once<ct_secp256r1>(r, w, 0);
}

// 2^255 - 19: value = lo + 38 hi leaves w and a carry c <= 39 past 2^256;
// the bits from 255 up, q = 2c + (w_7 >> 31) < 80, fold once more as 19 q,
// which leaves w below 2^255 + 19 * 80 < 2p, so one subtraction ends it.
CT_HD void ct_25519_reduce(ct_u256& r, const uint32_t t[16]) {
    uint32_t w[8];
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        c += (uint64_t)t[i] + (uint64_t)t[8 + i] * 38u;
        w[i] = (uint32_t)c;
        c >>= 32;
    }
    uint32_t q = ((uint32_t)c << 1) | (w[7] >> 31);
    w[7] &= 0x7FFFFFFFu;
    uint64_t d = (uint64_t)w[0] + 19u * q;
    w[0] = (uint32_t)d;
    d >>= 32;
#pragma unroll
    for (int i = 1; i < 8; i++) {
        d += w[i];
        w[i] = (uint32_t)d;
        d >>= 32;
    }
    ct_sp_reduce_once<ct_p25519>(r, w, 0);
}

template <class C>
CT_HD void ct_sp_reduce(ct_u256& r, const uint32_t t[16]);

template <>
CT_HD void ct_sp_reduce<ct_secp256k1>(ct_u256& r, const uint32_t t[16]) {
    ct_k1_reduce(r, t);
}

template <>
CT_HD void ct_sp_reduce<ct_secp256r1>(ct_u256& r, const uint32_t t[16]) {
    ct_r1_reduce(r, t);
}

template <>
CT_HD void ct_sp_reduce<ct_p25519>(ct_u256& r, const uint32_t t[16]) {
    ct_25519_reduce(r, t);
}

// r = a * b mod p (r may alias a or b).
template <class C>
CT_HD void ct_sp_mul(ct_u256& r, const ct_u256& a, const ct_u256& b) {
    uint32_t t[16];
    ct_u256_mul_wide(t, a, b);
    ct_sp_reduce<C>(r, t);
}

// r = a^2 mod p (r may alias a): the dedicated 36-product square.
template <class C>
CT_HD void ct_sp_sq(ct_u256& r, const ct_u256& a) {
    uint32_t t[16];
    ct_u256_sq_wide(t, a);
    ct_sp_reduce<C>(r, t);
}

// r = 3b * v, the RCB16 formulas' b3 products: secp256k1's 3b = 21 is one
// word (the table row's low word), so eight products; secp256r1's is a
// full multiply.
template <class C>
CT_HD void ct_sp_mul_b3(ct_u256& r, const ct_u256& v, const ct_u256& b3);

template <>
CT_HD void ct_sp_mul_b3<ct_secp256k1>(ct_u256& r, const ct_u256& v, const ct_u256& b3) {
    ct_k1_mul_word(r, v, b3.v[0]);
}

template <>
CT_HD void ct_sp_mul_b3<ct_secp256r1>(ct_u256& r, const ct_u256& v, const ct_u256& b3) {
    ct_sp_mul<ct_secp256r1>(r, b3, v);
}
