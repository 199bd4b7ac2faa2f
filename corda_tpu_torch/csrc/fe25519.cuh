// GF(2^255 - 19) for kernel B, in ref10's representation: ten signed
// 32-bit limbs of alternating 26 and 25 bits (limb i sits at bit
// ceil(25.5 i)), products accumulated in int64. Shared by the CUDA kernel
// and host_check.cpp.
//
// Why not the TPU's 20 x 13-bit int32 limbs: those exist because the TPU's
// vector unit multiplies 32-bit lanes only. The card multiplies 32 x 32 ->
// 64 bits (IMAD.WIDE), so ten limbs need 100 products per multiply where
// the TPU layout needs 400.
//
// Discipline: every add, subtract and negate carries once (fe_carry64), so
// every multiply input has |limb| <= ~2^26 and a 64-bit column sums at most
// 10 products of 2^26 x 19 * 2^27 < 2^61. ct_fe_canonical gives the unique
// limbs of the value in [0, p).
#pragma once

#include "common.cuh"

struct ct_fe {
    int32_t v[10];
};

CT_HD int ct_fe_width(int i) { return (i & 1) ? 25 : 26; }

CT_HD int ct_fe_offset(int i) { return 26 * ((i + 1) >> 1) + 25 * (i >> 1); }

CT_HD void ct_fe_zero(ct_fe& h) {
#pragma unroll
    for (int i = 0; i < 10; i++) h.v[i] = 0;
}

CT_HD void ct_fe_one(ct_fe& h) {
    ct_fe_zero(h);
    h.v[0] = 1;
}

// Carry 64-bit limbs back to ~26/25 bits (signed, rounding carries), with
// the top carry wrapped as 19 * 2^0 (2^255 = 19 mod p).
CT_HD void ct_fe_carry64(ct_fe& out, int64_t h[10]) {
    int64_t c;
#define CT_CARRY(i, bits)                                   \
    c = (h[i] + ((int64_t)1 << ((bits) - 1))) >> (bits);    \
    h[(i) + 1] += c;                                        \
    h[i] -= c * ((int64_t)1 << (bits));
    CT_CARRY(0, 26) CT_CARRY(4, 26)
    CT_CARRY(1, 25) CT_CARRY(5, 25)
    CT_CARRY(2, 26) CT_CARRY(6, 26)
    CT_CARRY(3, 25) CT_CARRY(7, 25)
    CT_CARRY(4, 26) CT_CARRY(8, 26)
    c = (h[9] + ((int64_t)1 << 24)) >> 25;
    h[0] += c * 19;
    h[9] -= c * ((int64_t)1 << 25);
    CT_CARRY(0, 26)
#undef CT_CARRY
#pragma unroll
    for (int i = 0; i < 10; i++) out.v[i] = (int32_t)h[i];
}

CT_HD void ct_fe_add(ct_fe& h, const ct_fe& f, const ct_fe& g) {
    int64_t t[10];
#pragma unroll
    for (int i = 0; i < 10; i++) t[i] = (int64_t)f.v[i] + g.v[i];
    ct_fe_carry64(h, t);
}

CT_HD void ct_fe_sub(ct_fe& h, const ct_fe& f, const ct_fe& g) {
    int64_t t[10];
#pragma unroll
    for (int i = 0; i < 10; i++) t[i] = (int64_t)f.v[i] - g.v[i];
    ct_fe_carry64(h, t);
}

CT_HD void ct_fe_neg(ct_fe& h, const ct_fe& f) {
    int64_t t[10];
#pragma unroll
    for (int i = 0; i < 10; i++) t[i] = -(int64_t)f.v[i];
    ct_fe_carry64(h, t);
}

// h = f * g (h may alias f or g): 100 products of 32 x 32 -> 64 bits.
// Term f_i g_j lands at limb (i + j) mod 10, times 2 when i and j are both
// odd (the half-bit offsets add up to one extra bit) and times 19 when
// i + j >= 10 (the wrap past 2^255).
CT_HD void ct_fe_mul(ct_fe& h, const ct_fe& f, const ct_fe& g) {
    int32_t g19[10], f2[10];
#pragma unroll
    for (int i = 0; i < 10; i++) {
        g19[i] = 19 * g.v[i];
        f2[i] = (i & 1) ? 2 * f.v[i] : f.v[i];
    }
    int64_t t[10];
#pragma unroll
    for (int i = 0; i < 10; i++) t[i] = 0;
#pragma unroll
    for (int i = 0; i < 10; i++) {
#pragma unroll
        for (int j = 0; j < 10; j++) {
            int32_t a = (j & 1) ? f2[i] : f.v[i];
            int32_t b = (i + j >= 10) ? g19[j] : g.v[j];
            t[(i + j) % 10] += (int64_t)a * b;
        }
    }
    ct_fe_carry64(h, t);
}

// h = f^2 (h may alias f): ref10's fe_sq, the 55 products f_i f_j with
// i <= j. The cross terms (i < j) count twice, and the same rules as the
// multiply's place the rest: times 2 when i and j are both odd, times 19
// past 2^255. Each product takes its factors split so that both stay in
// 32 bits: the first side carries the 2 of a cross term (f_i, |f_i| <= 2^27),
// the second the odd-odd 2 and the 19 (|f_j| <= 38 * 2^25 < 2^31).
CT_HD void ct_fe_sq(ct_fe& h, const ct_fe& f) {
    int64_t t[10];
#pragma unroll
    for (int i = 0; i < 10; i++) t[i] = 0;
#pragma unroll
    for (int i = 0; i < 10; i++) {
#pragma unroll
        for (int j = i; j < 10; j++) {
            int32_t a = (i == j) ? f.v[i] : 2 * f.v[i];
            int32_t b = ((i & j & 1) ? 2 : 1) * ((i + j >= 10) ? 19 : 1) * f.v[j];
            t[(i + j) % 10] += (int64_t)a * b;
        }
    }
    ct_fe_carry64(h, t);
}

// The unique limbs of the value in [0, p) (ref10 fe_tobytes' reduction).
CT_HD void ct_fe_canonical(ct_fe& out, const ct_fe& f) {
    ct_fe h = f;
    int32_t q = (19 * h.v[9] + (1 << 24)) >> 25;
#pragma unroll
    for (int i = 0; i < 10; i++) q = (h.v[i] + q) >> ct_fe_width(i);
    h.v[0] += 19 * q;
#pragma unroll
    for (int i = 0; i < 9; i++) {
        int w = ct_fe_width(i);
        int32_t c = h.v[i] >> w;
        h.v[i + 1] += c;
        h.v[i] -= c * (1 << w);
    }
    h.v[9] &= (1 << 25) - 1;
    out = h;
}

CT_HD int ct_fe_eq(const ct_fe& f, const ct_fe& g) {
    ct_fe a, b;
    ct_fe_canonical(a, f);
    ct_fe_canonical(b, g);
    int32_t diff = 0;
#pragma unroll
    for (int i = 0; i < 10; i++) diff |= a.v[i] ^ b.v[i];
    return diff == 0;
}

CT_HD int ct_fe_is_zero(const ct_fe& f) {
    ct_fe z;
    ct_fe_zero(z);
    return ct_fe_eq(f, z);
}

CT_HD int ct_fe_is_odd(const ct_fe& f) {
    ct_fe a;
    ct_fe_canonical(a, f);
    return a.v[0] & 1;
}

// f = bit ? g : f, without a branch
CT_HD void ct_fe_cmov(ct_fe& f, const ct_fe& g, int bit) {
    int32_t mask = -(int32_t)(bit & 1);
#pragma unroll
    for (int i = 0; i < 10; i++) f.v[i] ^= mask & (f.v[i] ^ g.v[i]);
}

// Bits [off, off + w) of a 32-byte little-endian string (w <= 26).
CT_HD int32_t ct_get_bits(const uint8_t* s, int off, int w) {
    uint64_t acc = 0;
    int b0 = off >> 3;
#pragma unroll
    for (int k = 0; k < 5; k++) {
        int idx = b0 + k;
        if (idx < 32) acc |= (uint64_t)s[idx] << (8 * k);
    }
    return (int32_t)((acc >> (off & 7)) & ((1u << w) - 1));
}

// The exact limb decomposition of the low 255 bits of a 32-byte
// little-endian string (bit 255 dropped): equal to a canonical element's
// limbs iff the string encodes that element.
CT_HD void ct_fe_bits_of_bytes(ct_fe& h, const uint8_t* s) {
#pragma unroll
    for (int i = 0; i < 10; i++)
        h.v[i] = ct_get_bits(s, ct_fe_offset(i), ct_fe_width(i));
}

// The field element of the low 255 bits, carried into the working bounds.
CT_HD void ct_fe_from_bytes(ct_fe& h, const uint8_t* s) {
    ct_fe raw;
    ct_fe_bits_of_bytes(raw, s);
    int64_t t[10];
#pragma unroll
    for (int i = 0; i < 10; i++) t[i] = raw.v[i];
    ct_fe_carry64(h, t);
}

// Canonical 32-byte little-endian encoding (bit 255 clear).
CT_HD void ct_fe_to_bytes(uint8_t* s, const ct_fe& f) {
    ct_fe a;
    ct_fe_canonical(a, f);
    uint64_t acc = 0;
    int bits = 0, pos = 0;
#pragma unroll
    for (int i = 0; i < 10; i++) {
        acc |= (uint64_t)(uint32_t)a.v[i] << bits;
        bits += ct_fe_width(i);
        while (bits >= 8) {
            s[pos++] = (uint8_t)acc;
            acc >>= 8;
            bits -= 8;
        }
    }
    s[pos] = (uint8_t)acc;  // bits 248..254
}

// Load table row `row` (10 int32 limbs) of the constant table.
CT_HD void ct_fe_load(ct_fe& h, const int32_t* table, int row) {
#pragma unroll
    for (int i = 0; i < 10; i++) h.v[i] = ct_ldg(table + 10 * row + i);
}

// --- the field as a trait, for the templated ladder and chains ----------

// Kernel B's field for ed25519_ladder.cuh and fe_chain.cuh.
struct ct_fe10 {
    using fe = ct_fe;
    static constexpr int kWords = 10;  // 32-bit words of an element
    static CT_HD void zero(fe& h) { ct_fe_zero(h); }
    static CT_HD void one(fe& h) { ct_fe_one(h); }
    static CT_HD void add(fe& h, const fe& f, const fe& g) { ct_fe_add(h, f, g); }
    static CT_HD void sub(fe& h, const fe& f, const fe& g) { ct_fe_sub(h, f, g); }
    static CT_HD void neg(fe& h, const fe& f) { ct_fe_neg(h, f); }
    static CT_HD void mul(fe& h, const fe& f, const fe& g) { ct_fe_mul(h, f, g); }
    static CT_HD void sq(fe& h, const fe& f) { ct_fe_sq(h, f); }
    static CT_HD void cmov(fe& f, const fe& g, int bit) { ct_fe_cmov(f, g, bit); }
    // h = bit ? -f : f, limb by limb (the limbs' bounds do not change)
    static CT_HD void cneg(fe& h, const fe& f, int bit) {
        int32_t mask = -(int32_t)(bit & 1);
#pragma unroll
        for (int i = 0; i < 10; i++) h.v[i] = (f.v[i] ^ mask) - mask;
    }
    static CT_HD int eq(const fe& f, const fe& g) { return ct_fe_eq(f, g); }
    static CT_HD int is_zero(const fe& f) { return ct_fe_is_zero(f); }
    static CT_HD int is_odd(const fe& f) { return ct_fe_is_odd(f); }
    static CT_HD void load(fe& h, const int32_t* table, int row) { ct_fe_load(h, table, row); }
    // the field element of the low 255 bits of 32 little-endian bytes
    static CT_HD void from_bytes(fe& h, const uint8_t* s) { ct_fe_from_bytes(h, s); }
    // 1 iff the affine point (x, y) encodes as the 32 bytes r: canonical y
    // equal to r's low 255 bits and the parity of x equal to bit 255
    static CT_HD int encodes(fe x, fe y, const uint8_t* r) {
        fe ry;
        ct_fe_canonical(x, x);
        ct_fe_canonical(y, y);
        ct_fe_bits_of_bytes(ry, r);
        int32_t diff = 0;
#pragma unroll
        for (int i = 0; i < 10; i++) diff |= y.v[i] ^ ry.v[i];
        return (diff == 0) & ((x.v[0] & 1) == (r[31] >> 7));
    }
    static CT_HD void inv(fe& out, const fe& z);
    static CT_HD void pow_p58(fe& out, const fe& z);
};

#include "fe_chain.cuh"

CT_HD void ct_fe10::inv(fe& out, const fe& z) { ct_pow_inv<ct_fe10>(out, z); }
CT_HD void ct_fe10::pow_p58(fe& out, const fe& z) { ct_pow_p58<ct_fe10>(out, z); }

// z^(p - 2) = 1/z (0 -> 0): 254 squarings + 11 multiplies
CT_HD void ct_fe_inv(ct_fe& out, const ct_fe& z) { ct_pow_inv<ct_fe10>(out, z); }

// z^((p - 5) / 8): 251 squarings + 11 multiplies
CT_HD void ct_fe_pow_p58(ct_fe& out, const ct_fe& z) { ct_pow_p58<ct_fe10>(out, z); }
