// GF(2^255 - 19) for kernel G: eight little-endian 32-bit words, every value
// canonical in [0, p) after each operation, the 2^256 = 38 fold
// (secp256_field.cuh's ct_p25519, beside kernel F's two primes), as a field
// trait for the templated ladder (ed25519_ladder.cuh) and the exponent chains
// (fe_chain.cuh). Shared by the CUDA kernel and host_check.cpp.
//
// Why not the TPU tier's 22 x 12-bit int32 limbs with lazy bounds and the
// split 2^264 = 2 * 4096 + 1536 fold: they keep 22-term int32 column sums in
// range on a vector unit that multiplies 32-bit lanes only. The card
// multiplies 32 x 32 -> 64 bits, so a multiply here is 64 products where
// kernel B's ref10 limbs take 100, and canonical values make every compare a
// word compare. A squaring is 36 products (ct_25519_sq, over
// secp256_field.cuh's ct_u256_sq_wide).
#pragma once

#include "common.cuh"
#include "fe_chain.cuh"
#include "secp256_field.cuh"

// r = a^2 mod 2^255 - 19 (r may alias a)
CT_HD void ct_25519_sq(ct_u256& r, const ct_u256& a) {
    uint32_t t[16];
    ct_u256_sq_wide(t, a);
    ct_25519_reduce(r, t);
}

struct ct_fe8 {
    using fe = ct_u256;
    static constexpr int kWords = 8;  // 32-bit words of an element
    static CT_HD void zero(fe& h) { ct_u256_zero(h); }
    static CT_HD void one(fe& h) {
        ct_u256_zero(h);
        h.v[0] = 1;
    }
    static CT_HD void add(fe& h, const fe& f, const fe& g) { ct_sp_add<ct_p25519>(h, f, g); }
    static CT_HD void sub(fe& h, const fe& f, const fe& g) { ct_sp_sub<ct_p25519>(h, f, g); }
    static CT_HD void neg(fe& h, const fe& f) { ct_sp_neg<ct_p25519>(h, f); }
    static CT_HD void mul(fe& h, const fe& f, const fe& g) { ct_sp_mul<ct_p25519>(h, f, g); }
    static CT_HD void sq(fe& h, const fe& f) { ct_25519_sq(h, f); }
    // f = bit ? g : f, without a branch
    static CT_HD void cmov(fe& f, const fe& g, int bit) {
        uint32_t mask = 0u - (uint32_t)(bit & 1);
#pragma unroll
        for (int i = 0; i < 8; i++) f.v[i] ^= mask & (f.v[i] ^ g.v[i]);
    }
    // h = bit ? -f : f
    static CT_HD void cneg(fe& h, const fe& f, int bit) {
        fe n;
        ct_sp_neg<ct_p25519>(n, f);
        h = f;
        cmov(h, n, bit);
    }
    static CT_HD int eq(const fe& f, const fe& g) { return ct_u256_eq(f, g); }
    static CT_HD int is_zero(const fe& f) { return ct_u256_is_zero(f); }
    static CT_HD int is_odd(const fe& f) { return (int)(f.v[0] & 1u); }
    static CT_HD void load(fe& h, const int32_t* table, int row) {
        ct_u256_load(h, table + 8 * row);
    }
    // the low 255 bits of 32 little-endian bytes, reduced below p (a value
    // in [p, 2^255) appears only on lanes the host precheck already failed)
    static CT_HD void from_bytes(fe& h, const uint8_t* s) {
        ct_u256 raw;
        ct_u256_from_bytes(raw, s);
        raw.v[7] &= 0x7FFFFFFFu;
        ct_sp_reduce_once<ct_p25519>(h, raw.v, 0);
    }
    // 1 iff the affine point (x, y) encodes as the 32 bytes r: y (canonical)
    // equal to r's low 255 bits, word for word, and the parity of x equal to
    // r's bit 255 (word 7, bit 31)
    static CT_HD int encodes(const fe& x, const fe& y, const uint8_t* r) {
        ct_u256 ry;
        ct_u256_from_bytes(ry, r);
        uint32_t sign = ry.v[7] >> 31;
        ry.v[7] &= 0x7FFFFFFFu;
        return ct_u256_eq(y, ry) & ((x.v[0] & 1u) == sign);
    }
    static CT_HD void inv(fe& out, const fe& z) { ct_pow_inv<ct_fe8>(out, z); }
    static CT_HD void pow_p58(fe& out, const fe& z) { ct_pow_p58<ct_fe8>(out, z); }
};
