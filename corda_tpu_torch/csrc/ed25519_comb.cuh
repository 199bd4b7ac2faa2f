// Kernel E's per-lane fixed-base scalar multiplication R = [r]B, shared by
// ed25519_comb.cu and host_check.cpp. It computes what the TPU kernel
// computes (corda_tpu/ops/ed25519_sign.py::_comb_kernel): 64 mixed adds,
// one per 4-bit window k of r, of the table entry [digit_k * 16^k]B in
// (y - x, y + x, 2dxy) form, starting from the identity, with no doublings;
// then one inversion and the encoding (canonical y, the parity of x in
// bit 255). Field and point code are kernel B's (fe25519.cuh,
// ed25519_ladder.cuh): ref10 limbs, not the TPU's 22 x 12-bit ones.
//
// r is the secret nonce of a signature, so nothing may depend on its
// digits but data: every window reads all 16 of its entries, in the same
// order, and keeps the wanted one with an all-ones/all-zeros mask, as the
// TPU kernel does with its select tree (ed25519_pallas.py::_select16). No
// load address and no branch depends on r; the digits come out of the
// scalar by shifts, not by indexing. (Kernel B indexes its tables
// directly: its scalars are public.)
#pragma once

#include "common.cuh"
#include "ed25519_ladder.cuh"
#include "fe25519.cuh"

#define CT_COMB_WINDOWS 64
#define CT_COMB_ENTRIES 16
// table row of field element c of entry j of window k (10 int32 limbs)
#define CT_COMB_ROW(k, j, c) (3 * (CT_COMB_ENTRIES * (k) + (j)) + (c))
#define CT_COMB_ROWS (3 * CT_COMB_ENTRIES * CT_COMB_WINDOWS)

// -1 (all ones) when a == b, else 0, with no branch
CT_HD int32_t ct_eq_mask(uint32_t a, uint32_t b) {
    uint32_t x = a ^ b;
    return (int32_t)(((x | (0u - x)) >> 31) - 1u);
}

// The entry for `digit` of window k, read as all 16 entries masked together.
CT_HD void ct_comb_select(ct_fe sel[3], const int32_t* table, int k,
                          uint32_t digit) {
#pragma unroll
    for (int c = 0; c < 3; c++) ct_fe_zero(sel[c]);
#pragma unroll 4
    for (int j = 0; j < CT_COMB_ENTRIES; j++) {
        int32_t m = ct_eq_mask(digit, (uint32_t)j);
        const int32_t* row = table + 10 * CT_COMB_ROW(k, j, 0);
#pragma unroll
        for (int i = 0; i < 30; i++) sel[i / 10].v[i % 10] |= ct_ldg(row + i) & m;
    }
}

// [r]B for the 32-byte little-endian scalar `r` (any value below 2^256),
// written as its 32-byte encoding.
CT_HD void ct_comb_lane(uint8_t out[32], const uint8_t* r,
                        const int32_t* table) {
    // the scalar as eight words, shifted down one window at a time
    uint32_t s[8];
#pragma unroll
    for (int i = 0; i < 8; i++)
        s[i] = (uint32_t)r[4 * i] | ((uint32_t)r[4 * i + 1] << 8) |
               ((uint32_t)r[4 * i + 2] << 16) | ((uint32_t)r[4 * i + 3] << 24);
    ct_ge acc;
    ct_ge_identity(acc);
#pragma unroll 1
    for (int k = 0; k < CT_COMB_WINDOWS; k++) {
        ct_fe sel[3];
        ct_comb_select(sel, table, k, s[0] & 15u);
        ct_ge_add_entry(acc, acc, sel[0], sel[1], sel[2]);
#pragma unroll
        for (int i = 0; i < 7; i++) s[i] = (s[i] >> 4) | (s[i + 1] << 28);
        s[7] >>= 4;
    }
    ct_fe zinv, x, y;
    ct_fe_inv(zinv, acc.Z);
    ct_fe_mul(x, acc.X, zinv);
    ct_fe_mul(y, acc.Y, zinv);
    ct_fe_to_bytes(out, y);
    out[31] |= (uint8_t)(ct_fe_is_odd(x) << 7);
}
