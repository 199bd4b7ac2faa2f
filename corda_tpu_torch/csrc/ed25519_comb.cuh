// Kernel E's fixed-base scalar multiplication R = [r]B on a group of quads,
// shared by ed25519_comb.cu and host_check.cpp. It computes what the TPU
// kernel computes (corda_tpu/ops/ed25519_sign.py::_comb_kernel): the sum,
// over the 64 4-bit windows k of r, of the table entry [digit_k * 16^k]B
// in (y - x, y + x, 2dxy) form, with no doublings; then one inversion and
// the encoding (canonical y, the parity of x in bit 255). Field code is
// kernel B's ten-limb field (fe25519.cuh), point code the four-way formulas
// of ed25519_quad.cuh.
//
// The comb has no doublings, so [r]B = sum_k [d_k 16^k]B splits into
// partial sums in any way. CT_COMB_SUMS partial sums a signature, each a
// run of CT_COMB_SPAN consecutive windows held by one quad of threads (one
// point coordinate a thread, ct_x4 as in kernels B and G): every window
// adds its entry as a plane-form add whose fourth element is 2 (the mixed
// add's Z + Z). The partial sums are then combined in log2(CT_COMB_SUMS)
// rounds, each partner converted to plane form (q_to_planes) and added with
// q_add_planes. Those formulas are complete on ed25519, so identity partial
// sums need no special case. The inversion and the encoding run once a
// signature, whole on every thread of its last quad, in kernel G's
// eight-word field (fe25519_w8.cuh): its inversion chain, one dependent
// run of 265 field operations, takes less time on the card than the
// ten-limb field's, and the chain is most of the kernel's time.
//
// r is the secret nonce of a signature, so nothing may depend on its
// digits but data: every window reads all 16 of its entries, in the same
// order, and keeps the wanted one with an all-ones/all-zeros mask, as the
// TPU kernel does with its select tree (ed25519_pallas.py::_select16). No
// load address, branch or shuffle partner depends on r: the digits come
// out of the scalar by shifts, a thread's window and coordinate come from
// its thread index, and the combine's partner is a fixed quad. (Kernel B
// indexes its tables directly: its scalars are public.)
//
// One source for both compilers, as ct_x4 is: on the card a thread holds
// one element of its quad's vector; on the host (host_check.cpp) a vector
// holds all four, and ct_comb_lane computes the partial sums in turn and
// combines them in the kernel's order.
#pragma once

#include "common.cuh"
#include "ed25519_quad.cuh"
#include "fe25519.cuh"
#include "fe25519_w8.cuh"

#define CT_COMB_WINDOWS 64
#define CT_COMB_ENTRIES 16
// table row of field element c of entry j of window k (10 int32 limbs)
#define CT_COMB_ROW(k, j, c) (3 * (CT_COMB_ENTRIES * (k) + (j)) + (c))
#define CT_COMB_ROWS (3 * CT_COMB_ENTRIES * CT_COMB_WINDOWS)
// partial sums a signature, and the windows of each (a partial sum's
// digits must fit 64 bits: 4, 8 or 16 sums; 4 measured fastest)
#define CT_COMB_SUMS 4
#define CT_COMB_SPAN (CT_COMB_WINDOWS / CT_COMB_SUMS)

using ct_q10 = ct_x4<ct_fe10>;

// -1 (all ones) when a == b, else 0, with no branch
CT_HD int32_t ct_eq_mask(uint32_t a, uint32_t b) {
    uint32_t x = a ^ b;
    return (int32_t)(((x | (0u - x)) >> 31) - 1u);
}

// 2d (ref10's d2): the plane form's third factor; the comb table holds
// entries only
CT_HD void ct_fe_d2(ct_fe& h) {
    h.v[0] = -21827239; h.v[1] = -5839606; h.v[2] = -30745221; h.v[3] = 13898782;
    h.v[4] = 229458;    h.v[5] = 15978800; h.v[6] = -12551817; h.v[7] = -6495438;
    h.v[8] = 29715968;  h.v[9] = 9444199;
}

// sel |= row & m over one 10-limb row (8-byte loads through the read-only
// cache on the card: a row is 40 bytes, so every row is 8-byte aligned)
CT_HD void ct_comb_or_row(ct_fe& sel, const int32_t* row, int32_t m) {
#if defined(__CUDA_ARCH__)
    const int2* p = reinterpret_cast<const int2*>(row);
#pragma unroll
    for (int h = 0; h < 5; h++) {
        int2 w = __ldg(p + h);
        sel.v[2 * h] |= w.x & m;
        sel.v[2 * h + 1] |= w.y & m;
    }
#else
    for (int i = 0; i < 10; i++) sel.v[i] |= row[i] & m;
#endif
}

// Element `lane` of the plane form of the entry for `digit` of window k:
// (y - x, y + x, 2dxy) for lanes 0-2, read as all 16 entries masked
// together (a thread reads only its own element's rows); 2 for lane 3,
// which reads nothing.
CT_HD void ct_comb_select(ct_fe& sel, const int32_t* table, int k, uint32_t digit, int lane) {
    ct_fe_zero(sel);
    if (lane == 3) {
        sel.v[0] = 2;
        return;
    }
#pragma unroll 4
    for (int j = 0; j < CT_COMB_ENTRIES; j++)
        ct_comb_or_row(sel, table + 10 * CT_COMB_ROW(k, j, lane), ct_eq_mask(digit, (uint32_t)j));
}

// Partial sum s of [r]B: the identity plus, for each window k of
// s * CT_COMB_SPAN .. (s + 1) * CT_COMB_SPAN - 1, its entry for digit
// `digits & 15`, `digits` shifted down a window at a time (the bits of r
// that hold those windows, little-endian).
CT_QD void ct_comb_partial(ct_q10& acc, uint64_t digits, const int32_t* table, int s) {
#pragma unroll
    for (int j = 0; j < CT_QUAD_N; j++) {
        int lane = ct_qlane(j);
        ct_fe_zero(acc.e[j]);
        acc.e[j].v[0] = lane == 1 || lane == 2;  // (0, 1, 1, 0)
    }
#pragma unroll 1
    for (int i = 0; i < CT_COMB_SPAN; i++) {
        ct_q10 q;
#pragma unroll
        for (int j = 0; j < CT_QUAD_N; j++)
            ct_comb_select(q.e[j], table, s * CT_COMB_SPAN + i, (uint32_t)digits & 15u,
                           ct_qlane(j));
        q_add_planes(acc, acc, q);
        digits >>= 4;
    }
}

// The bits of r (32 little-endian bytes) that hold partial sum s's windows.
CT_HD uint64_t ct_comb_digits(const uint8_t* r, int s) {
    const int bytes = CT_COMB_SPAN / 2;
    uint64_t d = 0;
#pragma unroll
    for (int b = 0; b < bytes; b++) d |= (uint64_t)r[bytes * s + b] << (8 * b);
    return d;
}

// acc += other (both extended points of a quad): other to plane form, then
// a plane-form add
CT_QD void ct_comb_combine(ct_q10& acc, const ct_q10& other) {
    ct_fe one, two, d2;
    ct_fe_one(one);
    ct_fe_zero(two);
    two.v[0] = 2;
    ct_fe_d2(d2);
    ct_q10 k, p;
    q_set(k, one, one, d2, two);
    q_to_planes(p, other, k);
    q_add_planes(acc, acc, p);
}

// A ten-limb element as an eight-word one (both canonical in [0, p)).
CT_HD void ct_fe_to_w8(ct_u256& h, const ct_fe& f) {
    uint8_t b[32];
    ct_fe_to_bytes(b, f);
    ct_fe8::from_bytes(h, b);
}

// The encoding of the quad's point, whole on every thread in the
// eight-word field: 1/Z, then x and y (canonical), y's bytes and the parity
// of x in bit 255.
CT_QD void ct_comb_encode(uint8_t out[32], const ct_q10& acc) {
    ct_fe X, Y, Z;
    q_lane<0>(X, acc);
    q_lane<1>(Y, acc);
    q_lane<2>(Z, acc);
    ct_u256 x, y, z, zinv;
    ct_fe_to_w8(x, X);
    ct_fe_to_w8(y, Y);
    ct_fe_to_w8(z, Z);
    ct_fe8::inv(zinv, z);
    ct_fe8::mul(x, x, zinv);
    ct_fe8::mul(y, y, zinv);
    ct_u256_to_bytes(out, y);
    out[31] |= (uint8_t)((x.v[0] & 1u) << 7);
}

#if !defined(__CUDACC__)
// The host's [r]B for a 32-byte little-endian scalar (any value below
// 2^256): the partial sums in turn, combined in the kernel's rounds
// (round h: sum w += sum w + h, for w < h, h = CT_COMB_SUMS / 2 .. 1).
inline void ct_comb_lane(uint8_t out[32], const uint8_t* r, const int32_t* table) {
    ct_q10 sums[CT_COMB_SUMS];
    for (int s = 0; s < CT_COMB_SUMS; s++)
        ct_comb_partial(sums[s], ct_comb_digits(r, s), table, s);
    for (int h = CT_COMB_SUMS / 2; h >= 1; h >>= 1)
        for (int w = 0; w < h; w++) ct_comb_combine(sums[w], sums[w + h]);
    ct_comb_encode(out, sums[0]);
}
#endif
