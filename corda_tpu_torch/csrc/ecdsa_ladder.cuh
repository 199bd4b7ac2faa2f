// The ECDSA verify of one lane for kernel F: complete projective point
// formulas (Renes-Costello-Batina 2016, Algorithms 1 and 3, the sequence of
// corda_tpu/ops/secp256_pallas.py::point_add :935 and point_double :967,
// and of ops/secp256_ladder.py's plain version), the 16-entry k*Q table,
// the joint MSB-first walk of 64 four-bit windows with the 8-bit G comb on
// even windows, and the two-candidate accept. Shared by the CUDA kernel and
// host_check.cpp.
//
// a = 0 (secp256k1) folds its terms away at compile time; a = -3
// (secp256r1) is -(v + v + v). Every field value is canonical, so the
// accept compare is a word compare.
#pragma once

#include "secp256_field.cuh"

// the packed verify plane: qx, qy, u1, u2, r, r + n (32 bytes each,
// little-endian), rb_ok, precheck
#define CT_ECDSA_ROW 194
#define CT_ECDSA_RB_OK 192
#define CT_ECDSA_PRE 193

// the constant table, rows of 8 words: p, b, 3b, then comb entry v as rows
// 3 + 3v (X), 4 + 3v (Y), 5 + 3v (Z)
#define CT_ECDSA_ROW_B 1
#define CT_ECDSA_ROW_B3 2
#define CT_ECDSA_ROW_COMB 3

struct ct_sp_point {
    ct_u256 x, y, z;
};

template <class C>
CT_HD void ct_sp_mul_a(ct_u256& r, const ct_u256& v) {
    ct_u256 t;
    ct_sp_add<C>(t, v, v);
    ct_sp_add<C>(t, t, v);
    ct_sp_neg<C>(r, t);
}

// RCB16 Algorithm 1: r = p + q for all inputs (r may alias p or q).
template <class C>
CT_HD void ct_sp_point_add(ct_sp_point& r, const ct_sp_point& p, const ct_sp_point& q,
                           const ct_u256& b3) {
    ct_u256 t0, t1, t2, t3, t4, t5, u, v, x3, y3, z3;
    ct_sp_mul<C>(t0, p.x, q.x);
    ct_sp_mul<C>(t1, p.y, q.y);
    ct_sp_mul<C>(t2, p.z, q.z);
    ct_sp_add<C>(u, p.x, p.y);
    ct_sp_add<C>(v, q.x, q.y);
    ct_sp_mul<C>(t3, u, v);
    ct_sp_add<C>(u, t0, t1);
    ct_sp_sub<C>(t3, t3, u);
    ct_sp_add<C>(u, p.x, p.z);
    ct_sp_add<C>(v, q.x, q.z);
    ct_sp_mul<C>(t4, u, v);
    ct_sp_add<C>(u, t0, t2);
    ct_sp_sub<C>(t4, t4, u);
    ct_sp_add<C>(u, p.y, p.z);
    ct_sp_add<C>(v, q.y, q.z);
    ct_sp_mul<C>(t5, u, v);
    ct_sp_add<C>(u, t1, t2);
    ct_sp_sub<C>(t5, t5, u);
    ct_sp_mul_b3<C>(z3, t2, b3);
    if constexpr (!C::kAZero) {
        ct_sp_mul_a<C>(u, t4);
        ct_sp_add<C>(z3, z3, u);
    }
    ct_sp_sub<C>(x3, t1, z3);
    ct_sp_add<C>(z3, t1, z3);
    ct_sp_mul<C>(y3, x3, z3);
    ct_sp_add<C>(t1, t0, t0);
    ct_sp_add<C>(t1, t1, t0);
    ct_sp_mul_b3<C>(t4, t4, b3);
    if constexpr (!C::kAZero) {
        ct_u256 t2a;
        ct_sp_mul_a<C>(t2a, t2);
        ct_sp_add<C>(t1, t1, t2a);
        ct_sp_sub<C>(u, t0, t2a);
        ct_sp_mul_a<C>(u, u);
        ct_sp_add<C>(t4, t4, u);
    }
    ct_sp_mul<C>(u, t1, t4);
    ct_sp_add<C>(y3, y3, u);
    ct_sp_mul<C>(u, x3, t3);
    ct_sp_mul<C>(v, t5, t4);
    ct_sp_sub<C>(r.x, u, v);
    ct_sp_mul<C>(u, t5, z3);
    ct_sp_mul<C>(v, t3, t1);
    ct_sp_add<C>(r.z, u, v);
    r.y = y3;
}

// RCB16 Algorithm 3: r = 2p for all inputs (r may alias p).
template <class C>
CT_HD void ct_sp_point_double(ct_sp_point& r, const ct_sp_point& p, const ct_u256& b3) {
    ct_u256 t0, t1, t2, t3, u, x3, y3, z3;
    ct_sp_mul<C>(t0, p.x, p.x);
    ct_sp_mul<C>(t1, p.y, p.y);
    ct_sp_mul<C>(t2, p.z, p.z);
    ct_sp_mul<C>(t3, p.x, p.y);
    ct_sp_add<C>(t3, t3, t3);
    ct_sp_mul<C>(z3, p.x, p.z);
    ct_sp_add<C>(z3, z3, z3);
    ct_sp_mul_b3<C>(y3, t2, b3);
    if constexpr (!C::kAZero) {
        ct_sp_mul_a<C>(u, z3);
        ct_sp_add<C>(y3, y3, u);
    }
    ct_sp_sub<C>(x3, t1, y3);
    ct_sp_add<C>(y3, t1, y3);
    ct_sp_mul<C>(y3, x3, y3);
    ct_sp_mul<C>(x3, t3, x3);
    ct_sp_mul_b3<C>(z3, z3, b3);
    ct_sp_add<C>(u, t0, t0);
    if constexpr (C::kAZero) {
        t3 = z3;
        ct_sp_add<C>(t0, u, t0);
    } else {
        ct_u256 t2a;
        ct_sp_mul_a<C>(t2a, t2);
        ct_sp_sub<C>(t3, t0, t2a);
        ct_sp_mul_a<C>(t3, t3);
        ct_sp_add<C>(t3, t3, z3);
        ct_sp_add<C>(t0, u, t0);
        ct_sp_add<C>(t0, t0, t2a);
    }
    ct_sp_mul<C>(u, t0, t3);
    ct_sp_add<C>(y3, y3, u);
    ct_sp_mul<C>(t2, p.y, p.z);
    ct_sp_add<C>(t2, t2, t2);
    ct_sp_mul<C>(u, t2, t3);
    ct_sp_sub<C>(r.x, x3, u);
    ct_sp_mul<C>(u, t2, t1);
    ct_sp_add<C>(u, u, u);
    ct_sp_add<C>(r.z, u, u);
    r.y = y3;
}

// 32 little-endian bytes as a field element: a value in [p, 2^256) is
// reduced, so any bytes read as their value mod p (the host's prep only
// ever sends values below p).
template <class C>
CT_HD void ct_sp_from_bytes(ct_u256& r, const uint8_t* b) {
    ct_u256 raw;
    ct_u256_from_bytes(raw, b);
    ct_sp_reduce_once<C>(r, raw.v, 0);
}

CT_HD void ct_sp_load_entry(ct_sp_point& r, const int32_t* table, int v) {
    const int32_t* row = table + (CT_ECDSA_ROW_COMB + 3 * v) * 8;
    ct_u256_load(r.x, row);
    ct_u256_load(r.y, row + 8);
    ct_u256_load(r.z, row + 16);
}

// One lane's verdict (1 accept, 0 reject): `row` is its packed 194 bytes,
// `table` the curve's constant table, `qtab` 16 points of scratch (the
// k*Q table). A lane whose precheck failed returns before any arithmetic.
template <class C>
CT_HD int ct_ecdsa_verify_lane(const uint8_t* row, const int32_t* table,
                               ct_sp_point qtab[16]) {
    if (row[CT_ECDSA_PRE] != 1) return 0;
    ct_u256 b3, qx, qy, t, u;
    ct_u256_load(b3, table + CT_ECDSA_ROW_B3 * 8);
    ct_sp_from_bytes<C>(qx, row);
    ct_sp_from_bytes<C>(qy, row + 32);

    // on the curve: y^2 == x^3 + a x + b
    ct_sp_mul<C>(t, qx, qx);
    ct_sp_mul<C>(t, t, qx);
    ct_u256_load(u, table + CT_ECDSA_ROW_B * 8);
    ct_sp_add<C>(t, t, u);
    if constexpr (!C::kAZero) {
        ct_sp_mul_a<C>(u, qx);
        ct_sp_add<C>(t, t, u);
    }
    ct_sp_mul<C>(u, qy, qy);
    if (!ct_u256_eq(t, u)) return 0;

    // k*Q for k = 0..15: 7 doublings, 7 additions
    ct_u256_zero(qtab[0].x);
    ct_u256_zero(qtab[0].y);
    qtab[0].y.v[0] = 1;
    ct_u256_zero(qtab[0].z);
    qtab[1].x = qx;
    qtab[1].y = qy;
    ct_u256_zero(qtab[1].z);
    qtab[1].z.v[0] = 1;
#pragma unroll 1
    for (int k = 2; k < 16; k++) {
        if (k % 2 == 0)
            ct_sp_point_double<C>(qtab[k], qtab[k / 2], b3);
        else
            ct_sp_point_add<C>(qtab[k], qtab[k - 1], qtab[1], b3);
    }

    const uint8_t* u1 = row + 64;
    const uint8_t* u2 = row + 96;
    ct_sp_point acc = qtab[0], entry;
#pragma unroll 1
    for (int w = CT_WINDOWS - 1; w >= 0; w--) {
#pragma unroll 1
        for (int i = 0; i < 4; i++) ct_sp_point_double<C>(acc, acc, b3);
        if ((w & 1) == 0) {
            // the comb digit u1[w] + 16 u1[w + 1] is byte w / 2 of u1
            ct_sp_load_entry(entry, table, u1[w >> 1]);
            ct_sp_point_add<C>(acc, acc, entry, b3);
        }
        int d = (u2[w >> 1] >> (4 * (w & 1))) & 15;
        ct_sp_point_add<C>(acc, acc, qtab[d], b3);
    }

    // accept: Z != 0 and (X == r Z or (rb_ok and X == (r + n) Z))
    if (ct_u256_is_zero(acc.z)) return 0;
    ct_sp_from_bytes<C>(u, row + 128);
    ct_sp_mul<C>(t, u, acc.z);
    if (ct_u256_eq(t, acc.x)) return 1;
    if (row[CT_ECDSA_RB_OK] != 1) return 0;
    ct_sp_from_bytes<C>(u, row + 160);
    ct_sp_mul<C>(t, u, acc.z);
    return ct_u256_eq(t, acc.x);
}
