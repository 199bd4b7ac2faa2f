// Kernel B's per-lane ed25519 verification, shared by ed25519_verify.cu and
// host_check.cpp. It computes what the TPU reference kernel computes
// (corda_tpu/ops/ed25519_pallas13.py::_make_verify_kernel):
//
//   decompress A (reject x = 0 with sign 1), [s]B + [h](-A) with h already
//   reduced mod L, encode, and accept iff y equals R's low 255 bits and the
//   parity of x equals R's bit 255, and the host precheck passed.
//
// Same ladder shape as the reference: 4-bit windows of h over a 16-entry
// table of multiples of -A in (Y-X, Y+X, 2dT, 2Z) form, and an 8-bit
// fixed-base comb of s (256 affine multiples of B, one mixed add on every
// even window), four doublings per window. Unlike the TPU kernel, which
// selects table entries with a 256-way select tree because its lanes are
// SIMD, a lane here indexes its entries directly: every index is public
// data, so the load need not be constant-time.
#pragma once

#include "common.cuh"
#include "fe25519.cuh"

// Constant-table layout (int32 rows of 10 limbs; built by
// corda_tpu_torch/ops/ed25519_ladder.py::build_table):
#define CT_ROW_D 0        // d
#define CT_ROW_D2 1       // 2d
#define CT_ROW_SQRT_M1 2  // sqrt(-1)
#define CT_ROW_COMB 3     // rows 3 + 3v .. 5 + 3v: v*B as (y-x, y+x, 2dxy)
#define CT_TABLE_ROWS (3 + 3 * 256)

struct ct_ge {  // extended twisted-Edwards (X : Y : Z : T)
    ct_fe X, Y, Z, T;
};

CT_HD void ct_ge_identity(ct_ge& p) {
    ct_fe_zero(p.X);
    ct_fe_one(p.Y);
    ct_fe_one(p.Z);
    ct_fe_zero(p.T);
}

// dbl-2008-hwcd; never reads T, and writes T only when want_t.
CT_HD void ct_ge_double(ct_ge& r, const ct_ge& p, int want_t) {
    ct_fe a, b, c, h, e, g, f, t;
    ct_fe_sq(a, p.X);
    ct_fe_sq(b, p.Y);
    ct_fe_sq(t, p.Z);
    ct_fe_add(c, t, t);
    ct_fe_add(h, a, b);
    ct_fe_add(t, p.X, p.Y);
    ct_fe_sq(t, t);
    ct_fe_sub(e, h, t);
    ct_fe_sub(g, a, b);
    ct_fe_add(f, c, g);
    if (want_t) ct_fe_mul(r.T, e, h);
    ct_fe_mul(r.X, e, f);
    ct_fe_mul(r.Y, g, h);
    ct_fe_mul(r.Z, f, g);
}

// Shared tail of the unified add-2008-hwcd-3 forms.
CT_HD void ct_ge_add_tail(ct_ge& r, const ct_fe& a, const ct_fe& bb,
                          const ct_fe& c, const ct_fe& d) {
    ct_fe e, f, g, h;
    ct_fe_sub(e, bb, a);
    ct_fe_sub(f, d, c);
    ct_fe_add(g, d, c);
    ct_fe_add(h, bb, a);
    ct_fe_mul(r.X, e, f);
    ct_fe_mul(r.Y, g, h);
    ct_fe_mul(r.Z, f, g);
    ct_fe_mul(r.T, e, h);
}

// r = p + q, both in extended coordinates (9 multiplies).
CT_HD void ct_ge_add(ct_ge& r, const ct_ge& p, const ct_ge& q,
                     const ct_fe& d2) {
    ct_fe t0, t1, a, bb, c, d;
    ct_fe_sub(t0, p.Y, p.X);
    ct_fe_sub(t1, q.Y, q.X);
    ct_fe_mul(a, t0, t1);
    ct_fe_add(t0, p.Y, p.X);
    ct_fe_add(t1, q.Y, q.X);
    ct_fe_mul(bb, t0, t1);
    ct_fe_mul(t0, p.T, d2);
    ct_fe_mul(c, t0, q.T);
    ct_fe_mul(t0, p.Z, q.Z);
    ct_fe_add(d, t0, t0);
    ct_ge_add_tail(r, a, bb, c, d);
}

// p as an addend: (Y - X, Y + X, 2dT, 2Z), written over q.
CT_HD void ct_ge_to_planes(ct_fe q[4], const ct_ge& p, const ct_fe& d2) {
    ct_fe ymx, ypx, t2d, z2;
    ct_fe_sub(ymx, p.Y, p.X);
    ct_fe_add(ypx, p.Y, p.X);
    ct_fe_mul(t2d, p.T, d2);
    ct_fe_add(z2, p.Z, p.Z);
    q[0] = ymx;
    q[1] = ypx;
    q[2] = t2d;
    q[3] = z2;
}

// r = p + q with q in plane form (8 multiplies).
CT_HD void ct_ge_add_planes(ct_ge& r, const ct_ge& p, const ct_fe q[4]) {
    ct_fe t, a, bb, c, d;
    ct_fe_sub(t, p.Y, p.X);
    ct_fe_mul(a, t, q[0]);
    ct_fe_add(t, p.Y, p.X);
    ct_fe_mul(bb, t, q[1]);
    ct_fe_mul(c, p.T, q[2]);
    ct_fe_mul(d, p.Z, q[3]);
    ct_ge_add_tail(r, a, bb, c, d);
}

// r = p + q for an affine q given as (y - x, y + x, 2dxy): the mixed add
// (7 multiplies). Shared by the verify comb and the signing comb.
CT_HD void ct_ge_add_entry(ct_ge& r, const ct_ge& p, const ct_fe& ymx,
                           const ct_fe& ypx, const ct_fe& t2d) {
    ct_fe t, a, bb, c, d;
    ct_fe_sub(t, p.Y, p.X);
    ct_fe_mul(a, t, ymx);
    ct_fe_add(t, p.Y, p.X);
    ct_fe_mul(bb, t, ypx);
    ct_fe_mul(c, p.T, t2d);
    ct_fe_add(d, p.Z, p.Z);
    ct_ge_add_tail(r, a, bb, c, d);
}

// r = p + v*B, the comb entry v of the constant table.
CT_HD void ct_ge_add_comb(ct_ge& r, const ct_ge& p, const int32_t* table,
                          int v) {
    ct_fe ymx, ypx, t2d;
    int row = CT_ROW_COMB + 3 * v;
    ct_fe_load(ymx, table, row);
    ct_fe_load(ypx, table, row + 1);
    ct_fe_load(t2d, table, row + 2);
    ct_ge_add_entry(r, p, ymx, ypx, t2d);
}

// RFC 8032 5.1.3 with the reference's exact acceptance rule: y limbs
// (y < p is checked on the host) and the sign bit -> (x, ok). Lanes with
// no square root, or x = 0 with sign 1, come back !ok with a harmless x.
CT_HD int ct_decompress(ct_fe& x, const ct_fe& y, int sign,
                        const int32_t* table) {
    ct_fe one, d, sqrt_m1, y2, u, v, v3, v7, t, pw, vx2, neg;
    ct_fe_one(one);
    ct_fe_load(d, table, CT_ROW_D);
    ct_fe_load(sqrt_m1, table, CT_ROW_SQRT_M1);
    ct_fe_sq(y2, y);
    ct_fe_sub(u, y2, one);
    ct_fe_mul(t, d, y2);
    ct_fe_add(v, t, one);
    ct_fe_sq(t, v);
    ct_fe_mul(v3, t, v);
    ct_fe_sq(t, v3);
    ct_fe_mul(v7, t, v);
    ct_fe_mul(t, u, v7);
    ct_fe_pow_p58(pw, t);
    ct_fe_mul(t, u, v3);
    ct_fe_mul(x, t, pw);
    ct_fe_sq(t, x);
    ct_fe_mul(vx2, v, t);
    int root_ok = ct_fe_eq(vx2, u);
    ct_fe_neg(neg, u);
    int flip_ok = ct_fe_eq(vx2, neg);
    ct_fe_mul(t, x, sqrt_m1);
    ct_fe_cmov(x, t, flip_ok);
    int ok = root_ok | flip_ok;
    ok &= !(ct_fe_is_zero(x) & (sign == 1));
    ct_fe_neg(neg, x);
    ct_fe_cmov(x, neg, ct_fe_is_odd(x) != sign);
    return ok;
}

// The whole verification of one lane. `row` is the lane's packed row;
// window k of h is hwin[k * hstride]; `tbl` is scratch for the 16-entry
// table of -A (local memory on the card).
CT_HD uint8_t ct_verify_lane(const uint8_t* row, const int32_t* hwin,
                             int hstride, const int32_t* table,
                             ct_fe tbl[16][4]) {
    const uint8_t* r_bytes = row;
    const uint8_t* a_bytes = row + 32;
    const uint8_t* s_bytes = row + 128;
    int precheck = row[160] == 1;

    ct_fe d2, y, x;
    ct_fe_load(d2, table, CT_ROW_D2);
    ct_fe_from_bytes(y, a_bytes);
    int sign = a_bytes[31] >> 7;
    int a_ok = ct_decompress(x, y, sign, table);

    // -A = (-x, y, 1, -xy)
    ct_ge minus_a, acc, pt;
    ct_fe_neg(minus_a.X, x);
    minus_a.Y = y;
    ct_fe_one(minus_a.Z);
    ct_fe_mul(minus_a.T, minus_a.X, y);

    // k * (-A) for k = 0..15: doublings on even k, adds on odd k. The
    // points live in `tbl` (as X, Y, Z, T) until all 16 exist, then each is
    // rewritten in place into plane form.
    ct_ge_identity(pt);
    tbl[0][0] = pt.X; tbl[0][1] = pt.Y; tbl[0][2] = pt.Z; tbl[0][3] = pt.T;
    tbl[1][0] = minus_a.X; tbl[1][1] = minus_a.Y;
    tbl[1][2] = minus_a.Z; tbl[1][3] = minus_a.T;
#pragma unroll 1
    for (int k = 2; k < 16; k++) {
        if (k & 1) {
            int j = k - 1;
            pt.X = tbl[j][0]; pt.Y = tbl[j][1]; pt.Z = tbl[j][2]; pt.T = tbl[j][3];
            ct_ge_add(pt, pt, minus_a, d2);
        } else {
            int j = k >> 1;
            pt.X = tbl[j][0]; pt.Y = tbl[j][1]; pt.Z = tbl[j][2]; pt.T = tbl[j][3];
            ct_ge_double(pt, pt, 1);
        }
        tbl[k][0] = pt.X; tbl[k][1] = pt.Y; tbl[k][2] = pt.Z; tbl[k][3] = pt.T;
    }
#pragma unroll 1
    for (int k = 0; k < 16; k++) {
        pt.X = tbl[k][0]; pt.Y = tbl[k][1]; pt.Z = tbl[k][2]; pt.T = tbl[k][3];
        ct_ge_to_planes(tbl[k], pt, d2);
    }

    // windows from the top: four doublings (T only on the last), the comb
    // add of s's byte on even windows, the table add of h's window
    ct_ge_identity(acc);
#pragma unroll 1
    for (int w = CT_WINDOWS - 1; w >= 0; w--) {
        ct_ge_double(acc, acc, 0);
        ct_ge_double(acc, acc, 0);
        ct_ge_double(acc, acc, 0);
        ct_ge_double(acc, acc, 1);
        if ((w & 1) == 0) ct_ge_add_comb(acc, acc, table, s_bytes[w >> 1]);
        ct_ge_add_planes(acc, acc, tbl[hwin[w * hstride] & 15]);
    }

    // encode: canonical y and the parity of x, against R
    ct_fe zinv, ex, ey, ry;
    ct_fe_inv(zinv, acc.Z);
    ct_fe_mul(ex, acc.X, zinv);
    ct_fe_mul(ey, acc.Y, zinv);
    ct_fe_canonical(ex, ex);
    ct_fe_canonical(ey, ey);
    ct_fe_bits_of_bytes(ry, r_bytes);
    int32_t diff = 0;
#pragma unroll
    for (int i = 0; i < 10; i++) diff |= ey.v[i] ^ ry.v[i];
    int match = (diff == 0) & ((ex.v[0] & 1) == (r_bytes[31] >> 7));
    return (uint8_t)(a_ok & match & precheck);
}
