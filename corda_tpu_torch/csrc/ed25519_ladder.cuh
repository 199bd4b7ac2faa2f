// The per-lane ed25519 verification of kernels B and G, shared by
// ed25519_verify.cu, ed25519_verify_g.cu and host_check.cpp, and the point
// code kernel E's comb (ed25519_comb.cuh) borrows. It computes what the TPU
// reference kernels compute (corda_tpu/ops/ed25519_pallas13.py and
// corda_tpu/ops/ed25519_pallas.py, each ::_make_verify_kernel):
//
//   decompress A (reject x = 0 with sign 1), [s]B + [h](-A) with h already
//   reduced mod L, encode, and accept iff y equals R's low 255 bits and the
//   parity of x equals R's bit 255, and the host precheck passed.
//
// Templated on the field, as the reference's two tiers are two field
// representations of one ladder: F is a trait (ct_fe10 in fe25519.cuh,
// ref10 limbs, kernel B; ct_fe8 in fe25519_w8.cuh, eight 32-bit words,
// kernel G) giving F::fe and its operations. Same ladder shape as the
// reference: 4-bit windows of h over a 16-entry table of multiples of -A in
// (Y-X, Y+X, 2dT, 2Z) form, four doublings per window, and the fixed base B
// in one of the reference's two shapes (kFixedWin): the 8-bit comb of s
// (256 affine multiples of B, one mixed add on every even window with the
// digit s[k] + 16 s[k+1]) or the 16-entry window (the comb's first 16
// entries, one mixed add every window). Unlike the TPU kernels, which select
// table entries with a select tree because their lanes are SIMD, a lane
// here indexes its entries directly: every index is public data, so the
// load need not be constant-time.
#pragma once

#include "common.cuh"
#include "fe25519.cuh"

// Constant-table layout (int32 rows of one field element each: 10 limbs for
// kernel B, 8 words for kernel G; built by corda_tpu_torch/ops/
// ed25519_ladder.py and ed25519_ladder4096.py, each ::build_table):
#define CT_ROW_D 0        // d
#define CT_ROW_D2 1       // 2d
#define CT_ROW_SQRT_M1 2  // sqrt(-1)
#define CT_ROW_COMB 3     // rows 3 + 3v .. 5 + 3v: v*B as (y-x, y+x, 2dxy)
#define CT_TABLE_ROWS (3 + 3 * 256)

template <class F>
struct ct_point {  // extended twisted-Edwards (X : Y : Z : T)
    typename F::fe X, Y, Z, T;
};

using ct_ge = ct_point<ct_fe10>;

template <class F>
CT_HD void ct_ge_identity(ct_point<F>& p) {
    F::zero(p.X);
    F::one(p.Y);
    F::one(p.Z);
    F::zero(p.T);
}

// dbl-2008-hwcd; never reads T, and writes T only when want_t.
template <class F>
CT_HD void ct_ge_double(ct_point<F>& r, const ct_point<F>& p, int want_t) {
    typename F::fe a, b, c, h, e, g, f, t;
    F::sq(a, p.X);
    F::sq(b, p.Y);
    F::sq(t, p.Z);
    F::add(c, t, t);
    F::add(h, a, b);
    F::add(t, p.X, p.Y);
    F::sq(t, t);
    F::sub(e, h, t);
    F::sub(g, a, b);
    F::add(f, c, g);
    if (want_t) F::mul(r.T, e, h);
    F::mul(r.X, e, f);
    F::mul(r.Y, g, h);
    F::mul(r.Z, f, g);
}

// Shared tail of the unified add-2008-hwcd-3 forms.
template <class F>
CT_HD void ct_ge_add_tail(ct_point<F>& r, const typename F::fe& a,
                          const typename F::fe& bb, const typename F::fe& c,
                          const typename F::fe& d) {
    typename F::fe e, f, g, h;
    F::sub(e, bb, a);
    F::sub(f, d, c);
    F::add(g, d, c);
    F::add(h, bb, a);
    F::mul(r.X, e, f);
    F::mul(r.Y, g, h);
    F::mul(r.Z, f, g);
    F::mul(r.T, e, h);
}

// r = p + q, both in extended coordinates (9 multiplies).
template <class F>
CT_HD void ct_ge_add(ct_point<F>& r, const ct_point<F>& p, const ct_point<F>& q,
                     const typename F::fe& d2) {
    typename F::fe t0, t1, a, bb, c, d;
    F::sub(t0, p.Y, p.X);
    F::sub(t1, q.Y, q.X);
    F::mul(a, t0, t1);
    F::add(t0, p.Y, p.X);
    F::add(t1, q.Y, q.X);
    F::mul(bb, t0, t1);
    F::mul(t0, p.T, d2);
    F::mul(c, t0, q.T);
    F::mul(t0, p.Z, q.Z);
    F::add(d, t0, t0);
    ct_ge_add_tail(r, a, bb, c, d);
}

// p as an addend: (Y - X, Y + X, 2dT, 2Z), written over q.
template <class F>
CT_HD void ct_ge_to_planes(typename F::fe q[4], const ct_point<F>& p,
                           const typename F::fe& d2) {
    typename F::fe ymx, ypx, t2d, z2;
    F::sub(ymx, p.Y, p.X);
    F::add(ypx, p.Y, p.X);
    F::mul(t2d, p.T, d2);
    F::add(z2, p.Z, p.Z);
    q[0] = ymx;
    q[1] = ypx;
    q[2] = t2d;
    q[3] = z2;
}

// r = p + q with q in plane form (8 multiplies).
template <class F>
CT_HD void ct_ge_add_planes(ct_point<F>& r, const ct_point<F>& p,
                            const typename F::fe q[4]) {
    typename F::fe t, a, bb, c, d;
    F::sub(t, p.Y, p.X);
    F::mul(a, t, q[0]);
    F::add(t, p.Y, p.X);
    F::mul(bb, t, q[1]);
    F::mul(c, p.T, q[2]);
    F::mul(d, p.Z, q[3]);
    ct_ge_add_tail(r, a, bb, c, d);
}

// r = p + q for an affine q given as (y - x, y + x, 2dxy): the mixed add
// (7 multiplies). Shared by the verify comb and the signing comb.
template <class F>
CT_HD void ct_ge_add_entry(ct_point<F>& r, const ct_point<F>& p,
                           const typename F::fe& ymx, const typename F::fe& ypx,
                           const typename F::fe& t2d) {
    typename F::fe t, a, bb, c, d;
    F::sub(t, p.Y, p.X);
    F::mul(a, t, ymx);
    F::add(t, p.Y, p.X);
    F::mul(bb, t, ypx);
    F::mul(c, p.T, t2d);
    F::add(d, p.Z, p.Z);
    ct_ge_add_tail(r, a, bb, c, d);
}

// r = p + v*B, the comb entry v of the constant table.
template <class F>
CT_HD void ct_ge_add_comb(ct_point<F>& r, const ct_point<F>& p,
                          const int32_t* table, int v) {
    typename F::fe ymx, ypx, t2d;
    int row = CT_ROW_COMB + 3 * v;
    F::load(ymx, table, row);
    F::load(ypx, table, row + 1);
    F::load(t2d, table, row + 2);
    ct_ge_add_entry(r, p, ymx, ypx, t2d);
}

// RFC 8032 5.1.3 with the reference's exact acceptance rule: y (y < p is
// checked on the host) and the sign bit -> (x, ok). Lanes with no square
// root, or x = 0 with sign 1, come back !ok with a harmless x.
template <class F>
CT_HD int ct_decompress(typename F::fe& x, const typename F::fe& y, int sign,
                        const int32_t* table) {
    typename F::fe one, d, sqrt_m1, y2, u, v, v3, v7, t, pw, vx2, neg;
    F::one(one);
    F::load(d, table, CT_ROW_D);
    F::load(sqrt_m1, table, CT_ROW_SQRT_M1);
    F::sq(y2, y);
    F::sub(u, y2, one);
    F::mul(t, d, y2);
    F::add(v, t, one);
    F::sq(t, v);
    F::mul(v3, t, v);
    F::sq(t, v3);
    F::mul(v7, t, v);
    F::mul(t, u, v7);
    F::pow_p58(pw, t);
    F::mul(t, u, v3);
    F::mul(x, t, pw);
    F::sq(t, x);
    F::mul(vx2, v, t);
    int root_ok = F::eq(vx2, u);
    F::neg(neg, u);
    int flip_ok = F::eq(vx2, neg);
    F::mul(t, x, sqrt_m1);
    F::cmov(x, t, flip_ok);
    int ok = root_ok | flip_ok;
    ok &= !(F::is_zero(x) & (sign == 1));
    F::neg(neg, x);
    F::cmov(x, neg, F::is_odd(x) != sign);
    return ok;
}

// The whole verification of one lane. `row` is the lane's packed row;
// window k of h is hwin[k * hstride]; `tbl` is scratch for the 16-entry
// table of -A (local memory on the card). kFixedWin is 8 (the comb) or 4
// (the 16-entry window).
template <class F, int kFixedWin>
CT_HD uint8_t ct_verify_lane_t(const uint8_t* row, const int32_t* hwin,
                               int hstride, const int32_t* table,
                               typename F::fe tbl[16][4]) {
    static_assert(kFixedWin == 8 || kFixedWin == 4, "fixed-base shape");
    const uint8_t* r_bytes = row;
    const uint8_t* a_bytes = row + 32;
    const uint8_t* s_bytes = row + 128;
    int precheck = row[160] == 1;

    typename F::fe d2, y, x;
    F::load(d2, table, CT_ROW_D2);
    F::from_bytes(y, a_bytes);
    int sign = a_bytes[31] >> 7;
    int a_ok = ct_decompress<F>(x, y, sign, table);

    // -A = (-x, y, 1, -xy)
    ct_point<F> minus_a, acc, pt;
    F::neg(minus_a.X, x);
    minus_a.Y = y;
    F::one(minus_a.Z);
    F::mul(minus_a.T, minus_a.X, y);

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

    // windows from the top: four doublings (T only on the last), the
    // fixed-base add of s (the comb's byte on even windows, or the window's
    // own digit), the table add of h's window
    ct_ge_identity(acc);
#pragma unroll 1
    for (int w = CT_WINDOWS - 1; w >= 0; w--) {
        ct_ge_double(acc, acc, 0);
        ct_ge_double(acc, acc, 0);
        ct_ge_double(acc, acc, 0);
        ct_ge_double(acc, acc, 1);
        if (kFixedWin == 8) {
            if ((w & 1) == 0) ct_ge_add_comb(acc, acc, table, s_bytes[w >> 1]);
        } else {
            ct_ge_add_comb(acc, acc, table, (s_bytes[w >> 1] >> (4 * (w & 1))) & 15);
        }
        ct_ge_add_planes(acc, acc, tbl[hwin[w * hstride] & 15]);
    }

    // encode: canonical y and the parity of x, against R
    typename F::fe zinv, ex, ey;
    F::inv(zinv, acc.Z);
    F::mul(ex, acc.X, zinv);
    F::mul(ey, acc.Y, zinv);
    int match = F::encodes(ex, ey, r_bytes);
    return (uint8_t)(a_ok & match & precheck);
}

// Kernel B's lane: the ten-limb field and the comb.
CT_HD uint8_t ct_verify_lane(const uint8_t* row, const int32_t* hwin,
                             int hstride, const int32_t* table,
                             ct_fe tbl[16][4]) {
    return ct_verify_lane_t<ct_fe10, 8>(row, hwin, hstride, table, tbl);
}
