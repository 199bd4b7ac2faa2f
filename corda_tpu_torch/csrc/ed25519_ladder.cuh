// The one-thread ed25519 point code over a field trait: decompression,
// which kernels B and G run whole on each thread (ed25519_quad.cuh), and the
// serial extended-coordinate formulas, which the host tests hold the
// four-way formulas of ed25519_quad.cuh against. Their reference is
// corda_tpu/ops/ed25519_pallas13.py and corda_tpu/ops/ed25519_pallas.py
// (the point functions of each).
//
// Templated on the field, as the reference's two tiers are two field
// representations of one ladder: F is a trait (ct_fe10 in fe25519.cuh,
// ref10 limbs, kernels B and E; ct_fe8 in fe25519_w8.cuh, eight 32-bit
// words, kernel G) giving F::fe and its operations.
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
// (7 multiplies), the serial form of the quads' comb add.
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
