// The ECDSA verify of one signature for kernel F, on a quad of four threads:
// complete projective point formulas (Renes-Costello-Batina 2016,
// Algorithms 1 and 3, the sequence of corda_tpu/ops/secp256_pallas.py::
// point_add :935 and point_double :967, and of ops/secp256_ladder.py's plain
// version), the 16-entry k*Q table, the joint MSB-first walk of 64 four-bit
// windows with the 8-bit G comb on even windows, and the two-candidate
// accept. Shared by the CUDA kernel and host_check.cpp.
//
// The split: every field value of the formulas is held whole by every
// thread of the quad (replicated), and the formulas' independent products
// are dealt out in rounds, one product a thread a round, after which every
// thread gathers the round's four results (32 __shfl_sync of one word,
// within the quad). Additions and subtractions run on every thread. A
// round of a doubling's squares runs the dedicated squaring on all four
// threads, so no quad diverges. Rounds a point operation, where the serial
// formulas run 12-14 products one after another:
// - addition: k1 three (X1X2, Y1Y2, Z1Z2, (X1+Z1)(X2+Z2); then (X1+Y1)(X2+Y2),
//   (Y1+Z1)(Y2+Z2) and the two final products that need neither; then the
//   other four), its 3b = 21 products one-word scalings on every thread;
//   r1 four (the 3b products take the second round, the six final
//   products the third and, two of them, the fourth);
// - doubling: k1 three (the squares X^2, Y^2, Z^2, (Y+Z)^2; XY, 2*21*X*Z,
//   the product x3*y3 and 2YZ*Y^2; the three last), r1 four (the squares
//   X^2, Y^2, Z^2, (X+Z)^2; 3b Z^2, 3b 2XZ, XY, YZ; four final products;
//   then 2YZ*Y^2 on every thread).
// On the card ct_gq names the quad (its shuffle mask); on the host (g++,
// host_check.cpp) a round computes its four products in turn, so the CPU
// tests run these very formulas.
//
// a = 0 (secp256k1) folds its terms away at compile time; a = -3
// (secp256r1) is -(v + v + v). Every field value is canonical, so the
// accept compare is a word compare.
#pragma once

#include "secp256_field.cuh"

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#define CT_GQ __device__ __forceinline__
#else
#define CT_GQ inline
#endif

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

// The quad that holds one signature: its threads' shuffle mask on the card.
struct ct_gq {
    unsigned mask;
};

// --- rounds of products ---------------------------------------------------

#if defined(__CUDACC__)
// the operand this thread takes: a0..a3 by its lane of the quad
CT_GQ void g_pick(ct_u256& r, int lane, const ct_u256& a0, const ct_u256& a1,
                  const ct_u256& a2, const ct_u256& a3) {
#pragma unroll
    for (int i = 0; i < 8; i++) {
        uint32_t v = a0.v[i];
        v = lane == 1 ? a1.v[i] : v;
        v = lane == 2 ? a2.v[i] : v;
        v = lane == 3 ? a3.v[i] : v;
        r.v[i] = v;
    }
}

// r = quad lane j's z, on every thread
CT_GQ void g_take(ct_u256& r, const ct_u256& z, int j, ct_gq q) {
#pragma unroll
    for (int i = 0; i < 8; i++) r.v[i] = __shfl_sync(q.mask, z.v[i], j, 4);
}
#endif

// (r0, r1, r2, r3) = (a0 b0, a1 b1, a2 b2, a3 b3) on every thread; any r
// may alias any input.
template <class C>
CT_GQ void g_mul4(ct_u256& r0, ct_u256& r1, ct_u256& r2, ct_u256& r3,
                  const ct_u256& a0, const ct_u256& b0, const ct_u256& a1, const ct_u256& b1,
                  const ct_u256& a2, const ct_u256& b2, const ct_u256& a3, const ct_u256& b3,
                  ct_gq q) {
#if defined(__CUDACC__)
    int lane = threadIdx.x & 3;
    ct_u256 x, y, z;
    g_pick(x, lane, a0, a1, a2, a3);
    g_pick(y, lane, b0, b1, b2, b3);
    ct_sp_mul<C>(z, x, y);
    g_take(r0, z, 0, q);
    g_take(r1, z, 1, q);
    g_take(r2, z, 2, q);
    g_take(r3, z, 3, q);
#else
    (void)q;
    ct_u256 t0, t1, t2, t3;
    ct_sp_mul<C>(t0, a0, b0);
    ct_sp_mul<C>(t1, a1, b1);
    ct_sp_mul<C>(t2, a2, b2);
    ct_sp_mul<C>(t3, a3, b3);
    r0 = t0;
    r1 = t1;
    r2 = t2;
    r3 = t3;
#endif
}

// (r0, r1, r2, r3) = (a0^2, a1^2, a2^2, a3^2) on every thread
template <class C>
CT_GQ void g_sq4(ct_u256& r0, ct_u256& r1, ct_u256& r2, ct_u256& r3, const ct_u256& a0,
                 const ct_u256& a1, const ct_u256& a2, const ct_u256& a3, ct_gq q) {
#if defined(__CUDACC__)
    int lane = threadIdx.x & 3;
    ct_u256 x, z;
    g_pick(x, lane, a0, a1, a2, a3);
    ct_sp_sq<C>(z, x);
    g_take(r0, z, 0, q);
    g_take(r1, z, 1, q);
    g_take(r2, z, 2, q);
    g_take(r3, z, 3, q);
#else
    (void)q;
    ct_u256 t0, t1, t2, t3;
    ct_sp_sq<C>(t0, a0);
    ct_sp_sq<C>(t1, a1);
    ct_sp_sq<C>(t2, a2);
    ct_sp_sq<C>(t3, a3);
    r0 = t0;
    r1 = t1;
    r2 = t2;
    r3 = t3;
#endif
}

// (r0, r1) = (a0 b0, a1 b1) on every thread: lanes 0 and 2 take the first
// product, 1 and 3 the second
template <class C>
CT_GQ void g_mul2(ct_u256& r0, ct_u256& r1, const ct_u256& a0, const ct_u256& b0,
                  const ct_u256& a1, const ct_u256& b1, ct_gq q) {
#if defined(__CUDACC__)
    int lane = threadIdx.x & 3;
    ct_u256 x, y, z;
    g_pick(x, lane, a0, a1, a0, a1);
    g_pick(y, lane, b0, b1, b0, b1);
    ct_sp_mul<C>(z, x, y);
    g_take(r0, z, 0, q);
    g_take(r1, z, 1, q);
#else
    (void)q;
    ct_u256 t0, t1;
    ct_sp_mul<C>(t0, a0, b0);
    ct_sp_mul<C>(t1, a1, b1);
    r0 = t0;
    r1 = t1;
#endif
}

// --- the group formulas ---------------------------------------------------

template <class C>
CT_GQ void ct_sp_mul_a(ct_u256& r, const ct_u256& v) {
    ct_u256 t;
    ct_sp_add<C>(t, v, v);
    ct_sp_add<C>(t, t, v);
    ct_sp_neg<C>(r, t);
}

template <class C>
CT_GQ void ct_sp_times3(ct_u256& r, const ct_u256& v) {
    ct_u256 t;
    ct_sp_add<C>(t, v, v);
    ct_sp_add<C>(r, t, v);
}

// RCB16 Algorithm 1: r = p + q for all inputs (r may alias p or q).
template <class C>
CT_GQ void ct_sp_point_add(ct_sp_point& r, const ct_sp_point& p, const ct_sp_point& q,
                           const ct_u256& b3, ct_gq g) {
    ct_u256 t0, t1, t2, t4, t3, t5, u, v, w, x3, z3, t1p, t4b, p1, p2, p3, p4, p5, p6;
    ct_sp_add<C>(u, p.x, p.z);
    ct_sp_add<C>(v, q.x, q.z);
    g_mul4<C>(t0, t1, t2, t4, p.x, q.x, p.y, q.y, p.z, q.z, u, v, g);
    ct_sp_add<C>(u, t0, t2);
    ct_sp_sub<C>(t4, t4, u);                // t4 = X1 Z2 + X2 Z1
    ct_u256 xy1, xy2, yz1, yz2;
    ct_sp_add<C>(xy1, p.x, p.y);
    ct_sp_add<C>(xy2, q.x, q.y);
    ct_sp_add<C>(yz1, p.y, p.z);
    ct_sp_add<C>(yz2, q.y, q.z);
    if constexpr (C::kAZero) {
        ct_sp_mul_b3<C>(z3, t2, b3);
        ct_sp_mul_b3<C>(t4b, t4, b3);
        ct_sp_sub<C>(x3, t1, z3);
        ct_sp_add<C>(z3, t1, z3);
        ct_sp_times3<C>(t1p, t0);
        g_mul4<C>(t3, t5, p1, p2, xy1, xy2, yz1, yz2, x3, z3, t1p, t4b, g);
    } else {
        g_mul4<C>(t3, t5, z3, t4b, xy1, xy2, yz1, yz2, b3, t2, b3, t4, g);
        ct_sp_mul_a<C>(u, t4);
        ct_sp_add<C>(z3, z3, u);            // 3b t2 + a t4
        ct_sp_sub<C>(x3, t1, z3);
        ct_sp_add<C>(z3, t1, z3);
        ct_sp_mul_a<C>(w, t2);              // a t2
        ct_sp_times3<C>(t1p, t0);
        ct_sp_add<C>(t1p, t1p, w);          // 3 t0 + a t2
        ct_sp_sub<C>(u, t0, w);
        ct_sp_mul_a<C>(u, u);
        ct_sp_add<C>(t4b, t4b, u);          // 3b t4 + a (t0 - a t2)
    }
    ct_sp_add<C>(u, t0, t1);
    ct_sp_sub<C>(t3, t3, u);                // X1 Y2 + X2 Y1
    ct_sp_add<C>(u, t1, t2);
    ct_sp_sub<C>(t5, t5, u);                // Y1 Z2 + Y2 Z1
    if constexpr (C::kAZero) {
        g_mul4<C>(p3, p4, p5, p6, x3, t3, t5, t4b, t5, z3, t3, t1p, g);
    } else {
        g_mul4<C>(p1, p2, p3, p4, x3, z3, t1p, t4b, x3, t3, t5, t4b, g);
        g_mul2<C>(p5, p6, t5, z3, t3, t1p, g);
    }
    ct_sp_sub<C>(r.x, p3, p4);
    ct_sp_add<C>(r.y, p1, p2);
    ct_sp_add<C>(r.z, p5, p6);
}

// RCB16 Algorithm 3: r = 2p for all inputs (r may alias p).
template <class C>
CT_GQ void ct_sp_point_double(ct_sp_point& r, const ct_sp_point& p, const ct_u256& b3,
                              ct_gq g) {
    ct_u256 t0, t1, t2, s, u, x3, y3, t3, t3x, t2yz, p1, p2, p3, p4, zz;
    if constexpr (C::kAZero) {
        ct_sp_add<C>(u, p.y, p.z);
        g_sq4<C>(t0, t1, t2, s, p.x, p.y, p.z, u, g);
        ct_sp_add<C>(u, t1, t2);
        ct_sp_sub<C>(t2yz, s, u);           // 2YZ
        ct_sp_mul_b3<C>(u, t2, b3);
        ct_sp_sub<C>(x3, t1, u);
        ct_sp_add<C>(y3, t1, u);
        ct_u256 bx2;
        ct_sp_add<C>(u, p.x, p.x);
        ct_sp_mul_b3<C>(bx2, u, b3);        // 3b 2X
        g_mul4<C>(t3x, t3, p1, zz, p.x, p.y, bx2, p.z, x3, y3, t2yz, t1, g);
        ct_sp_add<C>(t3x, t3x, t3x);        // 2XY
        ct_sp_times3<C>(t0, t0);
        g_mul4<C>(p3, p4, p2, u, t3x, x3, t2yz, t3, t0, t3, t0, t3, g);
    } else {
        ct_sp_add<C>(u, p.x, p.z);
        g_sq4<C>(t0, t1, t2, s, p.x, p.y, p.z, u, g);
        ct_u256 z3, bt2, bz3, xy, yz, w;
        ct_sp_add<C>(u, t0, t2);
        ct_sp_sub<C>(z3, s, u);             // 2XZ
        g_mul4<C>(bt2, bz3, xy, yz, b3, t2, b3, z3, p.x, p.y, p.y, p.z, g);
        ct_sp_mul_a<C>(u, z3);
        ct_sp_add<C>(u, bt2, u);            // 3b Z^2 + a 2XZ
        ct_sp_sub<C>(x3, t1, u);
        ct_sp_add<C>(y3, t1, u);
        ct_sp_add<C>(t3x, xy, xy);          // 2XY
        ct_sp_mul_a<C>(w, t2);              // a Z^2
        ct_sp_sub<C>(u, t0, w);
        ct_sp_mul_a<C>(u, u);
        ct_sp_add<C>(t3, u, bz3);           // a (X^2 - a Z^2) + 3b 2XZ
        ct_sp_times3<C>(t0, t0);
        ct_sp_add<C>(t0, t0, w);            // 3X^2 + a Z^2
        ct_sp_add<C>(t2yz, yz, yz);         // 2YZ
        g_mul4<C>(p1, p3, p2, p4, x3, y3, t3x, x3, t0, t3, t2yz, t3, g);
        ct_sp_mul<C>(zz, t2yz, t1);
    }
    ct_sp_sub<C>(r.x, p3, p4);
    ct_sp_add<C>(r.y, p1, p2);
    ct_sp_add<C>(zz, zz, zz);
    ct_sp_add<C>(r.z, zz, zz);              // 4 (2YZ) Y^2
}

// 32 little-endian bytes as a field element: a value in [p, 2^256) is
// reduced, so any bytes read as their value mod p (the host's prep only
// ever sends values below p).
template <class C>
CT_GQ void ct_sp_from_bytes(ct_u256& r, const uint8_t* b) {
    ct_u256 raw;
    ct_u256_from_bytes(raw, b);
    ct_sp_reduce_once<C>(r, raw.v, 0);
}

CT_GQ void ct_sp_load_entry(ct_sp_point& r, const int32_t* table, int v) {
    const int32_t* row = table + (CT_ECDSA_ROW_COMB + 3 * v) * 8;
    ct_u256_load(r.x, row);
    ct_u256_load(r.y, row + 8);
    ct_u256_load(r.z, row + 16);
}

// --- the k*Q table --------------------------------------------------------

#if defined(__CUDACC__)
// One signature's 16 entries in shared memory, written and read by all four
// threads of its quad (each holds the whole point): word i of entry k at
// col[(k * 24 + i) * stride], col the signature's column and stride the
// signatures of a block, so the quads of a warp, which read different
// entries, hit 8 different banks, and a quad's four reads of one word are
// one broadcast.
struct ct_sp_qtab {
    int32_t* col;
    int stride;
    CT_GQ void store(int k, const ct_sp_point& p) {
#pragma unroll
        for (int i = 0; i < 8; i++) {
            col[(k * 24 + i) * stride] = (int32_t)p.x.v[i];
            col[(k * 24 + 8 + i) * stride] = (int32_t)p.y.v[i];
            col[(k * 24 + 16 + i) * stride] = (int32_t)p.z.v[i];
        }
    }
    CT_GQ void load(ct_sp_point& p, int k) const {
#pragma unroll
        for (int i = 0; i < 8; i++) {
            p.x.v[i] = (uint32_t)col[(k * 24 + i) * stride];
            p.y.v[i] = (uint32_t)col[(k * 24 + 8 + i) * stride];
            p.z.v[i] = (uint32_t)col[(k * 24 + 16 + i) * stride];
        }
    }
};
#else
struct ct_sp_qtab {
    ct_sp_point rows[16];
    void store(int k, const ct_sp_point& p) { rows[k] = p; }
    void load(ct_sp_point& p, int k) const { p = rows[k]; }
};
#endif

// --- the verification -----------------------------------------------------

// One signature's verdict (1 accept, 0 reject), the same on every thread of
// its quad: `row` is its packed 194 bytes, `table` the curve's constant
// table. A signature whose precheck failed, or whose Q is off the curve,
// returns before the ladder on all four threads at once.
template <class C>
CT_GQ int ct_ecdsa_verify_lane(const uint8_t* row, const int32_t* table, ct_sp_qtab& qtab,
                               ct_gq g) {
    if (row[CT_ECDSA_PRE] != 1) return 0;
    ct_u256 b3, t, u;
    ct_sp_point q;
    ct_u256_load(b3, table + CT_ECDSA_ROW_B3 * 8);
    ct_sp_from_bytes<C>(q.x, row);
    ct_sp_from_bytes<C>(q.y, row + 32);
    ct_u256_zero(q.z);
    q.z.v[0] = 1;

    // on the curve: y^2 == x^3 + a x + b (every thread)
    ct_sp_sq<C>(t, q.x);
    ct_sp_mul<C>(t, t, q.x);
    ct_u256_load(u, table + CT_ECDSA_ROW_B * 8);
    ct_sp_add<C>(t, t, u);
    if constexpr (!C::kAZero) {
        ct_sp_mul_a<C>(u, q.x);
        ct_sp_add<C>(t, t, u);
    }
    ct_sp_sq<C>(u, q.y);
    if (!ct_u256_eq(t, u)) return 0;

    // k*Q for k = 0..15: 7 doublings, 7 additions
    ct_sp_point e, acc;
    ct_u256_zero(acc.x);
    ct_u256_zero(acc.y);
    acc.y.v[0] = 1;
    ct_u256_zero(acc.z);
    qtab.store(0, acc);
    qtab.store(1, q);
#pragma unroll 1
    for (int k = 2; k < 16; k++) {
        if (k % 2 == 0) {
            qtab.load(e, k / 2);
            ct_sp_point_double<C>(e, e, b3, g);
        } else {
            qtab.load(e, k - 1);
            ct_sp_point_add<C>(e, e, q, b3, g);
        }
        qtab.store(k, e);
    }

    const uint8_t* u1 = row + 64;
    const uint8_t* u2 = row + 96;
#pragma unroll 1
    for (int w = CT_WINDOWS - 1; w >= 0; w--) {
#pragma unroll 1
        for (int i = 0; i < 4; i++) ct_sp_point_double<C>(acc, acc, b3, g);
        if ((w & 1) == 0) {
            // the comb digit u1[w] + 16 u1[w + 1] is byte w / 2 of u1
            ct_sp_load_entry(e, table, u1[w >> 1]);
            ct_sp_point_add<C>(acc, acc, e, b3, g);
        }
        qtab.load(e, (u2[w >> 1] >> (4 * (w & 1))) & 15);
        ct_sp_point_add<C>(acc, acc, e, b3, g);
    }

    // accept: Z != 0 and (X == r Z or (rb_ok and X == (r + n) Z))
    if (ct_u256_is_zero(acc.z)) return 0;
    ct_sp_from_bytes<C>(t, row + 128);
    ct_sp_from_bytes<C>(u, row + 160);
    g_mul2<C>(t, u, t, acc.z, u, acc.z, g);
    return ct_u256_eq(t, acc.x) | (row[CT_ECDSA_RB_OK] == 1 && ct_u256_eq(u, acc.x));
}
