// One ed25519 verification on four threads: the ladder of kernels B and G,
// both fixed-base shapes, shared by ed25519_verify.cu, ed25519_verify_g.cu
// and host_check.cpp. It computes what the TPU reference kernels compute
// (corda_tpu/ops/ed25519_pallas13.py and corda_tpu/ops/ed25519_pallas.py,
// each ::_make_verify_kernel):
//
//   decompress A (reject x = 0 with sign 1), [s]B + [h](-A) with h already
//   reduced mod L, encode, and accept iff y equals R's low 255 bits and the
//   parity of x equals R's bit 255, and the host precheck passed.
//
// A cofactored launch (a uniform launch argument, so no warp diverges)
// ends as the reference's full-bucket rule (corda_tpu/batchverify/rlc.py,
// verify_single) instead: R decompressed like A, -R added in plane form,
// three doublings, and accept iff X = 0 and Y = Z, i.e. 8 (sB - hA - R) is
// the identity. Its host precheck also holds R's y < p and rejects the 8
// small-order encodings as A or R.
//
// The ladder's shape is the reference's: 4-bit windows of h over a 16-entry
// table of multiples of -A in plane form (Y - X, Y + X, 2dT, 2Z), four
// doublings a window, and the fixed base B in one of its two shapes
// (kFixedWin): the 8-bit comb of s (one mixed add on every even window with
// the digit s[k] + 16 s[k+1]) or the 16-entry window (the comb's first 16
// entries, one mixed add every window). Every table index is public data,
// so entries are indexed directly.
//
// The four-way point formulas are those of Hisil, Wong, Carter and Dawson
// ("Twisted Edwards Curves Revisited", ASIACRYPT 2008, section 4) as
// curve25519-dalek's AVX2 backend arranges them: a point (X, Y, Z, T) is one
// vector of four field elements, and a doubling is one four-way squaring
// and one four-way multiply, an add of a point in plane form two four-way
// multiplies. The formulas are written once, over ct_x4<F>, a vector of four
// elements of the field trait F (ct_fe10, kernel B; ct_fe8, kernel G):
// - on the card (nvcc) a quad of adjacent threads holds one point, one
//   coordinate a thread; ct_x4 holds this thread's element, and a shuffle is
//   __shfl_sync of width 4 within the quad;
// - on the host (g++, host_check.cpp) ct_x4 holds all four elements and a
//   shuffle is a permutation, so the CPU tests run the very same formulas.
// Field code outside ct_x4 (decompression and the two exponent chains,
// which cannot be split by coordinate) runs whole on each thread of the
// quad, and once on the host.
#pragma once

#include "common.cuh"
#include "ed25519_ladder.cuh"

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#define CT_QD __device__ __forceinline__
#define CT_QUAD_N 1  // elements a thread holds
#else
#define CT_QD inline
#define CT_QUAD_N 4
#endif

// A four-lane pattern: lane j of a shuffle's result takes lane `lj` of its
// input, two bits a lane, lane 0 lowest.
#define CT_Q(l0, l1, l2, l3) ((l0) | ((l1) << 2) | ((l2) << 4) | ((l3) << 6))

template <class F>
struct ct_x4 {
    typename F::fe e[CT_QUAD_N];
};

// The quad lane that element j stands for.
CT_QD int ct_qlane(int j) {
#if defined(__CUDACC__)
    (void)j;
    return threadIdx.x & 3;
#else
    return j;
#endif
}

template <class F>
CT_QD void q_mul(ct_x4<F>& r, const ct_x4<F>& a, const ct_x4<F>& b) {
#pragma unroll
    for (int j = 0; j < CT_QUAD_N; j++) F::mul(r.e[j], a.e[j], b.e[j]);
}

template <class F>
CT_QD void q_sq(ct_x4<F>& r, const ct_x4<F>& a) {
#pragma unroll
    for (int j = 0; j < CT_QUAD_N; j++) F::sq(r.e[j], a.e[j]);
}

template <class F>
CT_QD void q_add(ct_x4<F>& r, const ct_x4<F>& a, const ct_x4<F>& b) {
#pragma unroll
    for (int j = 0; j < CT_QUAD_N; j++) F::add(r.e[j], a.e[j], b.e[j]);
}

// lane j negated where bit j of kMask is set (a subtraction is an add of
// this, so every lane of the quad runs the same instructions)
template <int kMask, class F>
CT_QD void q_cneg(ct_x4<F>& r, const ct_x4<F>& a) {
#pragma unroll
    for (int j = 0; j < CT_QUAD_N; j++) F::cneg(r.e[j], a.e[j], (kMask >> ct_qlane(j)) & 1);
}

// lane j from b where bit j of kMask is set, else from a
template <int kMask, class F>
CT_QD void q_blend(ct_x4<F>& r, const ct_x4<F>& a, const ct_x4<F>& b) {
#pragma unroll
    for (int j = 0; j < CT_QUAD_N; j++) {
        typename F::fe t = a.e[j];
        F::cmov(t, b.e[j], (kMask >> ct_qlane(j)) & 1);
        r.e[j] = t;
    }
}

// lane j kept where bit j of kMask is set, else zero
template <int kMask, class F>
CT_QD void q_keep(ct_x4<F>& r, const ct_x4<F>& a) {
#pragma unroll
    for (int j = 0; j < CT_QUAD_N; j++) {
        typename F::fe t;
        F::zero(t);
        F::cmov(t, a.e[j], (kMask >> ct_qlane(j)) & 1);
        r.e[j] = t;
    }
}

// lane j of r = lane ((kPat >> 2j) & 3) of a
template <int kPat, class F>
CT_QD void q_shuffle(ct_x4<F>& r, const ct_x4<F>& a) {
#if defined(__CUDACC__)
    int src = (kPat >> (2 * (threadIdx.x & 3))) & 3;
#pragma unroll
    for (int i = 0; i < F::kWords; i++)
        r.e[0].v[i] = __shfl_sync(0xFFFFFFFFu, a.e[0].v[i], src, 4);
#else
    ct_x4<F> t = a;
    for (int j = 0; j < 4; j++) r.e[j] = t.e[(kPat >> (2 * j)) & 3];
#endif
}

// lane kLane of a, on every thread of the quad
template <int kLane, class F>
CT_QD void q_lane(typename F::fe& out, const ct_x4<F>& a) {
#if defined(__CUDACC__)
#pragma unroll
    for (int i = 0; i < F::kWords; i++)
        out.v[i] = __shfl_sync(0xFFFFFFFFu, a.e[0].v[i], kLane, 4);
#else
    out = a.e[kLane];
#endif
}

// the vector (c0, c1, c2, c3)
template <class F>
CT_QD void q_set(ct_x4<F>& r, const typename F::fe& c0, const typename F::fe& c1,
                 const typename F::fe& c2, const typename F::fe& c3) {
#pragma unroll
    for (int j = 0; j < CT_QUAD_N; j++) {
        int lane = ct_qlane(j);
        r.e[j] = lane == 0 ? c0 : (lane == 1 ? c1 : (lane == 2 ? c2 : c3));
    }
}

// --- the four-way point formulas ------------------------------------------

// (Y - X, Y + X, T, Z) of p = (X, Y, Z, T): the first step of an add, and
// of the plane form
template <class F>
CT_QD void q_diff_sum(ct_x4<F>& u, const ct_x4<F>& p) {
    ct_x4<F> a, b;
    q_shuffle<CT_Q(1, 1, 3, 2)>(a, p);  // (Y, Y, T, Z)
    q_shuffle<CT_Q(0, 0, 0, 0)>(b, p);  // (X, X, X, X)
    q_cneg<0x1>(b, b);
    q_keep<0x3>(b, b);                  // (-X, X, 0, 0)
    q_add(u, a, b);
}

// p in plane form, (Y - X, Y + X, 2dT, 2Z), given k = (1, 1, 2d, 2)
template <class F>
CT_QD void q_to_planes(ct_x4<F>& r, const ct_x4<F>& p, const ct_x4<F>& k) {
    ct_x4<F> u;
    q_diff_sum(u, p);
    q_mul(r, u, k);
}

// r = 2p (dbl-2008-hwcd with a = -1): the squares (S1, S2, S3, S4) of
// (X, Y, Z, X + Y), then H = S1 + S2, G = S1 - S2, F = G + 2 S3,
// E = H - S4, and (X3, Y3, Z3, T3) = (EF, GH, FG, EH). T is always
// computed: the quad's fourth lane costs nothing extra.
template <class F>
CT_QD void q_double(ct_x4<F>& r, const ct_x4<F>& p) {
    ct_x4<F> a, b, s;
    q_shuffle<CT_Q(0, 1, 2, 0)>(a, p);  // (X, Y, Z, X)
    q_shuffle<CT_Q(1, 1, 1, 1)>(b, p);  // (Y, Y, Y, Y)
    q_add(s, a, b);
    q_blend<0x8>(a, a, s);              // (X, Y, Z, X + Y)
    q_sq(s, a);                         // (S1, S2, S3, S4)
    q_shuffle<CT_Q(0, 0, 0, 0)>(a, s);
    q_shuffle<CT_Q(1, 1, 1, 1)>(b, s);
    q_cneg<0x6>(b, b);
    q_add(a, a, b);                     // (H, G, G, H)
    q_cneg<0x8>(b, s);
    q_keep<0xC>(b, b);                  // (0, 0, S3, -S4)
    q_add(a, a, b);                     // (H, G, G + S3, E)
    q_keep<0x4>(b, b);                  // (0, 0, S3, 0)
    q_add(a, a, b);                     // (H, G, F, E)
    q_shuffle<CT_Q(3, 1, 2, 3)>(b, a);  // (E, G, F, E)
    q_shuffle<CT_Q(2, 0, 1, 0)>(s, a);  // (F, H, G, H)
    q_mul(r, b, s);
}

// r = p + q for q in plane form (add-2008-hwcd-3): (A, B, C, D) =
// (Y - X, Y + X, T, Z) * q, then E = B - A, H = B + A, F = D - C,
// G = D + C, and (X3, Y3, Z3, T3) = (EF, GH, FG, EH).
template <class F>
CT_QD void q_add_planes(ct_x4<F>& r, const ct_x4<F>& p, const ct_x4<F>& q) {
    ct_x4<F> u, m, s;
    q_diff_sum(u, p);
    q_mul(m, u, q);                     // (A, B, C, D)
    q_shuffle<CT_Q(1, 0, 3, 2)>(s, m);  // (B, A, D, C)
    q_cneg<0x5>(m, m);                  // (-A, B, -C, D)
    q_add(m, s, m);                     // (E, H, F, G)
    q_shuffle<CT_Q(0, 3, 2, 0)>(u, m);  // (E, G, F, E)
    q_shuffle<CT_Q(2, 1, 3, 1)>(s, m);  // (F, H, G, H)
    q_mul(r, u, s);
}

// r = p + v*B for comb entry v, (y - x, y + x, 2dxy), with 2 on the fourth
// lane: the mixed add as a plane-form add whose D is Z * 2 (the serial
// mixed add's Z + Z; the quad's fourth lane multiplies anyway)
template <class F>
CT_QD void q_add_comb(ct_x4<F>& r, const ct_x4<F>& p, const int32_t* table, int v) {
    ct_x4<F> q;
#pragma unroll
    for (int j = 0; j < CT_QUAD_N; j++) {
        int lane = ct_qlane(j);
        if (lane < 3) {
            F::load(q.e[j], table, CT_ROW_COMB + 3 * v + lane);
        } else {
            F::zero(q.e[j]);
            q.e[j].v[0] = 2;
        }
    }
    q_add_planes(r, p, q);
}

// --- the table of -A ------------------------------------------------------

#if defined(__CUDACC__)
// A thread's coordinate of the 16 entries, in dynamic shared memory: word i
// of entry k at col[(k * kWords + i) * stride], where col is the thread's
// own column and stride the block's width, so the quads of a warp, which
// read different entries, still hit 32 different banks.
template <class F>
struct ct_q_table {
    int32_t* col;
    int stride;
    CT_QD void store(int k, const ct_x4<F>& x) {
#pragma unroll
        for (int i = 0; i < F::kWords; i++)
            col[(k * F::kWords + i) * stride] = (int32_t)x.e[0].v[i];
    }
    CT_QD void load(ct_x4<F>& x, int k) const {
#pragma unroll
        for (int i = 0; i < F::kWords; i++) x.e[0].v[i] = col[(k * F::kWords + i) * stride];
    }
};
#else
template <class F>
struct ct_q_table {
    ct_x4<F> rows[16];
    void store(int k, const ct_x4<F>& x) { rows[k] = x; }
    void load(ct_x4<F>& x, int k) const { x = rows[k]; }
};
#endif

// --- the verification -----------------------------------------------------

// The verdict of one lane (every thread of the quad returns it). `row` is
// the lane's packed row; window k of h is hwin[k * hstride]; `cofactored`
// picks the end (1: the cofactored rule, 0: the encoding compare).
template <class F, int kFixedWin>
CT_QD uint8_t ct_quad_verify(const uint8_t* row, const int32_t* hwin, int hstride,
                             const int32_t* table, ct_q_table<F>& tab, int cofactored) {
    static_assert(kFixedWin == 8 || kFixedWin == 4, "fixed-base shape");
    const uint8_t* r_bytes = row;
    const uint8_t* a_bytes = row + 32;
    const uint8_t* s_bytes = row + 128;
    int precheck = row[160] == 1;

    typename F::fe d2, y, x, nx, nxy, zero, one, two;
    F::load(d2, table, CT_ROW_D2);
    F::from_bytes(y, a_bytes);
    int a_ok = ct_decompress<F>(x, y, a_bytes[31] >> 7, table);
    F::neg(nx, x);
    F::mul(nxy, nx, y);
    F::zero(zero);
    F::one(one);
    F::add(two, one, one);

    // -A = (-x, y, 1, -xy); k * (-A) for k = 0..15, doublings on even k and
    // adds on odd k, then every entry rewritten in place in plane form
    ct_x4<F> ma, kp, pt;
    q_set(ma, nx, y, one, nxy);
    q_set(kp, one, one, d2, two);
    q_set(pt, zero, one, one, zero);
    tab.store(0, pt);
    tab.store(1, ma);
    q_to_planes(ma, ma, kp);
#pragma unroll 1
    for (int k = 2; k < 16; k++) {
        if (k & 1) {
            tab.load(pt, k - 1);
            q_add_planes(pt, pt, ma);
        } else {
            tab.load(pt, k >> 1);
            q_double(pt, pt);
        }
        tab.store(k, pt);
    }
#pragma unroll 1
    for (int k = 0; k < 16; k++) {
        tab.load(pt, k);
        q_to_planes(pt, pt, kp);
        tab.store(k, pt);
    }

    // windows from the top: four doublings, the fixed-base add of s (the
    // comb's byte on even windows, or the window's own digit), the table add
    // of h's window
    ct_x4<F> acc;
    q_set(acc, zero, one, one, zero);
#pragma unroll 1
    for (int w = CT_WINDOWS - 1; w >= 0; w--) {
        q_double(acc, acc);
        q_double(acc, acc);
        q_double(acc, acc);
        q_double(acc, acc);
        if (kFixedWin == 8) {
            if ((w & 1) == 0) q_add_comb(acc, acc, table, s_bytes[w >> 1]);
        } else {
            q_add_comb(acc, acc, table, (s_bytes[w >> 1] >> (4 * (w & 1))) & 15);
        }
        tab.load(pt, hwin[w * hstride] & 15);
        q_add_planes(acc, acc, pt);
    }

    typename F::fe ax, ay, az;
    if (cofactored) {
        // -R from R's bytes, decompressed whole on every thread as A is;
        // 8 (acc - R) must be the identity: X = 0 and Y = Z
        typename F::fe ry, rx, nrx, nrxy;
        F::from_bytes(ry, r_bytes);
        int r_ok = ct_decompress<F>(rx, ry, r_bytes[31] >> 7, table);
        F::neg(nrx, rx);
        F::mul(nrxy, nrx, ry);
        q_set(pt, nrx, ry, one, nrxy);
        q_to_planes(pt, pt, kp);
        q_add_planes(acc, acc, pt);
        q_double(acc, acc);
        q_double(acc, acc);
        q_double(acc, acc);
        q_lane<0>(ax, acc);
        q_lane<1>(ay, acc);
        q_lane<2>(az, acc);
        return (uint8_t)(a_ok & r_ok & F::is_zero(ax) & F::eq(ay, az) & precheck);
    }
    // encode: 1/Z whole on every thread, then x, y and the compare with R
    typename F::fe zinv, ex, ey;
    q_lane<0>(ax, acc);
    q_lane<1>(ay, acc);
    q_lane<2>(az, acc);
    F::inv(zinv, az);
    F::mul(ex, ax, zinv);
    F::mul(ey, ay, zinv);
    return (uint8_t)(a_ok & F::encodes(ex, ey, r_bytes) & precheck);
}

#if defined(__CUDACC__)
#define CT_QUAD_BLOCK 128  // threads a block: 32 signatures

// dynamic shared memory of a block: its threads' columns of the -A table
template <class F>
constexpr int ct_quad_smem_bytes() {
    return 16 * F::kWords * 4 * CT_QUAD_BLOCK;
}

// One thread of a launch: signature t / 4 (past n the last one again, so
// every quad stays whole for its shuffles), coordinate t % 4; lane 0 of the
// quad writes the verdict.
template <class F, int kFixedWin>
__device__ __forceinline__ void ct_quad_verify_thread(
        const uint8_t* __restrict__ packed, const int32_t* __restrict__ hwin,
        const int32_t* __restrict__ table, uint8_t* __restrict__ out, int n, int cofactored) {
    extern __shared__ int32_t ct_quad_smem[];
    int sig = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 2);
    int s = sig < n ? sig : n - 1;
    ct_q_table<F> tab{ct_quad_smem + threadIdx.x, (int)blockDim.x};
    uint8_t ok = ct_quad_verify<F, kFixedWin>(packed + (size_t)s * CT_PACKED_ROW, hwin + s, n,
                                              table, tab, cofactored);
    if (sig < n && (threadIdx.x & 3) == 0) out[sig] = ok;
}

typedef void (*ct_quad_kernel_t)(const uint8_t*, const int32_t*, const int32_t*, uint8_t*, int,
                                 int);

// Launch `kernel` (a ct_quad_verify_thread instantiation over field F) on
// four threads a signature; returns the cudaError_t of raising its shared
// memory limit or of the launch.
template <class F>
inline int ct_quad_launch(ct_quad_kernel_t kernel, const void* packed, const void* hwin,
                          const void* table, void* out, int n, int cofactored, void* stream) {
    int smem = ct_quad_smem_bytes<F>();
    cudaError_t err = cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((unsigned)((4LL * n + CT_QUAD_BLOCK - 1) / CT_QUAD_BLOCK));
    kernel<<<grid, CT_QUAD_BLOCK, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)packed, (const int32_t*)hwin, (const int32_t*)table, (uint8_t*)out, n,
        cofactored);
    return (int)cudaGetLastError();
}
#endif
