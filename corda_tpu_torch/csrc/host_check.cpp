// A plain C ABI over the kernels' shared arithmetic, built with a host C++
// compiler so the CPU tests can hold the exact code of the kernels
// against the reference before any card is involved. Field elements cross
// the boundary as 32-byte little-endian strings, SHA-256 digests as 8
// words; kernel F's functions take a curve id (0 secp256k1, 1 secp256r1)
// and its points as 96 bytes (X, Y, Z); kernel G's (hc_g_*) take its
// eight-word field elements as 32 bytes too. The verify ladders of kernels
// B and G and kernel E's partial sums run ed25519_quad.cuh's four-way
// formulas over the host's four-element vector, the very code each quad of
// threads runs on the card. Kernel H's lanes run its stages in order, each
// for every thread of the block in turn, as its barriers order them, and
// each warp pair's hashes one at a time: the producer's chunks, then the
// consumer's. The state store's kernels I, J and K run their row steps
// one row, and one window slot, at a time, in the walks' row order.
#include <string.h>

#include "ecdsa_ladder.cuh"
#include "ed25519_comb.cuh"
#include "ed25519_ladder.cuh"
#include "ed25519_quad.cuh"
#include "fe25519_w8.cuh"
#include "sha256.cuh"
#include "sha512_modl.cuh"
#include "sphincs.cuh"
#include "statestore.cuh"

// field elements in and out as 32 little-endian bytes (in: below 2^255;
// out: canonical)
static void hc_fe_in(ct_fe& h, const uint8_t* b) { ct_fe_from_bytes(h, b); }
static void hc_fe_in(ct_u256& h, const uint8_t* b) { ct_fe8::from_bytes(h, b); }
static void hc_fe_out(uint8_t* b, const ct_fe& h) { ct_fe_to_bytes(b, h); }
static void hc_fe_out(uint8_t* b, const ct_u256& h) { ct_u256_to_bytes(b, h); }

template <class F, int kFixedWin>
static int hc_quad_verify(const uint8_t* row, const int32_t* win, const int32_t* table,
                          int cofactored) {
    ct_q_table<F> tab;
    return ct_quad_verify<F, kFixedWin>(row, win, 1, table, tab, cofactored);
}

// op 0: 2p; op 1: p + q, q in plane form (4 elements); op 2: p + q, q
// affine as (y - x, y + x, 2dxy) (3 elements); by the one-thread formulas
// (quad 0) or the four-way ones (quad 1)
template <class F>
static void hc_point_t(int quad, int op, const uint8_t* p, const uint8_t* q, uint8_t* out) {
    typename F::fe pe[4], qe[4] = {}, re[4];
    for (int k = 0; k < 4; k++) hc_fe_in(pe[k], p + 32 * k);
    int nq = op == 0 ? 0 : (op == 1 ? 4 : 3);
    for (int k = 0; k < nq; k++) hc_fe_in(qe[k], q + 32 * k);
    if (quad) {
        if (op == 2) {
            F::zero(qe[3]);
            qe[3].v[0] = 2;
        }
        ct_x4<F> pv, qv, rv;
        for (int j = 0; j < 4; j++) {
            pv.e[j] = pe[j];
            qv.e[j] = qe[j];
        }
        if (op == 0) q_double(rv, pv);
        else q_add_planes(rv, pv, qv);
        for (int j = 0; j < 4; j++) re[j] = rv.e[j];
    } else {
        ct_point<F> a{pe[0], pe[1], pe[2], pe[3]}, r;
        if (op == 0) ct_ge_double(r, a, 1);
        else if (op == 1) ct_ge_add_planes(r, a, qe);
        else ct_ge_add_entry(r, a, qe[0], qe[1], qe[2]);
        re[0] = r.X;
        re[1] = r.Y;
        re[2] = r.Z;
        re[3] = r.T;
    }
    for (int k = 0; k < 4; k++) hc_fe_out(out + 32 * k, re[k]);
}

template <class C>
static void hc_sp_field_t(int op, const ct_u256& x, const ct_u256& y, ct_u256& z) {
    if (op == 0) ct_sp_add<C>(z, x, y);
    else if (op == 1) ct_sp_sub<C>(z, x, y);
    else if (op == 2) ct_sp_mul<C>(z, x, y);
    else if (op == 3) ct_sp_mul_b3<C>(z, x, y);
    else ct_sp_sq<C>(z, x);
}

extern "C" {

void hc_fe_mul(const uint8_t* a, const uint8_t* b, uint8_t* out) {
    ct_fe x, y, z;
    ct_fe_from_bytes(x, a);
    ct_fe_from_bytes(y, b);
    ct_fe_mul(z, x, y);
    ct_fe_to_bytes(out, z);
}

void hc_fe_sq(const uint8_t* a, uint8_t* out) {
    ct_fe x, z;
    ct_fe_from_bytes(x, a);
    ct_fe_sq(z, x);
    ct_fe_to_bytes(out, z);
}

void hc_fe_inv(const uint8_t* a, uint8_t* out) {
    ct_fe x, z;
    ct_fe_from_bytes(x, a);
    ct_fe_inv(z, x);
    ct_fe_to_bytes(out, z);
}

void hc_fe_pow_p58(const uint8_t* a, uint8_t* out) {
    ct_fe x, z;
    ct_fe_from_bytes(x, a);
    ct_fe_pow_p58(z, x);
    ct_fe_to_bytes(out, z);
}

// pubkey bytes -> ok, canonical x
int hc_decompress(const uint8_t* pk, const int32_t* table, uint8_t* x_out) {
    ct_fe y, x;
    ct_fe_from_bytes(y, pk);
    int ok = ct_decompress<ct_fe10>(x, y, pk[31] >> 7, table);
    ct_fe_to_bytes(x_out, x);
    return ok;
}

// one packed row -> 64 windows of h mod L
void hc_challenge(const uint8_t* row, int32_t* win) {
    ct_challenge_lane(row, win, 1);
}

// kernel B's lane: one packed row + its 64 windows -> verdict, with the
// comb (fixed_win 8) or the 16-entry window (4), and the cofactored end of
// full buckets (cofactored 1) or the encoding compare (0)
int hc_verify_rule(const uint8_t* row, const int32_t* win, const int32_t* table, int fixed_win,
                   int cofactored) {
    return fixed_win == 8 ? hc_quad_verify<ct_fe10, 8>(row, win, table, cofactored)
                          : hc_quad_verify<ct_fe10, 4>(row, win, table, cofactored);
}

// the same with the encoding compare
int hc_verify(const uint8_t* row, const int32_t* win, const int32_t* table, int fixed_win) {
    return hc_verify_rule(row, win, table, fixed_win, 0);
}

// the point formulas over kernel B's field (field 10) or G's (8): points as
// four 32-byte elements (X, Y, Z, T); op and quad as for hc_point_t
void hc_point(int field, int quad, int op, const uint8_t* p, const uint8_t* q, uint8_t* out) {
    if (field == 10) hc_point_t<ct_fe10>(quad, op, p, q, out);
    else hc_point_t<ct_fe8>(quad, op, p, q, out);
}

// kernel C's lane: the digest of `nblk` padded 64-byte blocks
void hc_sha256_blocks(const uint8_t* blocks, int nblk, uint32_t* out) {
    ct_sha256_blocks(out, blocks, nblk);
}

// kernel C's launch on the host: its 32-lane groups in the lane order
// `order` (longest message first), each block's producer chunks for every
// lane of the group, then the consumer's rounds over them, as many blocks
// as the group's longest message; each digest written through the order
// into out (n x 8 words, message order)
void hc_sha256_leaves(const uint8_t* blocks, const int32_t* offsets, const int32_t* counts,
                      const int32_t* order, int n, uint32_t* out) {
    const uint32_t iv[8] = CT_SHA256_IV_INIT;
    for (int g = 0; g < n; g += 32) {
        int lanes = n - g < 32 ? n - g : 32, nmax = 0;
        uint32_t st[32][8], w[32][16], wk[32][64];
        for (int l = 0; l < lanes; l++) {
            int c = counts[order[g + l]];
            nmax = c > nmax ? c : nmax;
            for (int i = 0; i < 8; i++) st[l][i] = iv[i];
        }
        for (int k = 0; k < nmax; k++) {
            for (int l = 0; l < lanes; l++) {  // the producer warp
                int m = order[g + l];
                if (k >= counts[m]) continue;
                ct_sha256_load_block(w[l], blocks + 64 * ((size_t)offsets[m] + k));
                for (int c = 0; c < 4; c++) ct_sha256_wk_chunk(wk[l] + 16 * c, w[l], c);
            }
            for (int l = 0; l < lanes; l++) {  // the consumer warp
                if (k >= counts[order[g + l]]) continue;
                uint32_t v[8];
                for (int i = 0; i < 8; i++) v[i] = st[l][i];
                for (int c = 0; c < 4; c++) ct_sha256_rounds_chunk(v, wk[l] + 16 * c);
                for (int i = 0; i < 8; i++) st[l][i] += v[i];
            }
        }
        for (int l = 0; l < lanes; l++)
            for (int i = 0; i < 8; i++) out[8 * (size_t)order[g + l] + i] = st[l][i];
    }
}

// kernel C's lane order on the host, over a grid of g blocks: each
// block's range a chunk of CT_C_CHUNK at a time, each chunk's messages
// placed by ct_c_rank, the chunks' orders end to end
void hc_sha256_lane_order(const int32_t* counts, int n, int g, int32_t* order) {
    for (int b = 0, k = 0; b < g; b++) {
        int lo, hi;
        ct_c_range(n, g, b, &lo, &hi);
        for (int c0 = lo; c0 < hi; c0 += CT_C_CHUNK) {
            int m = hi - c0 < CT_C_CHUNK ? hi - c0 : CT_C_CHUNK, cnts[CT_C_CHUNK];
            for (int t = 0; t < m; t++) cnts[t] = counts[c0 + t];
            for (int t = 0; t < m; t++) order[k + ct_c_rank(cnts, m, t)] = c0 + t;
            k += m;
        }
    }
}

// kernel A's launch on the host: each block's CT_A_ROWS rows staged as
// one span of 32-bit words, each row's words assembled from it
// (ct_sha512_row_words), the schedule warp's five chunks of W + K, then
// the rounds warp's; the windows of row i at win[k * n + i]
void hc_challenge_staged(const uint8_t* packed, int n, int32_t* win) {
    for (int row0 = 0; row0 < n; row0 += CT_A_ROWS) {
        int rows = n - row0 < CT_A_ROWS ? n - row0 : CT_A_ROWS;
        uint32_t span[CT_A_ROWS * CT_PACKED_ROW / 4] = {};
        memcpy(span, packed + (size_t)row0 * CT_PACKED_ROW, (size_t)rows * CT_PACKED_ROW);
        for (int r = 0; r < rows; r++) {
            const uint64_t K[80] = CT_SHA512_K_INIT, IV[8] = CT_SHA512_IV_INIT;
            uint64_t w[16], wk[80], v[8];
            ct_sha512_row_words(w, span, r);
            for (int c = 0; c < 5; c++) ct_sha512_wk_chunk(wk + 16 * c, w, c, K);
            for (int i = 0; i < 8; i++) v[i] = IV[i];
            for (int c = 0; c < 5; c++) ct_sha512_rounds_chunk(v, wk + 16 * c);
            for (int i = 0; i < 8; i++) v[i] += IV[i];
            ct_challenge_windows(v, win + row0 + r, n);
        }
    }
}

// kernel A's word assembly alone: the 16 big-endian words of row r of a
// staged span (CT_A_ROWS rows of 161 bytes, as 32-bit words)
void hc_sha512_row_words(const uint32_t* span, int r, uint64_t* w) {
    ct_sha512_row_words(w, span, r);
}

// kernel D's lane: SHA-256 of left || right (8 words each)
void hc_sha256_pair(const uint32_t* left, const uint32_t* right,
                    uint32_t* out) {
    ct_sha256_pair(out, left, right);
}

// kernel E's signature: the encoding of [r]B for a 32-byte scalar, its
// partial sums in turn, combined in the kernel's rounds
void hc_comb(const uint8_t* r, const int32_t* table, uint8_t* out) {
    ct_comb_lane(out, r, table);
}

// kernel F's field: op 0 add, 1 sub, 2 mul, 3 the b3 product with b as
// the table's b3 row (for secp256k1 its low word), 4 the dedicated square
// of a (inputs below p; b unused by the square)
void hc_sp_field(int curve, int op, const uint8_t* a, const uint8_t* b, uint8_t* out) {
    ct_u256 x, y, z;
    ct_u256_from_bytes(x, a);
    ct_u256_from_bytes(y, b);
    if (curve == 0) hc_sp_field_t<ct_secp256k1>(op, x, y, z);
    else hc_sp_field_t<ct_secp256r1>(op, x, y, z);
    ct_u256_to_bytes(out, z);
}

static void hc_point_in(ct_sp_point& r, const uint8_t* b) {
    ct_u256_from_bytes(r.x, b);
    ct_u256_from_bytes(r.y, b + 32);
    ct_u256_from_bytes(r.z, b + 64);
}

static void hc_point_out(uint8_t* b, const ct_sp_point& r) {
    ct_u256_to_bytes(b, r.x);
    ct_u256_to_bytes(b + 32, r.y);
    ct_u256_to_bytes(b + 64, r.z);
}

// kernel F's complete add (q != NULL) or doubling (q == NULL): the quad's
// rounds of products, each round's four in turn
void hc_sp_point(int curve, const uint8_t* p, const uint8_t* q, const int32_t* table,
                 uint8_t* out) {
    ct_sp_point a, b, r;
    ct_u256 b3;
    ct_gq g{0};
    ct_u256_load(b3, table + CT_ECDSA_ROW_B3 * 8);
    hc_point_in(a, p);
    if (q) hc_point_in(b, q);
    if (curve == 0) {
        if (q) ct_sp_point_add<ct_secp256k1>(r, a, b, b3, g);
        else ct_sp_point_double<ct_secp256k1>(r, a, b3, g);
    } else {
        if (q) ct_sp_point_add<ct_secp256r1>(r, a, b, b3, g);
        else ct_sp_point_double<ct_secp256r1>(r, a, b3, g);
    }
    hc_point_out(out, r);
}

// kernel F's signature: one packed 194-byte row -> verdict
int hc_ecdsa_verify(int curve, const uint8_t* row, const int32_t* table) {
    ct_sp_qtab qtab;
    ct_gq g{0};
    return curve == 0 ? ct_ecdsa_verify_lane<ct_secp256k1>(row, table, qtab, g)
                      : ct_ecdsa_verify_lane<ct_secp256r1>(row, table, qtab, g);
}

// kernel G's field: op 0 add, 1 sub, 2 mul, 3 square, 4 negate, 5 invert,
// 6 the decompression power z^((p - 5) / 8) (inputs below p; b unused by
// the one-input ops)
void hc_g_field(int op, const uint8_t* a, const uint8_t* b, uint8_t* out) {
    ct_u256 x, y, z;
    ct_u256_from_bytes(x, a);
    ct_u256_from_bytes(y, b);
    switch (op) {
        case 0: ct_fe8::add(z, x, y); break;
        case 1: ct_fe8::sub(z, x, y); break;
        case 2: ct_fe8::mul(z, x, y); break;
        case 3: ct_fe8::sq(z, x); break;
        case 4: ct_fe8::neg(z, x); break;
        case 5: ct_fe8::inv(z, x); break;
        default: ct_fe8::pow_p58(z, x); break;
    }
    ct_u256_to_bytes(out, z);
}

// kernel G's decompression: pubkey bytes -> ok, x (canonical)
int hc_g_decompress(const uint8_t* pk, const int32_t* table, uint8_t* x_out) {
    ct_u256 y, x;
    ct_fe8::from_bytes(y, pk);
    int ok = ct_decompress<ct_fe8>(x, y, pk[31] >> 7, table);
    ct_u256_to_bytes(x_out, x);
    return ok;
}

// kernel G's lane: one packed row + its 64 windows -> verdict, with the
// comb (fixed_win 8) or the 16-entry window (4), either end (as hc_verify_rule)
int hc_g_verify_rule(const uint8_t* row, const int32_t* win, const int32_t* table,
                     int fixed_win, int cofactored) {
    return fixed_win == 8 ? hc_quad_verify<ct_fe8, 8>(row, win, table, cofactored)
                          : hc_quad_verify<ct_fe8, 4>(row, win, table, cofactored);
}

int hc_g_verify(const uint8_t* row, const int32_t* win, const int32_t* table,
                int fixed_win) {
    return hc_g_verify_rule(row, win, table, fixed_win, 0);
}

// Kernel H's pair channel on the host: the producer's chunks of a hash
// queue up, then the consumer takes them; a digest handed back waits in d.
struct hc_sp_queue {
    uint32_t q[4 * CT_SP_BLOCKS(CT_SP_WPK_LEN)][16];
    int head = 0, tail = 0;
    uint32_t d[8];
    void put(const uint32_t wk[16]) { memcpy(q[tail++], wk, sizeof q[0]); }
    void get(uint32_t wk[16]) {
        memcpy(wk, q[head++], sizeof q[0]);
        if (head == tail) head = tail = 0;
    }
    void give(const uint32_t x[8]) { memcpy(d, x, sizeof d); }
    void take(uint32_t x[8]) { memcpy(x, d, sizeof d); }
};

static void hc_sp_words(uint32_t* w, const uint8_t* b, int n) {
    for (int i = 0; i < n; i++) w[i] = ct_sp_be(b + 4 * i);
}

static void hc_sp_put_digest(uint8_t* p, const uint32_t st[8]) {
    for (int i = 0; i < 32; i++) p[i] = (uint8_t)(st[i >> 2] >> (24 - 8 * (i & 3)));
}

// Stage 0 on the host: the hoister's lanes (phase 0, then phase 1), then
// the pair, tree by tree and hash by hash (the producer's chunks, then the
// consumer's), each root written by its consumer lane.
static void hc_sp_stage0(ct_sp_smem& S, const ct_sp_lane& L, hc_sp_queue& Q) {
    for (int s = 0; s < 32; s++) ct_sp_hoist(S, L, s, 0);
    for (int s = 0; s < 32; s++) ct_sp_hoist(S, L, s, 1);
    for (int t = 0; t < CT_SP_K; t++) {
        uint32_t node[8];
        for (int h = 0; h <= CT_SP_A; h++) {
            ct_sp_fors_put(Q, L, t, h);
            ct_sp_fors_get(Q, S, h, node);
        }
        ct_sp_store8(S.data, 8 * t, node);
    }
}

// Layer L's stages on the host: every chain thread in turn, then the pair.
static void hc_sp_layer(ct_sp_smem& S, const ct_sp_lane& L, hc_sp_queue& Q, int layer) {
    for (int j = 0; j < CT_SP_LEN; j++) ct_sp_chain(S, L, j, layer);
    uint32_t node[8];
    for (int h = 0; h <= CT_SP_HT; h++) {
        ct_sp_layer_put(Q, L, S, layer, h);
        ct_sp_layer_get(Q, L, S, layer, h, node);
    }
    memcpy(S.digest, node, sizeof node);
}

// kernel H's lanes: n signature rows (13480 bytes), FORS digests, indices
// and precheck flags -> verdicts, stage by stage as the block runs them;
// `stages`, when not NULL, gets each lane's FORS pk and layer roots (5 x
// 32 bytes a lane)
void hc_sphincs_verify(const uint8_t* sigs, const uint8_t* dgs, const int64_t* idxs,
                       const uint8_t* pre, int n, uint8_t* out, uint8_t* stages) {
    ct_sp_smem* S = new ct_sp_smem();
    hc_sp_queue* Q = new hc_sp_queue();
    for (int lane = 0; lane < n; lane++) {
        out[lane] = 0;
        if (!pre[lane]) continue;
        ct_sp_lane L;
        ct_sp_lane_init(L, sigs + (size_t)lane * CT_SP_SIG_LEN, dgs + (size_t)lane * CT_SP_N,
                        (uint64_t)idxs[lane]);
        uint8_t* st = stages ? stages + (size_t)lane * 5 * CT_SP_N : nullptr;
        hc_sp_stage0(*S, L, *Q);
        ct_sp_fpk_put(*Q, L, *S);
        ct_sp_get_hash(*Q, S->digest, S->hoist + CT_SP_AT(8 * CT_SP_H_FPK), CT_SP_PK_FROM,
                       CT_SP_BLOCKS(CT_SP_FPK_LEN), nullptr);
        if (st) hc_sp_put_digest(st, S->digest);
        for (int layer = 0; layer < CT_SP_D; layer++) {
            hc_sp_layer(*S, L, *Q, layer);
            if (st) hc_sp_put_digest(st + CT_SP_N * (layer + 1), S->digest);
        }
        out[lane] = (uint8_t)ct_sp_verdict(*S, L.sig);
    }
    delete Q;
    delete S;
}

// kernel H's layer L alone: from the digest it signs (32 bytes) to its
// root, over a signature row's chain values and siblings at index idx
void hc_sphincs_layer(const uint8_t* sig, int64_t idx, int layer, const uint8_t* digest,
                      uint8_t* out) {
    ct_sp_smem* S = new ct_sp_smem();
    hc_sp_queue* Q = new hc_sp_queue();
    const uint8_t dg[CT_SP_N] = {};
    ct_sp_lane L;
    ct_sp_lane_init(L, sig, dg, (uint64_t)idx);
    for (int s = 0; s < 32; s++) ct_sp_hoist(*S, L, s, 0);
    for (int s = 0; s < 32; s++) ct_sp_hoist(*S, L, s, 1);
    hc_sp_words(S->digest, digest, 8);
    hc_sp_layer(*S, L, *Q, layer);
    hc_sp_put_digest(out, S->digest);
    delete Q;
    delete S;
}

// One message of kernel H's kind (0 FORS leaf, 1 FORS node, 2 FORS pk, 3
// chain step, 4 WOTS pk, 5 auth node) over seed (32 bytes), the address
// (layer, tree high, tree low, leaf, j) and its data (32, 64, 448, 32,
// 2,144, 64 bytes), its blocks assembled as words: mode 0 compresses every
// block from the IV; mode 1 starts the first block at its hoisted round
// from the state of the rounds before it, which the hoister computes with
// the address's leaf and j zero (FORS leaf and node) or j zero (chain
// step); mode 2 (auth node) takes the first block's chaining value from a
// whole compression of it, as the hoister does at an odd position.
void hc_sp_message(int kind, const uint8_t* seed, const uint32_t* addr, const uint8_t* data,
                   int mode, uint8_t* out) {
    static const int data_words[6] = {8, 16, 8 * CT_SP_K, 8, 8 * CT_SP_LEN, 16};
    static const int lens[6] = {CT_SP_FLEAF_LEN, CT_SP_FNODE_LEN, CT_SP_FPK_LEN,
                                CT_SP_CH_LEN, CT_SP_WPK_LEN, CT_SP_NODE_LEN};
    static const int from[6] = {CT_SP_FORS_FROM, CT_SP_FORS_FROM, CT_SP_PK_FROM,
                                CT_SP_CH_FROM, CT_SP_PK_FROM, CT_SP_PK_FROM};
    uint32_t sw[8], a[5], d[8 * CT_SP_LEN], h[15] = {}, w[16], st[8], v[8];
    uint32_t* pk = new uint32_t[CT_SP_AT(CT_SP_DATA_WORDS)]();
    hc_sp_words(sw, seed, 8);
    memcpy(a, addr, sizeof a);
    hc_sp_words(d, data, data_words[kind]);
    for (int f = 0; f < data_words[kind]; f++) pk[CT_SP_AT(f)] = d[f];
    const int nb = CT_SP_BLOCKS(lens[kind]);
    ct_sp_pk_tail(pk, data_words[kind], nb);
    // block b's words, the last block of a node excepted
    auto block = [&](int b) {
        ct_sp_head(h, kind, sw, a);
        switch (kind) {
            case CT_SP_FLEAF: ct_sp_fleaf_block(w, b, h, d); break;
            case CT_SP_FNODE: ct_sp_fnode_block(w, b, h, d, d + 8); break;
            case CT_SP_CH: ct_sp_ch_block(w, b, h, a[4], d); break;
            case CT_SP_NODE: ct_sp_node_block(w, b, h, d, d + 8); break;
            default: ct_sp_pk_block(w, b, nb, lens[kind], h, pk);
        }
    };
    const int node = kind == CT_SP_FNODE || kind == CT_SP_NODE;
    ct_sp_iv(st);
    int b = 0;
    if (mode == 1) {
        const uint32_t keep3 = a[3], keep4 = a[4];
        if (kind == CT_SP_FLEAF || kind == CT_SP_FNODE) a[3] = a[4] = 0;
        if (kind == CT_SP_CH) a[4] = 0;
        block(0);
        ct_sp_prefix(v, w, from[kind]);
        a[3] = keep3;
        a[4] = keep4;
        block(0);
        ct_sp_compress(st, v, w, from[kind]);
        b = 1;
    } else if (mode == 2) {
        block(0);
        memcpy(v, st, sizeof v);
        ct_sp_compress(st, v, w, 0);
        b = 1;
    }
    for (; b < nb - node; b++) {
        block(b);
        memcpy(v, st, sizeof v);
        ct_sp_compress(st, v, w, 0);
    }
    if (node) {
        ct_sp_length_words(w, lens[kind]);
        memcpy(v, st, sizeof v);
        ct_sp_compress(st, v, w, 0);
    }
    hc_sp_put_digest(out, st);
    delete[] pk;
}

// Kernel I: found[i] for n query rows.
void hc_ss_probe(const int32_t* keys, const int32_t* tags, int slots, int max_probe,
                 int n_shards, int shard, const int32_t* q, int n, int32_t* found) {
    for (int i = 0; i < n; i++) {
        const int32_t* qi = q + 8 * (size_t)i;
        found[i] = ct_ss_owner(qi, (uint32_t)n_shards) == (uint32_t)shard &&
                   ct_ss_first_hit(keys, tags, (uint32_t)slots, max_probe, qi) >= 0;
    }
}

// Kernel J: both phases over r requests of k rows, the table in place;
// out (r + r*k + 1): conflict, overflow, insert count.
void hc_ss_commit(int32_t* keys, int32_t* txs, int32_t* tags, int slots, int max_probe,
                  int n_shards, int shard, const int32_t* q, const int32_t* qtx,
                  const int32_t* qtag, const int32_t* valid, const int32_t* pre_conflict,
                  const int32_t* force, int r, int k, int32_t* out) {
    int rk = r * k;
    int32_t* present = new int32_t[rk > 0 ? rk : 1];
    int32_t* conf_row = new int32_t[rk > 0 ? rk : 1];
    for (int i = 0; i < rk; i++) {
        const int32_t* qi = q + 8 * (size_t)i;
        present[i] = conf_row[i] = 0;
        if (valid[i] != 0 && ct_ss_owner(qi, (uint32_t)n_shards) == (uint32_t)shard)
            ct_ss_check_row(keys, txs, tags, (uint32_t)slots, max_probe, qi,
                            qtx + 8 * (size_t)(i / k), &present[i], &conf_row[i]);
    }
    int32_t* conflict = out;
    int32_t* overflow = out + r;
    for (int t = 0; t < r; t++)
        conflict[t] = ct_ss_request_conflict(conf_row + (size_t)t * k, k, pre_conflict[t],
                                             force[t]);
    int inserted = 0;
    for (int i = 0; i < rk; i++) {
        const int32_t* qi = q + 8 * (size_t)i;
        overflow[i] = 0;
        if (!(valid[i] != 0 && ct_ss_owner(qi, (uint32_t)n_shards) == (uint32_t)shard &&
              conflict[i / k] == 0 && present[i] == 0))
            continue;
        int64_t slot = ct_ss_first_free(tags, (uint32_t)slots, max_probe, qi);
        if (slot < 0) {
            overflow[i] = 1;
            continue;
        }
        ct_ss_write_row(keys, txs, tags, (uint32_t)slot, qi, qtx + 8 * (size_t)(i / k), qtag[i]);
        inserted++;
    }
    out[r + rk] = inserted;
    delete[] present;
    delete[] conf_row;
}

// Kernel K: n rows in order, the table in place; out (n + 1): removed, count.
void hc_ss_remove(int32_t* keys, int32_t* txs, int32_t* tags, int slots, int max_probe,
                  int n_shards, int shard, const int32_t* q, const int32_t* valid, int n,
                  int32_t* out) {
    int removed = 0;
    for (int i = 0; i < n; i++) {
        const int32_t* qi = q + 8 * (size_t)i;
        out[i] = 0;
        if (!(valid[i] != 0 && ct_ss_owner(qi, (uint32_t)n_shards) == (uint32_t)shard)) continue;
        int64_t slot = ct_ss_first_hit(keys, tags, (uint32_t)slots, max_probe, qi);
        if (slot < 0) continue;
        ct_ss_tombstone(keys, txs, tags, (uint32_t)slot);
        out[i] = 1;
        removed++;
    }
    out[n] = removed;
}

}  // extern "C"
