// Kernel H's arithmetic: the SPHINCS verify of one signature (scheme 5,
// crypto/sphincs.py) by one block of CT_SP_THREADS threads. Shared by
// sphincs.cu (the card) and host_check.cpp (the host, which runs each
// stage's threads in turn, and each warp pair hash by hash: the producer's
// chunks of a hash, then the consumer's).
//
// Every hash is SHA-256 of tag || pub_seed || address || data, the address
// `>IQII` big-endian (layer u32, tree u64, leaf u32, j u32). Six message
// kinds, each of one length: a chain step (tag "ch", 86 bytes), a FORS leaf
// ("forsleaf", 92), a FORS node ("forsnode", 124), an auth node ("node",
// 120), the FORS pk ("forspk", 506) and a WOTS pk ("wotspk", 2,202). No
// message is laid out in bytes: each block is assembled as its 16
// big-endian words from the lane's words (seed, address, digests and
// signature values, all word-aligned in the signature), and where the data
// starts 2 bytes past a word boundary (the 2- and 6-byte tags) each word
// straddles two source words (ct_sp_shl16). Padding and length words are
// constants of the kind, so an unrolled block's schedule folds them.
//
// Prefix rounds are hoisted. The first 13 words of a chain step are the
// same for every chain and step of a layer, and of a FORS leaf or node for
// every tree and level of the lane; the first 14 of the FORS pk, of a
// layer's WOTS pk and of each auth node are known at launch, and at an odd
// auth position the auth node's whole first block is (the sibling comes
// first). Stage 0 computes each such state once (ct_sp_hoist), and every
// hash starts from it.
//
// The serial hashes run on a warp pair, as kernels C and A do: a producer
// warp assembles each block and expands W + K a chunk of 16 at a time
// (ct_sha256_wk_chunk) into a ring of shared slots, a consumer warp runs
// the rounds (ct_sp_rounds) and the final adds, and named barriers hand
// each chunk over (FULL, and EMPTY back). A hash that lifts the last one's
// digest waits for it: the consumer hands it back through shared memory
// (DIG). The length block that ends a FORS or auth node is constant: its
// W + K is a table the hoister writes once, which the consumer reads
// alone. The chain steps run one thread a chain: with 67 chains a layer on
// three warps, a producer warp each would put two warps on one of the
// SM's four schedulers.
//
// What sets the time, as measured on the card: one round's latency on
// the consumer (its dependent operations), not the issue rate, so the
// rounds are regrouped to three dependent operations (ct_sp_rounds); and
// the code's size, since with many blocks an SM its warps run different
// stages at once: a one-thread compression keeps chunks 1-3 in a loop
// (ct_sp_compress), each half of the pair one block's or one chunk's code.
// The chain step's second block, mostly constant, stays unrolled so its
// schedule folds.
//
// The stages, a barrier (__syncthreads) after each:
//   0      the pair walks the 14 FORS trees, one a lane (the producer's
//          lane t and the consumer's lane t; lanes 14-31 repeat tree 13),
//          and writes each root; warp 2 hoists the prefix states (the FORS
//          leaf's and node's first, which the consumer waits on: HOIST);
//   1      the pair hashes the FORS pk: the digest layer 0 signs;
//   2 + 2L layer L's chains: thread j < LEN takes its digit from the digest
//          and runs steps digit .. W - 2 of chain j, and writes its tip;
//   3 + 2L the pair hashes the WOTS pk and lifts it through HT auth levels:
//          the digest layer L + 1 signs (after layer D - 1, the root).
// Shared memory carries only what crosses threads, as words: the W + K
// slots and the digest hand-back (a lane's words at [i][lane], 16 bytes a
// lane), the hoisted states and length tables, the FORS roots and WOTS
// tips (the pk's data words, each thread's 8 at CT_SP_AT: no bank
// conflict), the digest.
// A lane that failed the host's precheck skips every stage.
#pragma once

#include "sha256.cuh"

#define CT_SP_N 32
#define CT_SP_W 16
#define CT_SP_LEN 67       // WOTS chains: 64 digits and 3 checksum digits
#define CT_SP_K 14         // FORS trees
#define CT_SP_A 8          // FORS tree height
#define CT_SP_D 4          // hypertree layers
#define CT_SP_HT 6         // XMSS tree height
#define CT_SP_SIG_LEN 13480
#define CT_SP_THREADS 96   // three warps: the pair (0 producer, 1 consumer), the hoister
#define CT_SP_FORS_LAYER 0xFFu
#define CT_SP_PROD 0
#define CT_SP_CONS 1
#define CT_SP_HOISTER 2

// named barriers (0 is __syncthreads): each joins two warps
#define CT_SP_BAR_HOIST 1   // the hoister's FORS prefixes -> the consumer
#define CT_SP_BAR_DIG 2     // a digest, consumer -> producer
#define CT_SP_BAR_FULL 3    // + slot: a chunk, producer -> consumer
#define CT_SP_BAR_EMPTY 7   // + slot: the slot free again
#define CT_SP_SLOTS 4

// a signature: randomizer (32) || idx (8) || K trees of sk + A siblings ||
// D layers of LEN chain values + HT siblings || pub_seed || root (every
// part word-aligned)
#define CT_SP_FORS_OFF 40
#define CT_SP_FORS_TREE (CT_SP_N * (1 + CT_SP_A))
#define CT_SP_LAYER_OFF (CT_SP_FORS_OFF + CT_SP_K * CT_SP_FORS_TREE)
#define CT_SP_LAYER_BYTES (CT_SP_N * (CT_SP_LEN + CT_SP_HT))
#define CT_SP_SEED_OFF (CT_SP_SIG_LEN - 2 * CT_SP_N)
#define CT_SP_ROOT_OFF (CT_SP_SIG_LEN - CT_SP_N)

// message lengths: tag || pub_seed (32) || address (20) || data
#define CT_SP_FLEAF_LEN (8 + 52 + CT_SP_N)               // 92
#define CT_SP_FNODE_LEN (8 + 52 + 2 * CT_SP_N)           // 124
#define CT_SP_FPK_LEN (6 + 52 + CT_SP_K * CT_SP_N)       // 506
#define CT_SP_CH_LEN (2 + 52 + CT_SP_N)                  // 86
#define CT_SP_WPK_LEN (6 + 52 + CT_SP_LEN * CT_SP_N)     // 2,202
#define CT_SP_NODE_LEN (4 + 52 + 2 * CT_SP_N)            // 120
// SHA-256 blocks of a message of `len` bytes (0x80 and the 64-bit length)
#define CT_SP_BLOCKS(len) (((len) + 9 + 63) / 64)

// the message kinds, and the rounds of their first block that read only
// words known at launch
enum { CT_SP_FLEAF, CT_SP_FNODE, CT_SP_FPK, CT_SP_CH, CT_SP_WPK, CT_SP_NODE };
#define CT_SP_FORS_FROM 13  // FORS leaf and node: tag, seed, layer, tree
#define CT_SP_CH_FROM 13    // chain step: tag, seed, layer, tree, leaf, 0 0
#define CT_SP_PK_FROM 14    // FORS pk, WOTS pk, auth node

// the hoisted states: an auth node's (layer L, level l) at 6L + l - 1
// (rounds 0-13, or at an odd position its first block's chaining value),
// a layer's chain step at 24 + L and WOTS pk at 28 + L (one a hoister
// lane), then the FORS leaf, node and pk
#define CT_SP_H_CH 24
#define CT_SP_H_WPK 28
#define CT_SP_H_FLEAF 32
#define CT_SP_H_FNODE 33
#define CT_SP_H_FPK 34
#define CT_SP_HOISTED 35

// word f of a thread-major array of 8-word rows in shared memory: a pad of
// 4 words after every 32, so that 8 threads storing their rows' halves as
// 16-byte words hit every bank once
#define CT_SP_AT(f) ((f) + (((f) >> 5) << 2))
// the pk data words: the WOTS tips (LEN rows, or the K FORS roots), then
// 0x80000000 and zeros to the end of the WOTS pk's last block
#define CT_SP_DATA_WORDS (16 * CT_SP_BLOCKS(CT_SP_WPK_LEN) - 14)

// One lane's shared memory.
struct ct_sp_smem {
#if defined(__CUDACC__)
    uint4 slot[CT_SP_SLOTS][4][32];  // W + K chunks, a lane's 16 words at [.][lane]
    uint4 dig[2][32];                // a digest handed back, a lane's 8 words
#endif
    alignas(16) uint32_t hoist[CT_SP_AT(8 * CT_SP_HOISTED)];
    alignas(16) uint32_t lenwk[2][64 + 4];  // W + K of the FORS and auth nodes' length blocks
    alignas(16) uint32_t data[CT_SP_AT(CT_SP_DATA_WORDS)];
    uint32_t digest[8];  // what the next layer signs, as SHA-256 state words
};

// the big-endian word at p, 4-byte aligned (signature bytes)
CT_HD uint32_t ct_sp_be(const uint8_t* p) {
#if defined(__CUDA_ARCH__)
    return __byte_perm(__ldg(reinterpret_cast<const uint32_t*>(p)), 0, 0x0123);
#else
    return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) | ((uint32_t)p[2] << 8) | p[3];
#endif
}

CT_HD void ct_sp_be8(uint32_t d[8], const uint8_t* p) {
#pragma unroll
    for (int i = 0; i < 8; i++) d[i] = ct_sp_be(p + 4 * i);
}

// the word that starts 2 bytes into hi: hi's low half, then lo's high half
CT_HD uint32_t ct_sp_shl16(uint32_t hi, uint32_t lo) { return ct_byte_perm(lo, hi, 0x5432); }

// 8 words at f (a multiple of 4) of a CT_SP_AT array: two 16-byte stores
CT_HD void ct_sp_store8(uint32_t* a, int f, const uint32_t d[8]) {
#if defined(__CUDA_ARCH__)
    *reinterpret_cast<uint4*>(a + CT_SP_AT(f)) = make_uint4(d[0], d[1], d[2], d[3]);
    *reinterpret_cast<uint4*>(a + CT_SP_AT(f + 4)) = make_uint4(d[4], d[5], d[6], d[7]);
#else
    for (int i = 0; i < 8; i++) a[CT_SP_AT(f + i)] = d[i];
#endif
}

CT_HD void ct_sp_load8(uint32_t d[8], const uint32_t* a, int f) {
#pragma unroll
    for (int i = 0; i < 8; i++) d[i] = a[CT_SP_AT(f + i)];
}

// Rounds from .. to - 1 of a chunk, over its 16 sums W[t] + K[t], with
// the sums regrouped so that a round's critical path is three dependent
// operations, not four: a serial hash is bound by the rounds' latency,
// not by the SM's issue rate. h + W + K and d + h + W + K do not read this
// round's e or a (h and d are e and a of three rounds back), so
//   e' = Sigma1(e) + Ch(e, f, g) + (d + h + W + K)
//   a' = Sigma0(a) + Maj(a, b, c) + (Sigma1(e) + Ch(e, f, g) + h + W + K)
// each take one three-input add after Sigma1 and Ch.
CT_HD void ct_sp_rounds(uint32_t v[8], const uint32_t wk[16], int from, int to) {
    uint32_t a = v[0], b = v[1], c = v[2], d = v[3];
    uint32_t e = v[4], f = v[5], g = v[6], h = v[7];
#pragma unroll
    for (int i = 0; i < 16; i++) {
        if (i < from || i >= to) continue;
        const uint32_t hk = h + wk[i];
        const uint32_t dhk = d + hk;
        const uint32_t s1 = ct_rotr32(e, 6) ^ ct_rotr32(e, 11) ^ ct_rotr32(e, 25);
        const uint32_t ch = (e & f) ^ (~e & g);
        const uint32_t t1 = s1 + ch + hk;
        const uint32_t s0 = ct_rotr32(a, 2) ^ ct_rotr32(a, 13) ^ ct_rotr32(a, 22);
        const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
        h = g;
        g = f;
        f = e;
        e = s1 + ch + dhk;
        d = c;
        c = b;
        b = a;
        a = s0 + maj + t1;
    }
    v[0] = a; v[1] = b; v[2] = c; v[3] = d;
    v[4] = e; v[5] = f; v[6] = g; v[7] = h;
}

// the round constant K[t], read by index (a chunk loop's t is not constant)
#if defined(__CUDACC__)
__constant__ uint32_t ct_sp_K[64] = CT_SHA256_K_INIT;
#endif
CT_HD uint32_t ct_sp_k(int t) {
#if defined(__CUDA_ARCH__)
    return ct_sp_K[t];
#else
    static const uint32_t K[64] = CT_SHA256_K_INIT;
    return K[t];
#endif
}

// ct_sha256_wk_chunk's arithmetic for a chunk c that need not be a
// constant: W[t] + K[t] for t = 16c .. 16c + 15, the ring w rolled on. A
// loop over the chunks then holds one chunk's code, which the SM's
// instruction cache keeps: every unrolled copy of a compression is 1,000
// instructions, and with many warps in different stages at once the
// kernel's speed went with its code's size.
CT_HD void ct_sp_wk_chunk(uint32_t wk[16], uint32_t w[16], int c) {
#pragma unroll
    for (int i = 0; i < 16; i++) {
        if (c > 0) {
            uint32_t x = w[(i + 1) & 15], y = w[(i + 14) & 15];
            uint32_t s0 = ct_rotr32(x, 7) ^ ct_rotr32(x, 18) ^ (x >> 3);
            uint32_t s1 = ct_rotr32(y, 17) ^ ct_rotr32(y, 19) ^ (y >> 10);
            w[i] = w[i] + s0 + w[(i + 9) & 15] + s1;
        }
        wk[i] = w[i] + ct_sp_k(16 * c + i);
    }
}

// rounds from .. 15 of a first chunk whose rounds before `from` (13 or
// 14) were hoisted
CT_HD void ct_sp_rounds_tail(uint32_t v[8], const uint32_t wk[16], int from) {
    if (from == 13) ct_sp_rounds(v, wk, 13, 14);
    ct_sp_rounds(v, wk, 14, 16);
}

// One compression on one thread: from round `from` (0, 13 or 14) with
// the working state v, the block's words w (clobbered), into the chaining
// state st. Chunk 0 is unrolled (K as immediates, the hoisted rounds left
// out), chunks 1-3 run as a loop over one chunk's code.
CT_HD void ct_sp_compress(uint32_t st[8], uint32_t v[8], uint32_t w[16], int from) {
    uint32_t wk[16];
    ct_sha256_wk_chunk(wk, w, 0);
    if (from) ct_sp_rounds_tail(v, wk, from);
    else ct_sp_rounds(v, wk, 0, 16);
#pragma unroll 1
    for (int c = 1; c < 4; c++) {
        ct_sp_wk_chunk(wk, w, c);
        ct_sp_rounds(v, wk, 0, 16);
    }
#pragma unroll
    for (int i = 0; i < 8; i++) st[i] += v[i];
}

CT_HD void ct_sp_iv(uint32_t st[8]) {
    const uint32_t iv[8] = CT_SHA256_IV_INIT;
#pragma unroll
    for (int i = 0; i < 8; i++) st[i] = iv[i];
}

// the working state after rounds 0 .. r - 1 (13 or 14) from the IV, which
// read only w[0 .. r - 1]
CT_HD void ct_sp_prefix(uint32_t v[8], uint32_t w[16], int r) {
    uint32_t wk[16];
    ct_sp_wk_chunk(wk, w, 0);
    ct_sp_iv(v);
    ct_sp_rounds(v, wk, 0, 13);
    if (r == 14) ct_sp_rounds(v, wk, 13, 14);
}

// ------------------------------------------------------- message words

// the 20-byte address (layer, tree, leaf, j) as 5 words
CT_HD void ct_sp_addr(uint32_t a[5], uint32_t layer, uint64_t tree, uint32_t leaf, uint32_t j) {
    a[0] = layer;
    a[1] = (uint32_t)(tree >> 32);
    a[2] = (uint32_t)tree;
    a[3] = leaf;
    a[4] = j;
}

// The whole words of tag || pub_seed || address of a kind: 15 (8-byte
// tags), 14 (the 4- and 6-byte tags) or 13 (the 2-byte tag). After a tag
// of 4q + 2 bytes every word straddles two: the tag's last two bytes, then
// each seed and address word in turn. The address's last word (j) then
// reaches into the first data word (the caller's).
CT_HD void ct_sp_head(uint32_t h[15], int kind, const uint32_t seed[8], const uint32_t a[5]) {
    uint32_t x[13];
#pragma unroll
    for (int i = 0; i < 8; i++) x[i] = seed[i];
#pragma unroll
    for (int i = 0; i < 5; i++) x[8 + i] = a[i];
    if (kind == CT_SP_FLEAF || kind == CT_SP_FNODE) {
        h[0] = 0x666f7273u;                                            // "fors"
        h[1] = kind == CT_SP_FLEAF ? 0x6c656166u : 0x6e6f6465u;         // "leaf", "node"
#pragma unroll
        for (int i = 0; i < 13; i++) h[2 + i] = x[i];
    } else if (kind == CT_SP_NODE) {
        h[0] = 0x6e6f6465u;                                            // "node"
#pragma unroll
        for (int i = 0; i < 13; i++) h[1 + i] = x[i];
    } else {
        const int q = kind == CT_SP_CH ? 0 : 1;
        if (q) h[0] = kind == CT_SP_FPK ? 0x666f7273u : 0x776f7473u;   // "fors", "wots"
        uint32_t prev = kind == CT_SP_CH ? 0x6368u : 0x706bu;          // "ch", "pk"
#pragma unroll
        for (int i = 0; i < 13; i++) {
            h[q + i] = ct_sp_shl16(prev, x[i]);
            prev = x[i];
        }
    }
}

// Block b (0, 1) of a FORS leaf: head (15 words)
// || d (92 bytes).
CT_HD void ct_sp_fleaf_block(uint32_t w[16], int b, const uint32_t h[15], const uint32_t d[8]) {
    if (b == 0) {
#pragma unroll
        for (int i = 0; i < 15; i++) w[i] = h[i];
        w[15] = d[0];
    } else {
#pragma unroll
        for (int i = 0; i < 7; i++) w[i] = d[1 + i];
        w[7] = 0x80000000u;
#pragma unroll
        for (int i = 8; i < 15; i++) w[i] = 0;
        w[15] = 8 * CT_SP_FLEAF_LEN;
    }
}

// Blocks 0 and 1 of a FORS node: head (15 words) || l || r (124 bytes).
// Block 2 is the length block (ct_sp_length_words).
CT_HD void ct_sp_fnode_block(uint32_t w[16], int b, const uint32_t h[15], const uint32_t l[8],
                             const uint32_t r[8]) {
    if (b == 0) {
#pragma unroll
        for (int i = 0; i < 15; i++) w[i] = h[i];
        w[15] = l[0];
    } else {
#pragma unroll
        for (int i = 0; i < 7; i++) w[i] = l[1 + i];
#pragma unroll
        for (int i = 0; i < 8; i++) w[7 + i] = r[i];
        w[15] = 0x80000000u;
    }
}

// Blocks 0 and 1 of an auth node: head (14 words) || l || r (120 bytes).
CT_HD void ct_sp_node_block(uint32_t w[16], int b, const uint32_t h[15], const uint32_t l[8],
                            const uint32_t r[8]) {
    if (b == 0) {
#pragma unroll
        for (int i = 0; i < 14; i++) w[i] = h[i];
        w[14] = l[0];
        w[15] = l[1];
    } else {
#pragma unroll
        for (int i = 0; i < 6; i++) w[i] = l[2 + i];
#pragma unroll
        for (int i = 0; i < 8; i++) w[6 + i] = r[i];
        w[14] = 0x80000000u;
        w[15] = 0;
    }
}

// The last block of a FORS or auth node: zeros and the bit length.
CT_HD void ct_sp_length_words(uint32_t w[16], int len) {
#pragma unroll
    for (int i = 0; i < 15; i++) w[i] = 0;
    w[15] = 8 * len;
}

// Block b (0, 1) of a chain step: head (13 words) || d (86 bytes), the
// data 2 bytes past a word boundary; jk = (j << 8) | k is the address's
// last word.
CT_HD void ct_sp_ch_block(uint32_t w[16], int b, const uint32_t h[15], uint32_t jk,
                          const uint32_t d[8]) {
    if (b == 0) {
#pragma unroll
        for (int i = 0; i < 13; i++) w[i] = h[i];
        w[13] = ct_sp_shl16(jk, d[0]);
        w[14] = ct_sp_shl16(d[0], d[1]);
        w[15] = ct_sp_shl16(d[1], d[2]);
    } else {
#pragma unroll
        for (int i = 0; i < 5; i++) w[i] = ct_sp_shl16(d[2 + i], d[3 + i]);
        w[5] = ct_sp_shl16(d[7], 0x80000000u);
#pragma unroll
        for (int i = 6; i < 15; i++) w[i] = 0;
        w[15] = 8 * CT_SP_CH_LEN;
    }
}

// Block b of a pk (the FORS pk, nb = 9, or a WOTS pk, nb = 35): head (14
// words) || the data words in `data` (a CT_SP_AT array), 2 bytes past a
// word boundary. Message word m >= 14 straddles data words m - 15 and
// m - 14 (word -1 is the address's j, 0): the data array holds the pad
// word and zeros after the data (ct_sp_pk_tail), and the last word is the
// bit length.
CT_HD void ct_sp_pk_block(uint32_t w[16], int b, int nb, int len, const uint32_t h[15],
                          const uint32_t* data) {
    if (b == 0) {
#pragma unroll
        for (int i = 0; i < 14; i++) w[i] = h[i];
        const uint32_t x0 = data[CT_SP_AT(0)], x1 = data[CT_SP_AT(1)];
        w[14] = x0 >> 16;
        w[15] = ct_sp_shl16(x0, x1);
    } else {
        uint32_t x[17];
        const int f0 = 16 * b - 15;
#pragma unroll
        for (int i = 0; i < 17; i++) x[i] = data[CT_SP_AT(f0 + i)];
#pragma unroll
        for (int i = 0; i < 16; i++) w[i] = ct_sp_shl16(x[i], x[i + 1]);
        if (b == nb - 1) w[15] = 8 * len;
    }
}

// The pad word and zeros after n data words, to word 16 nb - 15.
CT_HD void ct_sp_pk_tail(uint32_t* data, int n, int nb) {
    data[CT_SP_AT(n)] = 0x80000000u;
    for (int f = n + 1; f <= 16 * nb - 15; f++) data[CT_SP_AT(f)] = 0;
}

// --------------------------------------------------- the lane's values

struct ct_sp_lane {
    const uint8_t* sig;
    const uint8_t* dg;  // the FORS digest: tree t's leaf is dg[31 - t]
    uint64_t idx;
    uint32_t seed[8];
};

CT_HD void ct_sp_lane_init(ct_sp_lane& L, const uint8_t* sig, const uint8_t* dg, uint64_t idx) {
    L.sig = sig;
    L.dg = dg;
    L.idx = idx;
    ct_sp_be8(L.seed, sig + CT_SP_SEED_OFF);
}

CT_HD uint64_t ct_sp_tree(const ct_sp_lane& L, int layer) {
    return L.idx >> (CT_SP_HT * (layer + 1));
}

CT_HD uint32_t ct_sp_leaf(const ct_sp_lane& L, int layer) {
    return (uint32_t)(L.idx >> (CT_SP_HT * layer)) & ((1u << CT_SP_HT) - 1);
}

CT_HD const uint8_t* ct_sp_layer_sig(const ct_sp_lane& L, int layer) {
    return L.sig + CT_SP_LAYER_OFF + layer * CT_SP_LAYER_BYTES;
}

// Winternitz digit j of a digest: its 64 nibbles, high first, then the
// checksum sum(15 - d) in 3 nibbles, least significant first
CT_HD int ct_sp_nibble(const uint32_t dg[8], int j) {
    const uint32_t byte = (dg[j >> 3] >> (24 - 8 * ((j >> 1) & 3))) & 0xffu;
    return (int)((j & 1) ? (byte & 15u) : (byte >> 4));
}

CT_HD int ct_sp_digit(const uint32_t dg[8], int j) {
    if (j < 64) return ct_sp_nibble(dg, j);
    int csum = 0;
    for (int i = 0; i < 64; i++) csum += CT_SP_W - 1 - ct_sp_nibble(dg, i);
    return (csum >> (4 * (j - 64))) & 15;
}

// ------------------------------------------------------ stage 0, hoister
// ------------------------------------------------------ stage 0, hoister

// Hoister lane s (0..31): phase 0 the prefixes of the FORS leaf, node and
// pk (lanes 0-2), the pk tails (lane 3) and the W + K of the two length
// blocks (lanes 4, 5), which stage 0's consumer and stage 1 read; phase 1
// state s: an auth node's, a chain step's or a WOTS pk's.
CT_HD void ct_sp_hoist(ct_sp_smem& S, const ct_sp_lane& L, int s, int phase) {
    uint32_t a[5], h[15] = {}, w[16] = {}, v[8];
    int kind, r = CT_SP_PK_FROM;
    if (phase == 0) {
        if (s == 3) {
            ct_sp_pk_tail(S.data, CT_SP_K * 8, CT_SP_BLOCKS(CT_SP_FPK_LEN));
            ct_sp_pk_tail(S.data, CT_SP_LEN * 8, CT_SP_BLOCKS(CT_SP_WPK_LEN));
            return;
        }
        if (s == 4 || s == 5) {
            ct_sp_length_words(w, s == 4 ? CT_SP_FNODE_LEN : CT_SP_NODE_LEN);
            for (int c = 0; c < 4; c++) ct_sp_wk_chunk(S.lenwk[s - 4] + 16 * c, w, c);
            return;
        }
        if (s > 5) return;
        kind = s == 0 ? CT_SP_FLEAF : (s == 1 ? CT_SP_FNODE : CT_SP_FPK);
        if (s < 2) r = CT_SP_FORS_FROM;
        ct_sp_addr(a, CT_SP_FORS_LAYER, L.idx, 0, 0);  // leaf and j come after round 13
    } else if (s < CT_SP_H_CH) {
        const int layer = s / CT_SP_HT, lvl = s % CT_SP_HT + 1;
        const uint32_t pos = ct_sp_leaf(L, layer) >> (lvl - 1);
        kind = CT_SP_NODE;
        ct_sp_addr(a, (uint32_t)layer, ct_sp_tree(L, layer), (uint32_t)lvl, pos >> 1);
        if (pos & 1) {  // the sibling first: the whole first block
            const uint8_t* sib = ct_sp_layer_sig(L, layer) + CT_SP_N * (CT_SP_LEN + lvl - 1);
            ct_sp_head(h, kind, L.seed, a);
#pragma unroll
            for (int i = 0; i < 14; i++) w[i] = h[i];
            w[14] = ct_sp_be(sib);
            w[15] = ct_sp_be(sib + 4);
            uint32_t st[8];
            ct_sp_iv(st);
            ct_sp_iv(v);
            ct_sp_compress(st, v, w, 0);
            ct_sp_store8(S.hoist, 8 * s, st);
            return;
        }
    } else {
        const int layer = s & 3;
        kind = s < CT_SP_H_WPK ? CT_SP_CH : CT_SP_WPK;
        if (kind == CT_SP_CH) r = CT_SP_CH_FROM;
        ct_sp_addr(a, (uint32_t)layer, ct_sp_tree(L, layer), ct_sp_leaf(L, layer), 0);
    }
    ct_sp_head(h, kind, L.seed, a);
#pragma unroll
    for (int i = 0; i < 15; i++) w[i] = h[i];
    ct_sp_prefix(v, w, r);
    ct_sp_store8(S.hoist, 8 * (phase == 0 ? CT_SP_H_FLEAF + s : s), v);
}

// ---------------------------------------------------- the pair's halves
//
// C is the channel: on the card ct_sp_ring (shared slots and named
// barriers), on the host a queue. put/get move one chunk of 16 W + K
// sums; give/take hand a digest from the consumer back to the producer.
// Each half runs one loop over a hash's blocks, so its code holds one
// block's schedule (the producer) or one chunk's rounds (the consumer).

template <class C>
CT_HD void ct_sp_put(C& ch, uint32_t w[16]) {
#pragma unroll
    for (int c = 0; c < 4; c++) {
        uint32_t wk[16];
        ct_sha256_wk_chunk(wk, w, c);
        ch.put(wk);
    }
}

// The consumer's blocks of one hash into st, nb in all. from = 13 or 14:
// block 0 starts at that round with the working state hs (its chaining
// value the IV); from = 0: hs is the chaining value after a first block
// hoisted whole, and block 1 comes first. With `table`, the last block is
// a length block whose W + K the table holds.
template <class C>
CT_HD void ct_sp_get_hash(C& ch, uint32_t st[8], const uint32_t* hs, int from, int nb,
                          const uint32_t* table) {
    uint32_t v[8];
    if (from) ct_sp_iv(st);
#pragma unroll
    for (int i = 0; i < 8; i++) {
        v[i] = hs[i];
        if (!from) st[i] = hs[i];
    }
#pragma unroll 1
    for (int b = from ? 0 : 1; b < nb; b++) {
        const uint32_t* fixed = table && b == nb - 1 ? table : nullptr;
#pragma unroll 1
        for (int c = 0; c < 4; c++) {
            uint32_t wk[16];
            if (fixed) {
#pragma unroll
                for (int i = 0; i < 16; i++) wk[i] = fixed[16 * c + i];
            } else {
                ch.get(wk);
            }
            if (b == 0 && c == 0) ct_sp_rounds_tail(v, wk, from);
            else ct_sp_rounds(v, wk, 0, 16);
        }
#pragma unroll
        for (int i = 0; i < 8; i++) {
            st[i] += v[i];
            v[i] = st[i];
        }
    }
}

// the lifted node's halves: (node, sib) at an even position, (sib, node)
// at an odd one
CT_HD void ct_sp_order(uint32_t l[8], uint32_t r[8], uint32_t pos, const uint32_t node[8],
                       const uint32_t sib[8]) {
#pragma unroll
    for (int i = 0; i < 8; i++) {
        l[i] = (pos & 1) ? sib[i] : node[i];
        r[i] = (pos & 1) ? node[i] : sib[i];
    }
}

// Stage 0, producer: hash h of FORS tree t (0 the leaf, then levels
// 1..A, each after the last one's node comes back).
template <class C>
CT_HD void ct_sp_fors_put(C& ch, const ct_sp_lane& L, int t, int h) {
    const uint8_t* part = L.sig + CT_SP_FORS_OFF + t * CT_SP_FORS_TREE;
    const uint32_t pos = (uint32_t)L.dg[31 - t] >> (h ? h - 1 : 0);
    uint32_t node[8] = {}, sib[8], l[8], r[8], a[5], hd[15], w[16];
    ct_sp_be8(sib, part + CT_SP_N * h);  // the leaf's secret at h = 0
    if (h) {
        ch.take(node);
        ct_sp_addr(a, CT_SP_FORS_LAYER, L.idx, ((uint32_t)t << 8) | (uint32_t)h, pos >> 1);
    } else {
        ct_sp_addr(a, CT_SP_FORS_LAYER, L.idx, (uint32_t)t, pos);
    }
    ct_sp_head(hd, h ? CT_SP_FNODE : CT_SP_FLEAF, L.seed, a);
    ct_sp_order(l, r, pos, node, sib);
#pragma unroll 1
    for (int b = 0; b < 2; b++) {
        if (h) ct_sp_fnode_block(w, b, hd, l, r);
        else ct_sp_fleaf_block(w, b, hd, sib);
        ct_sp_put(ch, w);
    }
}

// Stage 0, consumer: hash h of the lane's FORS tree into node, handed back
// unless it is the root.
template <class C>
CT_HD void ct_sp_fors_get(C& ch, const ct_sp_smem& S, int h, uint32_t node[8]) {
    ct_sp_get_hash(ch, node, S.hoist + CT_SP_AT(8 * (h ? CT_SP_H_FNODE : CT_SP_H_FLEAF)),
                   CT_SP_FORS_FROM, h ? 3 : 2, h ? S.lenwk[0] : nullptr);
    if (h < CT_SP_A) ch.give(node);
}

// Stage 1, producer: the FORS pk over the roots in S.data.
template <class C>
CT_HD void ct_sp_fpk_put(C& ch, const ct_sp_lane& L, const ct_sp_smem& S) {
    uint32_t a[5], hd[15], w[16];
    ct_sp_addr(a, CT_SP_FORS_LAYER, L.idx, 0, 0);
    ct_sp_head(hd, CT_SP_FPK, L.seed, a);
    const int nb = CT_SP_BLOCKS(CT_SP_FPK_LEN);
#pragma unroll 1
    for (int b = 0; b < nb; b++) {
        ct_sp_pk_block(w, b, nb, CT_SP_FPK_LEN, hd, S.data);
        ct_sp_put(ch, w);
    }
}

// Stage 3 + 2L, producer: hash h of layer L, 0 the WOTS pk over the tips
// in S.data, then auth levels 1..HT, each after the last node comes back
// (at an odd position only its second block: the first was hoisted).
template <class C>
CT_HD void ct_sp_layer_put(C& ch, const ct_sp_lane& L, const ct_sp_smem& S, int layer, int h) {
    const uint64_t tree = ct_sp_tree(L, layer);
    const uint32_t leaf = ct_sp_leaf(L, layer);
    const uint32_t pos = leaf >> (h ? h - 1 : 0);
    const int nb = CT_SP_BLOCKS(CT_SP_WPK_LEN);
    uint32_t node[8], sib[8], l[8], r[8], a[5], hd[15], w[16];
    if (h) {
        ct_sp_be8(sib, ct_sp_layer_sig(L, layer) + CT_SP_N * (CT_SP_LEN + h - 1));
        ch.take(node);
        ct_sp_order(l, r, pos, node, sib);
        ct_sp_addr(a, (uint32_t)layer, tree, (uint32_t)h, pos >> 1);
    } else {
        ct_sp_addr(a, (uint32_t)layer, tree, leaf, 0);
    }
    ct_sp_head(hd, h ? CT_SP_NODE : CT_SP_WPK, L.seed, a);
#pragma unroll 1
    for (int b = h && (pos & 1) ? 1 : 0; b < (h ? 2 : nb); b++) {
        if (h) ct_sp_node_block(w, b, hd, l, r);
        else ct_sp_pk_block(w, b, nb, CT_SP_WPK_LEN, hd, S.data);
        ct_sp_put(ch, w);
    }
}

// Stage 3 + 2L, consumer: hash h of layer L into node, handed back unless
// it is the layer's root.
template <class C>
CT_HD void ct_sp_layer_get(C& ch, const ct_sp_lane& L, const ct_sp_smem& S, int layer, int h,
                           uint32_t node[8]) {
    const uint32_t pos = ct_sp_leaf(L, layer) >> (h ? h - 1 : 0);
    const int state = h ? CT_SP_HT * layer + h - 1 : CT_SP_H_WPK + layer;
    ct_sp_get_hash(ch, node, S.hoist + CT_SP_AT(8 * state), h && (pos & 1) ? 0 : CT_SP_PK_FROM,
                   h ? 3 : CT_SP_BLOCKS(CT_SP_WPK_LEN), h ? S.lenwk[1] : nullptr);
    if (h < CT_SP_HT) ch.give(node);
}

// ------------------------------------------------- stage 2 + 2L, chains

// Thread j < LEN: chain j from its digit to its tip, written to S.data.
CT_HD void ct_sp_chain(ct_sp_smem& S, const ct_sp_lane& L, int j, int layer) {
    uint32_t dg[8], a[5], hd[15], v0[8], d[8];
#pragma unroll
    for (int i = 0; i < 8; i++) dg[i] = S.digest[i];
    const int digit = ct_sp_digit(dg, j);
    ct_sp_addr(a, (uint32_t)layer, ct_sp_tree(L, layer), ct_sp_leaf(L, layer), 0);
    ct_sp_head(hd, CT_SP_CH, L.seed, a);  // its 13 words do not read j or k
    ct_sp_load8(v0, S.hoist, 8 * (CT_SP_H_CH + layer));
    ct_sp_be8(d, ct_sp_layer_sig(L, layer) + CT_SP_N * j);
    for (int k = digit; k < CT_SP_W - 1; k++) {
        const uint32_t jk = ((uint32_t)j << 8) | (uint32_t)k;
        uint32_t st[8];
        ct_sp_iv(st);
        uint32_t w[16], v[8];
        ct_sp_ch_block(w, 0, hd, jk, d);
#pragma unroll
        for (int i = 0; i < 8; i++) v[i] = v0[i];
        ct_sp_compress(st, v, w, CT_SP_CH_FROM);
        ct_sp_ch_block(w, 1, hd, jk, d);  // mostly constant: its schedule folds
        ct_sha256_compress(st, w);
#pragma unroll
        for (int i = 0; i < 8; i++) d[i] = st[i];
    }
    ct_sp_store8(S.data, 8 * j, d);
}

// After the last stage: the top root against the signature's claimed root.
CT_HD int ct_sp_verdict(const ct_sp_smem& S, const uint8_t* sig) {
    int eq = 1;
    for (int i = 0; i < 8; i++) eq &= S.digest[i] == ct_sp_be(sig + CT_SP_ROOT_OFF + 4 * i);
    return eq;
}

// ------------------------------------------------------ the card's ring

#if defined(__CUDACC__)
// The pair's channel on the card: chunk q goes through slot q % SLOTS, a
// lane's 16 words at slot[s][0..3][lane]; the producer waits for the slot's
// EMPTY before reusing it and, at a job's end, drains the EMPTY arrivals it
// has not waited for, so every barrier's arrivals are matched.
struct ct_sp_ring {
    ct_sp_smem* S;
    int lane;
    int q;

    CT_HD void put(const uint32_t wk[16]) {
#if defined(__CUDA_ARCH__)
        const int s = q & (CT_SP_SLOTS - 1);
        if (q >= CT_SP_SLOTS) ct_bar_sync(CT_SP_BAR_EMPTY + s, 64);
#pragma unroll
        for (int i = 0; i < 4; i++)
            S->slot[s][i][lane] = make_uint4(wk[4 * i], wk[4 * i + 1], wk[4 * i + 2],
                                             wk[4 * i + 3]);
        ct_bar_arrive(CT_SP_BAR_FULL + s, 64);
        q++;
#endif
    }

    CT_HD void get(uint32_t wk[16]) {
#if defined(__CUDA_ARCH__)
        const int s = q & (CT_SP_SLOTS - 1);
        ct_bar_sync(CT_SP_BAR_FULL + s, 64);
#pragma unroll
        for (int i = 0; i < 4; i++) {
            const uint4 x = S->slot[s][i][lane];
            wk[4 * i] = x.x;
            wk[4 * i + 1] = x.y;
            wk[4 * i + 2] = x.z;
            wk[4 * i + 3] = x.w;
        }
        ct_bar_arrive(CT_SP_BAR_EMPTY + s, 64);
        q++;
#endif
    }

    CT_HD void give(const uint32_t d[8]) {
#if defined(__CUDA_ARCH__)
        S->dig[0][lane] = make_uint4(d[0], d[1], d[2], d[3]);
        S->dig[1][lane] = make_uint4(d[4], d[5], d[6], d[7]);
        ct_bar_arrive(CT_SP_BAR_DIG, 64);
#endif
    }

    CT_HD void take(uint32_t d[8]) {
#if defined(__CUDA_ARCH__)
        ct_bar_sync(CT_SP_BAR_DIG, 64);
        const uint4 x = S->dig[0][lane], y = S->dig[1][lane];
        d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
        d[4] = y.x; d[5] = y.y; d[6] = y.z; d[7] = y.w;
#endif
    }

    CT_HD void drain() {
#if defined(__CUDA_ARCH__)
        for (int i = q < CT_SP_SLOTS ? 0 : q - CT_SP_SLOTS; i < q; i++)
            ct_bar_sync(CT_SP_BAR_EMPTY + (i & (CT_SP_SLOTS - 1)), 64);
#endif
    }
};
#endif
