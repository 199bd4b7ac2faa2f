// Kernel H's arithmetic: the SPHINCS verify of one signature (scheme 5,
// crypto/sphincs.py) by one block of CT_SP_THREADS threads, stage by
// stage. Shared by sphincs.cu (the card) and host_check.cpp (the host,
// which runs each stage for every thread in turn).
//
// Every hash is SHA-256 of tag || pub_seed || address || data, the address
// `>IQII` big-endian (layer u32, tree u64, leaf u32, j u32). Each message
// is laid out whole in shared memory, padded there, and hashed block by
// block with sha256.cuh's compression (ct_sha256_blocks), so the long ones
// (the FORS pk's 506 bytes, the WOTS pk's 2,202) are one buffer a block,
// written by many threads and read by one.
//
// The stages, a barrier after each (ct_sp_stage):
//   0      FORS: thread t < K walks tree t, leaf then A levels, and writes
//          its root into the FORS pk message; thread K writes that
//          message's prefix and padding;
//   1      thread 0 hashes the FORS pk: the digest layer 0 signs;
//   2 + 2L layer L's chains: thread j < LEN takes its digit from the
//          digest and runs steps digit .. W - 2 of chain j, writing the tip
//          into the WOTS pk message; thread LEN writes its prefix;
//   3 + 2L thread 0 hashes the WOTS pk and lifts it through HT auth levels:
//          the digest layer L + 1 signs (after layer D - 1, the root).
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
#define CT_SP_THREADS 96   // three warps: 67 chains, then the prefix writer
#define CT_SP_STAGES (2 + 2 * CT_SP_D)
#define CT_SP_FORS_LAYER 0xFFu

// a signature: randomizer (32) || idx (8) || K trees of sk + A siblings ||
// D layers of LEN chain values + HT siblings || pub_seed || root
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

// One lane's shared memory.
struct ct_sp_smem {
    uint8_t msg[CT_SP_LEN][64 * CT_SP_BLOCKS(CT_SP_FNODE_LEN)];  // a thread's
                                     // chain step, or FORS leaf and nodes
    uint8_t wots[64 * CT_SP_BLOCKS(CT_SP_WPK_LEN)];
    uint8_t forspk[64 * CT_SP_BLOCKS(CT_SP_FPK_LEN)];
    uint8_t node[64 * CT_SP_BLOCKS(CT_SP_NODE_LEN)];
    uint32_t digest[8];  // what the next layer signs, as SHA-256 state words
};

CT_HD void ct_sp_be32(uint8_t* p, uint32_t v) {
    p[0] = (uint8_t)(v >> 24);
    p[1] = (uint8_t)(v >> 16);
    p[2] = (uint8_t)(v >> 8);
    p[3] = (uint8_t)v;
}

CT_HD void ct_sp_copy(uint8_t* dst, const uint8_t* src, int n) {
    for (int i = 0; i < n; i++) dst[i] = src[i];
}

// the 20-byte address (layer, tree, leaf, j), `>IQII`
CT_HD void ct_sp_addr(uint8_t* p, uint32_t layer, uint64_t tree, uint32_t leaf, uint32_t j) {
    ct_sp_be32(p, layer);
    ct_sp_be32(p + 4, (uint32_t)(tree >> 32));
    ct_sp_be32(p + 8, (uint32_t)tree);
    ct_sp_be32(p + 12, leaf);
    ct_sp_be32(p + 16, j);
}

// tag || pub_seed at p; returns the offset of the address
CT_HD int ct_sp_prefix(uint8_t* p, const char* tag, int tag_len, const uint8_t* seed) {
    ct_sp_copy(p, (const uint8_t*)tag, tag_len);
    ct_sp_copy(p + tag_len, seed, CT_SP_N);
    return tag_len + CT_SP_N;
}

// SHA-256 padding of a `len`-byte message in its buffer: 0x80, zeros, the
// big-endian bit length at the end of its last block
CT_HD void ct_sp_pad(uint8_t* buf, int len) {
    const int end = 64 * CT_SP_BLOCKS(len);
    buf[len] = 0x80;
    for (int i = len + 1; i < end - 8; i++) buf[i] = 0;
    const uint64_t bits = (uint64_t)len * 8;
    for (int i = 0; i < 8; i++) buf[end - 1 - i] = (uint8_t)(bits >> (8 * i));
}

CT_HD void ct_sp_put_digest(uint8_t* p, const uint32_t st[8]) {
    for (int i = 0; i < 8; i++) ct_sp_be32(p + 4 * i, st[i]);
}

CT_HD void ct_sp_hash(uint32_t out[8], const uint8_t* buf, int len) {
    ct_sha256_blocks(out, buf, CT_SP_BLOCKS(len));
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

// an auth-path step's message: (node, sib) at an even position, (sib,
// node) at an odd one
CT_HD void ct_sp_pair(uint8_t* p, uint32_t pos, const uint32_t node[8], const uint8_t* sib) {
    if (pos & 1) {
        ct_sp_copy(p, sib, CT_SP_N);
        ct_sp_put_digest(p + CT_SP_N, node);
    } else {
        ct_sp_put_digest(p, node);
        ct_sp_copy(p + CT_SP_N, sib, CT_SP_N);
    }
}

// Stage 0, thread t < K: FORS tree t, its leaf fors_dg[31 - t] (bits 8t ..
// 8t + 7 of the big-endian digest)
CT_HD void ct_sp_fors_tree(ct_sp_smem& S, int t, const uint8_t* sig, const uint8_t* dg,
                           uint64_t idx) {
    const uint8_t* seed = sig + CT_SP_SEED_OFF;
    const uint8_t* part = sig + CT_SP_FORS_OFF + t * CT_SP_FORS_TREE;
    uint8_t* m = S.msg[t];
    uint32_t pos = dg[31 - t];
    uint32_t node[8];
    int a = ct_sp_prefix(m, "forsleaf", 8, seed);
    ct_sp_addr(m + a, CT_SP_FORS_LAYER, idx, (uint32_t)t, pos);
    ct_sp_copy(m + a + 20, part, CT_SP_N);
    ct_sp_pad(m, CT_SP_FLEAF_LEN);
    ct_sp_hash(node, m, CT_SP_FLEAF_LEN);
    ct_sp_copy(m, (const uint8_t*)"forsnode", 8);  // the seed stays
    ct_sp_pad(m, CT_SP_FNODE_LEN);
    for (int lvl = 0; lvl < CT_SP_A; lvl++) {
        ct_sp_addr(m + a, CT_SP_FORS_LAYER, idx, ((uint32_t)t << 8) | (uint32_t)(lvl + 1),
                   pos >> 1);
        ct_sp_pair(m + a + 20, pos, node, part + CT_SP_N * (lvl + 1));
        ct_sp_hash(node, m, CT_SP_FNODE_LEN);
        pos >>= 1;
    }
    ct_sp_put_digest(S.forspk + 6 + 52 + CT_SP_N * t, node);
}

// Stage 2 + 2L, thread j < LEN: chain j from its digit to its tip
CT_HD void ct_sp_chain(ct_sp_smem& S, int j, const uint8_t* sig, uint64_t idx, int layer) {
    const uint64_t tree = idx >> (CT_SP_HT * (layer + 1));
    const uint32_t leaf = (uint32_t)(idx >> (CT_SP_HT * layer)) & ((1u << CT_SP_HT) - 1);
    const int digit = ct_sp_digit(S.digest, j);
    uint8_t* m = S.msg[j];
    int a = ct_sp_prefix(m, "ch", 2, sig + CT_SP_SEED_OFF);
    ct_sp_addr(m + a, (uint32_t)layer, tree, leaf, (uint32_t)j << 8);
    ct_sp_copy(m + a + 20,
               sig + CT_SP_LAYER_OFF + layer * CT_SP_LAYER_BYTES + CT_SP_N * j, CT_SP_N);
    ct_sp_pad(m, CT_SP_CH_LEN);
    for (int k = digit; k < CT_SP_W - 1; k++) {
        uint32_t x[8];
        m[a + 19] = (uint8_t)k;  // the low byte of (j << 8) | k
        ct_sp_hash(x, m, CT_SP_CH_LEN);
        ct_sp_put_digest(m + a + 20, x);
    }
    ct_sp_copy(S.wots + 6 + 52 + CT_SP_N * j, m + a + 20, CT_SP_N);
}

// Stage 3 + 2L, thread 0: the WOTS pk, then the HT auth levels
CT_HD void ct_sp_xmss_root(ct_sp_smem& S, const uint8_t* sig, uint64_t idx, int layer) {
    const uint64_t tree = idx >> (CT_SP_HT * (layer + 1));
    uint32_t pos = (uint32_t)(idx >> (CT_SP_HT * layer)) & ((1u << CT_SP_HT) - 1);
    const uint8_t* auth =
        sig + CT_SP_LAYER_OFF + layer * CT_SP_LAYER_BYTES + CT_SP_N * CT_SP_LEN;
    uint32_t node[8];
    ct_sp_hash(node, S.wots, CT_SP_WPK_LEN);
    uint8_t* m = S.node;
    int a = ct_sp_prefix(m, "node", 4, sig + CT_SP_SEED_OFF);
    ct_sp_pad(m, CT_SP_NODE_LEN);
    for (int lvl = 1; lvl <= CT_SP_HT; lvl++) {
        ct_sp_addr(m + a, (uint32_t)layer, tree, (uint32_t)lvl, pos >> 1);
        ct_sp_pair(m + a + 20, pos, node, auth + CT_SP_N * (lvl - 1));
        ct_sp_hash(node, m, CT_SP_NODE_LEN);
        pos >>= 1;
    }
    for (int i = 0; i < 8; i++) S.digest[i] = node[i];
}

// Stage s of one lane for thread t (0 .. CT_SP_THREADS - 1). Every thread
// of the block calls every stage, with a barrier between two.
CT_HD void ct_sp_stage(ct_sp_smem& S, int s, int t, const uint8_t* sig, const uint8_t* dg,
                       uint64_t idx) {
    const uint8_t* seed = sig + CT_SP_SEED_OFF;
    if (s == 0) {
        if (t < CT_SP_K) {
            ct_sp_fors_tree(S, t, sig, dg, idx);
        } else if (t == CT_SP_K) {
            int a = ct_sp_prefix(S.forspk, "forspk", 6, seed);
            ct_sp_addr(S.forspk + a, CT_SP_FORS_LAYER, idx, 0, 0);
            ct_sp_pad(S.forspk, CT_SP_FPK_LEN);
        }
    } else if (s == 1) {
        if (t == 0) ct_sp_hash(S.digest, S.forspk, CT_SP_FPK_LEN);
    } else {
        const int layer = (s - 2) >> 1;
        if ((s & 1) == 0) {
            if (t < CT_SP_LEN) {
                ct_sp_chain(S, t, sig, idx, layer);
            } else if (t == CT_SP_LEN) {
                int a = ct_sp_prefix(S.wots, "wotspk", 6, seed);
                ct_sp_addr(S.wots + a, (uint32_t)layer, idx >> (CT_SP_HT * (layer + 1)),
                           (uint32_t)(idx >> (CT_SP_HT * layer)) & ((1u << CT_SP_HT) - 1), 0);
                ct_sp_pad(S.wots, CT_SP_WPK_LEN);
            }
        } else if (t == 0) {
            ct_sp_xmss_root(S, sig, idx, layer);
        }
    }
}

// After the last stage: the top root against the signature's claimed root.
CT_HD int ct_sp_verdict(const ct_sp_smem& S, const uint8_t* sig) {
    uint8_t got[CT_SP_N];
    ct_sp_put_digest(got, S.digest);
    int eq = 1;
    for (int i = 0; i < CT_SP_N; i++) eq &= got[i] == sig[CT_SP_ROOT_OFF + i];
    return eq;
}
