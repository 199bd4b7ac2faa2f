// A plain C ABI over the kernels' shared arithmetic, built with a host C++
// compiler so the CPU tests can hold the exact code of kernels A and B
// against the reference before any card is involved. Field elements cross
// the boundary as 32-byte little-endian strings, SHA-256 digests as 8
// words.
#include "ed25519_comb.cuh"
#include "ed25519_ladder.cuh"
#include "sha256.cuh"
#include "sha512_modl.cuh"

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
    int ok = ct_decompress(x, y, pk[31] >> 7, table);
    ct_fe_to_bytes(x_out, x);
    return ok;
}

// one packed row -> 64 windows of h mod L
void hc_challenge(const uint8_t* row, int32_t* win) {
    ct_challenge_lane(row, win, 1);
}

// one packed row + its 64 windows -> verdict
int hc_verify(const uint8_t* row, const int32_t* win, const int32_t* table) {
    ct_fe tbl[16][4];
    return ct_verify_lane(row, win, 1, table, tbl);
}

// kernel C's lane: the digest of `nblk` padded 64-byte blocks
void hc_sha256_blocks(const uint8_t* blocks, int nblk, uint32_t* out) {
    ct_sha256_blocks(out, blocks, nblk);
}

// kernel D's lane: SHA-256 of left || right (8 words each)
void hc_sha256_pair(const uint32_t* left, const uint32_t* right,
                    uint32_t* out) {
    ct_sha256_pair(out, left, right);
}

// kernel E's lane: the encoding of [r]B for a 32-byte scalar
void hc_comb(const uint8_t* r, const int32_t* table, uint8_t* out) {
    ct_comb_lane(out, r, table);
}

}  // extern "C"
