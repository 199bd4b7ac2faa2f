// A plain C ABI over the kernels' shared arithmetic, built with a host C++
// compiler so the CPU tests can hold the exact code of kernels A and B
// against the reference before any card is involved. Field elements cross
// the boundary as 32-byte little-endian strings.
#include "ed25519_ladder.cuh"
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

}  // extern "C"
