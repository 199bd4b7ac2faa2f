// Kernel E: ed25519_comb, the fixed-base [r]B of batched signing.
//
// Replaces corda_tpu/ops/ed25519_sign.py::_comb_kernel (:89), launched
// there by scalar_mul_base (:146, pallas_call :162).
//
// One thread per signature; the arithmetic is ed25519_comb.cuh. What
// bounds it on this card: integer multiply-adds, 461 field multiplies and
// 254 squarings a lane (about 130k operations), plus the constant-time
// select, which reads and masks all 480 table words of every window (about
// 31k more); the bytes are 32 in and 32 out a lane, plus the table. The
// table (64 windows x 16 entries x 3 field elements of 10 int32 limbs,
// 122,880 bytes) stays in global memory and is read through the read-only
// cache: every thread of a warp reads the same word at the same time, so
// each load is one broadcast, and the whole table fits the SM's L1. Each
// lane is one long dependent chain, so at the notary's
// window of 2048 lanes (16 blocks) latency, not the multiply rate, sets
// the time.
#include <cuda_runtime.h>

#include "ed25519_comb.cuh"

__global__ void __launch_bounds__(128)
ed25519_comb_kernel(const uint8_t* __restrict__ r,
                    const int32_t* __restrict__ table,
                    uint8_t* __restrict__ out, int n) {
    int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    uint8_t enc[32];
    ct_comb_lane(enc, r + (size_t)lane * 32, table);
#pragma unroll
    for (int i = 0; i < 32; i++) out[(size_t)lane * 32 + i] = enc[i];
}

// r: (n, 32) uint8 little-endian scalars; table: (3072, 10) int32;
// out: (n, 32) uint8 encodings of [r]B. Launches on `stream`, returns the
// cudaError_t of the launch.
extern "C" int ct_ed25519_comb(const void* r, const void* table, void* out,
                               int n, void* stream) {
    dim3 grid((n + 127) / 128);
    ed25519_comb_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)r, (const int32_t*)table, (uint8_t*)out, n);
    return (int)cudaGetLastError();
}
