// Kernel G: ed25519_verify_g, the radix-4096 tier's verification.
//
// Replaces corda_tpu/ops/ed25519_pallas.py::_make_verify_kernel (:523),
// launched there by verify_pallas_windows (:666, pallas_call :706), for
// both of its fixed-base shapes: the 8-bit comb (fixed_win = 8) and the
// 16-entry window (fixed_win = 4), one instantiation each.
//
// One thread per signature, reading kernel B's inputs unchanged (the packed
// (B, 161) plane and kernel A's (64, B) windows of h). The ladder is kernel
// B's (ed25519_ladder.cuh) over another field, as the reference's two tiers
// are two field representations of one ladder: eight 32-bit words with the
// 2^256 = 38 fold (fe25519_w8.cuh), 64 products a multiply against B's 100.
// What bounds it on this card: integer multiply-adds, about 3.3k field
// multiplies and squarings a verify (3.8k with the 16-entry window); the
// bytes moved (418 a lane, plus the 24,672-byte constant table) are
// negligible beside them. As in kernel B each lane is one long dependent
// chain, so at the verifier's buckets latency and occupancy, not the
// multiply rate, set the time. The design keeps the accumulator in
// registers, puts the 16-entry table of -A (2,048 bytes a thread) in local
// memory, which L1 caches, and reads the comb (256 entries of 96 bytes)
// through the read-only data cache; faster versions would attack the
// local-memory table and the one lane a thread.
#include <cuda_runtime.h>

#include "ed25519_ladder.cuh"
#include "fe25519_w8.cuh"

template <int kFixedWin>
__global__ void __launch_bounds__(128)
ed25519_verify_g_kernel(const uint8_t* __restrict__ packed,
                        const int32_t* __restrict__ hwin,
                        const int32_t* __restrict__ table,
                        uint8_t* __restrict__ out, int n) {
    int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    ct_u256 tbl[16][4];
    out[lane] = ct_verify_lane_t<ct_fe8, kFixedWin>(
        packed + (size_t)lane * CT_PACKED_ROW, hwin + lane, n, table, tbl);
}

// packed: (n, 161) uint8; hwin: (64, n) int32; table: (771, 8) int32;
// out: (n,) uint8 verdicts; fixed_win: 8 or 4. Launches on `stream`,
// returns the cudaError_t.
extern "C" int ct_ed25519_verify_g(const void* packed, const void* hwin,
                                   const void* table, void* out, int n,
                                   int fixed_win, void* stream) {
    dim3 grid((n + 127) / 128);
    if (fixed_win == 8) {
        ed25519_verify_g_kernel<8><<<grid, 128, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)packed, (const int32_t*)hwin, (const int32_t*)table,
            (uint8_t*)out, n);
    } else if (fixed_win == 4) {
        ed25519_verify_g_kernel<4><<<grid, 128, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)packed, (const int32_t*)hwin, (const int32_t*)table,
            (uint8_t*)out, n);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
