// Kernel B: ed25519_verify_ladder.
//
// Replaces corda_tpu/ops/ed25519_pallas13.py::_make_verify_kernel (:388),
// launched there by verify_pallas_windows (:483, pallas_call :514).
//
// One thread per signature; the arithmetic is ed25519_ladder.cuh (ref10
// limbs, 64-bit products). What bounds it on this card: integer
// multiply-adds, about 3.3k field multiplies of 100 32x32->64 products per
// verify; the bytes moved (418 per lane) are negligible beside them. But a
// lane's work is one long dependent chain, and at the main path's 8192
// lanes the grid is 64 blocks of one warp per SM sub-partition, so the
// chain's latency, not the multiply rate, sets the time (PERF.md). The
// design keeps the per-lane state in registers, puts the 16-entry table of
// -A (2.5 KB per thread) in local memory, which L1 caches, and reads the
// 256-entry comb of B from the constant table through the read-only cache.
// Occupancy and the local-memory table are what a faster version would
// attack (shared-memory tables, several threads per signature).
#include <cuda_runtime.h>

#include "ed25519_ladder.cuh"

__global__ void __launch_bounds__(128)
ed25519_verify_ladder_kernel(const uint8_t* __restrict__ packed,
                             const int32_t* __restrict__ hwin,
                             const int32_t* __restrict__ table,
                             uint8_t* __restrict__ out, int n) {
    int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    ct_fe tbl[16][4];
    out[lane] = ct_verify_lane(packed + (size_t)lane * CT_PACKED_ROW,
                               hwin + lane, n, table, tbl);
}

// packed: (n, 161) uint8; hwin: (64, n) int32; table: (771, 10) int32;
// out: (n,) uint8 verdicts. Launches on `stream`, returns the cudaError_t.
extern "C" int ct_ed25519_verify_ladder(const void* packed, const void* hwin,
                                        const void* table, void* out, int n,
                                        void* stream) {
    dim3 grid((n + 127) / 128);
    ed25519_verify_ladder_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)packed, (const int32_t*)hwin, (const int32_t*)table,
        (uint8_t*)out, n);
    return (int)cudaGetLastError();
}
