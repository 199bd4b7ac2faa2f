// Kernel B: ed25519_verify_ladder, with the 8-bit comb of s, and its twin
// with the 16-entry window.
//
// Replaces corda_tpu/ops/ed25519_pallas13.py::_make_verify_kernel (:388),
// launched there by verify_pallas_windows (:483, pallas_call :514), for both
// of its fixed-base shapes: the comb (fixed_win = 8) and the 16-entry
// window (fixed_win = 4, consts[:64] :513), one instantiation each.
//
// Four threads a signature (ed25519_quad.cuh, ref10 limbs from
// fe25519.cuh, 64-bit products). What bounds it on this card: integer
// multiply-adds, about 1.7k field multiplies and 1.6k squarings a verify;
// the bytes moved (418 a lane, plus the 30,840-byte constant table) are
// negligible beside them. A lane's work is one long dependent chain: at
// one thread a signature the main path's 8,192 lanes would fill 64 blocks
// of one warp an SM sub-partition, and the chain's latency would set the
// time. The design spreads each point over a quad of threads, one
// coordinate a thread (a doubling is one squaring and one multiply a
// thread, an add two multiplies), so 8,192 signatures are 256 blocks; it
// keeps each thread's coordinate of the 16-entry table of -A in shared
// memory (80 KB a block of 32 signatures, two blocks an SM), where a
// thread's whole table (2.5 KB) would spill from L1 to L2; it squares with
// ref10's 55 products; and it reads the comb of B through the read-only
// cache. The decompression's and the encoding's
// exponent chains (about a third of the squarings) cannot be split by
// coordinate and run whole on each thread of the quad.
#include <cuda_runtime.h>

#include "ed25519_quad.cuh"

template <int kFixedWin>
__global__ void __launch_bounds__(CT_QUAD_BLOCK)
ed25519_verify_ladder_kernel(const uint8_t* __restrict__ packed,
                             const int32_t* __restrict__ hwin,
                             const int32_t* __restrict__ table,
                             uint8_t* __restrict__ out, int n,
                             int cofactored) {
    ct_quad_verify_thread<ct_fe10, kFixedWin>(packed, hwin, table, out, n, cofactored);
}

// packed: (n, 161) uint8; hwin: (64, n) int32; table: (771, 10) int32;
// out: (n,) uint8 verdicts; fixed_win: 8 or 4; cofactored: 1 for the
// cofactored rule of full buckets, else 0. Launches on `stream`, returns
// the cudaError_t.
extern "C" int ct_ed25519_verify_ladder(const void* packed, const void* hwin,
                                        const void* table, void* out, int n,
                                        int fixed_win, int cofactored, void* stream) {
    if (fixed_win == 8)
        return ct_quad_launch<ct_fe10>(ed25519_verify_ladder_kernel<8>, packed, hwin, table,
                                       out, n, cofactored, stream);
    if (fixed_win == 4)
        return ct_quad_launch<ct_fe10>(ed25519_verify_ladder_kernel<4>, packed, hwin, table,
                                       out, n, cofactored, stream);
    return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one block of either shape, as the launch sets it.
extern "C" int ct_ed25519_verify_ladder_smem_bytes() { return ct_quad_smem_bytes<ct_fe10>(); }
