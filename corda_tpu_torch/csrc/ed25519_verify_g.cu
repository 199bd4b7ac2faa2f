// Kernel G: ed25519_verify_g, the radix-4096 tier's verification.
//
// Replaces corda_tpu/ops/ed25519_pallas.py::_make_verify_kernel (:523),
// launched there by verify_pallas_windows (:666, pallas_call :706), for
// both of its fixed-base shapes: the 8-bit comb (fixed_win = 8) and the
// 16-entry window (fixed_win = 4), one instantiation each.
//
// Kernel B's four-thread ladder (ed25519_quad.cuh) over another field, as
// the reference's two tiers are two field representations of one ladder:
// eight 32-bit words with the 2^256 = 38 fold (fe25519_w8.cuh), 64 products
// a multiply and 36 a squaring against B's 100 and 55. It reads kernel B's
// inputs unchanged (the packed (B, 161) plane and kernel A's (64, B)
// windows of h). What bounds it on this card: integer multiply-adds, about
// 3.3k field multiplies and squarings a verify (3.5k with the 16-entry
// window); the bytes moved (418 a lane, plus the 24,672-byte constant
// table) are negligible beside them. As in kernel B, a lane's work is one
// long dependent chain: the design spreads each point over a quad of
// threads, one coordinate a thread, so the main path's 8,192 signatures
// fill 256 blocks (64 at one thread a signature); it keeps each thread's
// coordinate of the 16-entry table of -A in shared memory (64 KB a block
// of 32 signatures, three blocks an SM); and it reads the comb (256
// entries of 96 bytes) through the read-only data cache. The exponent
// chains run whole on each thread of the quad.
#include <cuda_runtime.h>

#include "ed25519_quad.cuh"
#include "fe25519_w8.cuh"

template <int kFixedWin>
__global__ void __launch_bounds__(CT_QUAD_BLOCK)
ed25519_verify_g_kernel(const uint8_t* __restrict__ packed,
                        const int32_t* __restrict__ hwin,
                        const int32_t* __restrict__ table,
                        uint8_t* __restrict__ out, int n,
                        int cofactored) {
    ct_quad_verify_thread<ct_fe8, kFixedWin>(packed, hwin, table, out, n, cofactored);
}

// packed: (n, 161) uint8; hwin: (64, n) int32; table: (771, 8) int32;
// out: (n,) uint8 verdicts; fixed_win: 8 or 4; cofactored: 1 for the
// cofactored rule of full buckets, else 0. Launches on `stream`, returns
// the cudaError_t.
extern "C" int ct_ed25519_verify_g(const void* packed, const void* hwin,
                                   const void* table, void* out, int n,
                                   int fixed_win, int cofactored, void* stream) {
    if (fixed_win == 8)
        return ct_quad_launch<ct_fe8>(ed25519_verify_g_kernel<8>, packed, hwin, table, out,
                                      n, cofactored, stream);
    if (fixed_win == 4)
        return ct_quad_launch<ct_fe8>(ed25519_verify_g_kernel<4>, packed, hwin, table, out,
                                      n, cofactored, stream);
    return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one block of either shape, as the launch sets it.
extern "C" int ct_ed25519_verify_g_smem_bytes() { return ct_quad_smem_bytes<ct_fe8>(); }
