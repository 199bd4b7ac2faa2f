// Kernel E: ed25519_comb, the fixed-base [r]B of batched signing.
//
// Replaces corda_tpu/ops/ed25519_sign.py::_comb_kernel (:89), launched
// there by scalar_mul_base (:146, pallas_call :162).
//
// What bounds it on this card: integer multiply-adds, about 161k 32-bit
// operations a signature counted serially (461 field multiplies, 254
// squarings and the constant-time select's 30,720 masked words); the bytes
// are 32 in and 32 out a signature, plus the table. The work is one chain
// of dependent field operations a signature, so latency sets the time
// unless the chain is cut and the card filled.
//
// The design (ed25519_comb.cuh has the arithmetic): sixteen threads a
// signature, four quads, each quad one partial sum over 16 consecutive
// windows, one point coordinate a thread. A 128-thread block holds 8
// signatures, and warp s holds partial sum s of all 8, so at every step
// all the threads of a warp read the same window's rows: each load is a
// broadcast of at most three rows' words (a quad's three coordinates), and
// a thread reads only the element its coordinate needs (160 words a
// window; the fourth thread of a quad reads none). At the notary's window
// of 2,048 signatures the grid is 256 blocks: every SM of the card gets
// one or two. The partial sums meet in shared memory in two rounds (warps
// 2 and 3 hand theirs to warps 0 and 1, then warp 1 to warp 0; the partner
// is another warp, so the handover goes through shared memory rather than
// a shuffle), and warp 0 runs the inversion and the encoding, whole on
// every thread of each quad, in kernel G's eight-word field (its
// inversion chain measured shorter than the ten-limb field's in this
// launch shape, and the chain is most of E's time). No load address,
// branch, shuffle or shared memory slot depends on r; lanes past n redo
// the last signature so every warp stays whole.
//
// The table (64 windows x 16 entries x 3 field elements of 10 int32 limbs,
// 122,880 bytes) stays in global memory and is read through the read-only
// cache, where it fits the SM's L1 beside the 5 KB of shared memory a
// block uses. Copying it into shared memory would cost 120 KB a block and
// allow one block an SM: 16 signatures a block, 128 blocks, four SMs idle,
// and the copy on every block's critical path.
#include <cuda_runtime.h>

#include "ed25519_comb.cuh"

#define CT_COMB_BLOCK (32 * CT_COMB_SUMS)  // threads a block
#define CT_COMB_BLOCK_SIGS 8               // signatures a block: a warp's quads

__global__ void __launch_bounds__(CT_COMB_BLOCK)
ed25519_comb_kernel(const uint8_t* __restrict__ r, const int32_t* __restrict__ table,
                    uint8_t* __restrict__ out, int n) {
    // word i of thread t's coordinate at xch[i * CT_COMB_BLOCK + t]
    __shared__ int32_t xch[10 * CT_COMB_BLOCK];
    int s = threadIdx.x >> 5;  // this warp's partial sum
    int sig = blockIdx.x * CT_COMB_BLOCK_SIGS + ((threadIdx.x & 31) >> 2);
    int sg = sig < n ? sig : n - 1;
    ct_q10 acc;
    ct_comb_partial(acc, ct_comb_digits(r + (size_t)sg * 32, s), table, s);
    // round h: warps h..2h-1 hand their sums to warps 0..h-1 (a round's
    // writers and the previous round's readers use different slots, so
    // one barrier a round is enough)
#pragma unroll
    for (int h = CT_COMB_SUMS / 2; h >= 1; h >>= 1) {
        if (s >= h && s < 2 * h) {
#pragma unroll
            for (int i = 0; i < 10; i++) xch[i * CT_COMB_BLOCK + threadIdx.x] = acc.e[0].v[i];
        }
        __syncthreads();
        if (s < h) {
            ct_q10 other;
#pragma unroll
            for (int i = 0; i < 10; i++)
                other.e[0].v[i] = xch[i * CT_COMB_BLOCK + threadIdx.x + 32 * h];
            ct_comb_combine(acc, other);
        }
    }
    if (s != 0) return;
    uint8_t enc[32];
    ct_comb_encode(enc, acc);
    if (sig < n && (threadIdx.x & 3) == 0) {
#pragma unroll
        for (int i = 0; i < 32; i++) out[(size_t)sig * 32 + i] = enc[i];
    }
}

// r: (n, 32) uint8 little-endian scalars; table: (3072, 10) int32, 8-byte
// aligned; out: (n, 32) uint8 encodings of [r]B. Launches on `stream`,
// returns the cudaError_t of the launch.
extern "C" int ct_ed25519_comb(const void* r, const void* table, void* out, int n,
                               void* stream) {
    dim3 grid((unsigned)((n + CT_COMB_BLOCK_SIGS - 1) / CT_COMB_BLOCK_SIGS));
    ed25519_comb_kernel<<<grid, CT_COMB_BLOCK, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)r, (const int32_t*)table, (uint8_t*)out, n);
    return (int)cudaGetLastError();
}
