// Kernel A: ed25519_challenge.
//
// Replaces the XLA prologue of corda_tpu/ops/ed25519.py::_tpu_verify_fixedlen
// (:355-362): sha512.py::sha512_blocks over one block, then
// scalar25519.py::challenge_windows (Barrett mod L, 4-bit windows).
//
// What bounds it on this card: integer instructions (each 64-bit rotate or
// add is two 32-bit instructions; 4,240 a lane) against 384 bytes moved a
// lane. A lane is one serial chain, so at small batches its time is that
// chain on one scheduler, and at a full bucket of 8,192 rows it is the
// chain again as long as each warp has a scheduler of its own.
//
// The design splits the chain across two warps and stages the rows
// through shared memory. A block of 128 threads serves 64 rows as two
// warp pairs of 32 rows:
// - all four warps copy the block's rows, one contiguous span of 64 x 161
//   = 10,304 bytes (a multiple of 16, so every block's span is 16-byte
//   aligned where the plane is), with 16-byte cp.async copies, and meet at
//   one __syncthreads; the last block copies only its rows' bytes;
// - a pair's schedule warp (warps 0 and 2) builds each row's 16 big-endian
//   words from aligned 4-byte shared loads (one __byte_perm a word,
//   conflict-free; sha512_modl.cuh's ct_sha512_row_words) and expands
//   W[t] + K[t] in five chunks of 16 into the pair's shared buffer,
//   releasing each chunk with a named barrier (bar.arrive);
// - the pair's rounds warp (warps 1 and 3) waits for each chunk
//   (bar.sync), runs its 16 rounds from 16-byte shared loads, then the
//   final adds, the Barrett reduction and the 64 windows.
// Warp w runs on sub-partition w mod 4, so each of the block's warps has
// a scheduler of its own. The rounds warp loops over the five chunks with
// one copy of a chunk's 16 rounds (it needs no round constants): unrolled
// whole, the block is some 5,000 instructions that every SM fetches to run
// each once a warp, and a full bucket took 1.6 us longer on the H100. The
// schedule warp stays unrolled with its round constants as immediates:
// read from the constant bank, they made one warp's launch about 1 us
// longer. A full bucket of 8,192 rows is 128 blocks, at
// most one an SM of 132; a small bucket spreads one pair of warps a 32
// rows. The windows go out as (64, B) int32, so that neighbouring threads
// write, and kernel B reads, neighbouring addresses.
#include <cuda_runtime.h>

#include "sha512_modl.cuh"

#define CT_A_PAIRS (CT_A_ROWS / 32)   // warp pairs a block
#define CT_A_SPAN (CT_A_ROWS * CT_PACKED_ROW)
#define CT_A_WK_SLOTS 40              // W + K of 80 words, two a 16-byte slot
// dynamic shared memory a block: the span, then each pair's W + K
#define CT_A_SMEM (CT_A_SPAN + CT_A_PAIRS * CT_A_WK_SLOTS * 32 * 16)

__global__ void __launch_bounds__(32 * 2 * CT_A_PAIRS)
ed25519_challenge_kernel(const uint8_t* __restrict__ packed,
                         int32_t* __restrict__ win, int n) {
    extern __shared__ __align__(16) uint4 smem[];
    uint32_t* span = reinterpret_cast<uint32_t*>(smem);
    const int row0 = blockIdx.x * CT_A_ROWS;
    const int rows = min(CT_A_ROWS, n - row0);
    // the rows' span in 16-byte chunks; the last block's final chunk
    // copies only the plane's bytes and zero-fills the rest
    const uint8_t* src = packed + (size_t)row0 * CT_PACKED_ROW;
    const int bytes = rows * CT_PACKED_ROW, chunks = (bytes + 15) >> 4;
    for (int i = threadIdx.x; i < chunks; i += blockDim.x)
        ct_cp_async16_part(smem + i, src + 16 * i, min(16, bytes - 16 * i));
    ct_cp_async_commit();
    ct_cp_async_wait<0>();
    __syncthreads();
    const int pair = threadIdx.x >> 6, lane = threadIdx.x & 31;
    const int r = 32 * pair + lane;  // this thread's row in the block
    if (32 * pair >= rows) return;   // both warps of an empty pair
    ulonglong2(*wk)[32] =
        reinterpret_cast<ulonglong2(*)[32]>(smem + CT_A_SPAN / 16) + CT_A_WK_SLOTS * pair;
    const int bar = 1 + 5 * pair;  // the pair's five chunk barriers
    if (!(threadIdx.x & 32)) {
        const uint64_t K[80] = CT_SHA512_K_INIT;
        uint64_t w[16];
        ct_sha512_row_words(w, span, r);
#pragma unroll
        for (int c = 0; c < 5; c++) {
            uint64_t t[16];
            ct_sha512_wk_chunk(t, w, c, K);
#pragma unroll
            for (int j = 0; j < 8; j++) wk[8 * c + j][lane] = make_ulonglong2(t[2 * j], t[2 * j + 1]);
            ct_bar_arrive(bar + c, 64);
        }
    } else {
        const uint64_t IV[8] = CT_SHA512_IV_INIT;
        uint64_t v[8];
#pragma unroll
        for (int i = 0; i < 8; i++) v[i] = IV[i];
#pragma unroll 1
        for (int c = 0; c < 5; c++) {
            ct_bar_sync(bar + c, 64);
            uint64_t t[16];
#pragma unroll
            for (int j = 0; j < 8; j++) {
                ulonglong2 q = wk[8 * c + j][lane];
                t[2 * j] = q.x;
                t[2 * j + 1] = q.y;
            }
            ct_sha512_rounds_chunk(v, t);
        }
#pragma unroll
        for (int i = 0; i < 8; i++) v[i] += IV[i];
        if (r < rows) ct_challenge_windows(v, win + row0 + r, n);
    }
}

// packed: (n, 161) uint8, 16-byte aligned; win: (64, n) int32. Launches on
// `stream`, returns the cudaError_t of the launch.
extern "C" int ct_ed25519_challenge(const void* packed, void* win, int n,
                                    void* stream) {
    cudaError_t err = cudaFuncSetAttribute((const void*)ed25519_challenge_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           CT_A_SMEM);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((n + CT_A_ROWS - 1) / CT_A_ROWS);
    ed25519_challenge_kernel<<<grid, 32 * 2 * CT_A_PAIRS, CT_A_SMEM, (cudaStream_t)stream>>>(
        (const uint8_t*)packed, (int32_t*)win, n);
    return (int)cudaGetLastError();
}

// Dynamic shared memory of one block, as the launch sets it.
extern "C" int ct_ed25519_challenge_smem_bytes() { return CT_A_SMEM; }

extern "C" const char* ct_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
