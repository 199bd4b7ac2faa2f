// Kernels C and D: the SHA-256 of the Merkle-id sweep.
//
// Kernel C, sha256_leaves, replaces corda_tpu/ops/sha256.py::sha256_blocks
// (:117, with _compress :105) as called by sha256_batch_words (:255) for
// the component leaves of ops/txid.py::_tx_id_roots_device (:152). Kernel D,
// sha256_pair_level, replaces one sha256_pair (:142) over the gathers of
// ops/txid.py::_merkle_levels (:78-81): one launch per Merkle level.
//
// One thread per message (C) or per pair (D). What bounds them on this
// card: 32-bit integer operations, about 1,384 a block (64 rounds of 14, 48
// schedule words of 10, the final 8 adds) against 64 bytes read a block, so
// well above the card's ratio of operations to bytes; each lane's blocks
// are one dependent chain. The TPU pads the batch to a power of two and the
// block count to the longest message so XLA compiles one shape; here C
// takes one ragged launch instead: every message's padded blocks laid end
// to end, with a block offset and count per lane. D keeps the reference's
// device-resident pool: it reads both children from the pool by index and
// writes the parents into the pool's next rows, so the levels chain on the
// card without a readback.
#include <cuda_runtime.h>

#include "sha256.cuh"

__global__ void __launch_bounds__(128)
sha256_leaves_kernel(const uint8_t* __restrict__ blocks,
                     const int32_t* __restrict__ offsets,
                     const int32_t* __restrict__ counts,
                     uint32_t* __restrict__ out, int n) {
    int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    uint32_t d[8];
    ct_sha256_blocks(d, blocks + (size_t)offsets[lane] * 64, counts[lane]);
    uint4* o = reinterpret_cast<uint4*>(out + (size_t)lane * 8);
    o[0] = make_uint4(d[0], d[1], d[2], d[3]);
    o[1] = make_uint4(d[4], d[5], d[6], d[7]);
}

// pool rows below `base` are read, rows base..base+m-1 written: the two
// ranges never overlap, so the pool is not __restrict__ but is race-free.
__global__ void __launch_bounds__(128)
sha256_pair_level_kernel(uint32_t* pool, const int32_t* __restrict__ left,
                         const int32_t* __restrict__ right, int base, int m) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= m) return;
    const uint4* l = reinterpret_cast<const uint4*>(pool + (size_t)left[i] * 8);
    const uint4* r = reinterpret_cast<const uint4*>(pool + (size_t)right[i] * 8);
    uint4 l0 = l[0], l1 = l[1], r0 = r[0], r1 = r[1];
    uint32_t lw[8] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
    uint32_t rw[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
    uint32_t d[8];
    ct_sha256_pair(d, lw, rw);
    uint4* o = reinterpret_cast<uint4*>(pool + (size_t)(base + i) * 8);
    o[0] = make_uint4(d[0], d[1], d[2], d[3]);
    o[1] = make_uint4(d[4], d[5], d[6], d[7]);
}

// blocks: padded messages end to end (uint8); offsets, counts: (n,) int32
// block offset and block count of each message; out: (n, 8) words.
extern "C" int ct_sha256_leaves(const void* blocks, const void* offsets,
                                const void* counts, void* out, int n,
                                void* stream) {
    dim3 grid((n + 127) / 128);
    sha256_leaves_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)blocks, (const int32_t*)offsets,
        (const int32_t*)counts, (uint32_t*)out, n);
    return (int)cudaGetLastError();
}

// pool: (rows, 8) words; left, right: (m,) int32 row indices below base;
// the m digests go to pool rows base..base+m-1.
extern "C" int ct_sha256_pair_level(void* pool, const void* left,
                                    const void* right, int base, int m,
                                    void* stream) {
    dim3 grid((m + 127) / 128);
    sha256_pair_level_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
        (uint32_t*)pool, (const int32_t*)left, (const int32_t*)right, base, m);
    return (int)cudaGetLastError();
}
