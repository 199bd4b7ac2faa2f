// Kernels C and D: the SHA-256 of the Merkle-id sweep.
//
// Kernel C, sha256_leaves, replaces corda_tpu/ops/sha256.py::sha256_blocks
// (:117, with _compress :105) as called by sha256_batch_words (:255) for
// the component leaves of ops/txid.py::_tx_id_roots_device (:152). Kernel D,
// sha256_merkle_sweep, replaces the sha256_pair (:142) of every level of
// ops/txid.py::_merkle_levels (:46, the gathers :78-81): the reference runs
// a whole id sweep as one jitted device program, and D runs every level of
// a sweep in one launch.
//
// One thread per message (C) or per pair (D). What bounds them on this
// card: 32-bit integer operations, about 1,384 a block (64 rounds of 14, 48
// schedule words of 10, the final 8 adds) against 64 bytes read a block, so
// well above the card's ratio of operations to bytes; each lane's blocks
// are one dependent chain. The TPU pads the batch to a power of two and the
// block count to the longest message so XLA compiles one shape; here C
// takes one ragged launch instead: every message's padded blocks laid end
// to end, with a block offset and count per lane.
//
// D keeps the reference's device-resident pool: it reads both children
// from the pool by index and writes the parents into the pool's next rows.
// A sweep's levels are short (a notary window's widest is a few thousand
// pairs, its last a few hundred), so one launch a level cost more in
// launches, and in the card's waits for the host between levels, than in
// hashing. D is one cooperative launch for the whole sweep: the grid (as
// many blocks as the widest level needs, at most what the card holds at
// once) strides over each level's pairs, and a grid-wide barrier
// (cooperative_groups::this_grid().sync()) separates the levels. The level
// plan travels in the launch's parameters: each level's first parent row,
// pair count and the device addresses of its left and right child indices
// (slices of the one index upload the caller makes).
#include <cooperative_groups.h>
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

#define CT_SWEEP_MAX_LEVELS 64

// A sweep's levels, in order: level l writes pool rows first[l] ..
// first[l] + count[l] - 1 from the children left[l][i], right[l][i].
struct ct_sweep_plan {
    const int32_t* left[CT_SWEEP_MAX_LEVELS];
    const int32_t* right[CT_SWEEP_MAX_LEVELS];
    int first[CT_SWEEP_MAX_LEVELS];
    int count[CT_SWEEP_MAX_LEVELS];
    int levels;
};

// A level reads only rows below its first row, all written before it (by
// kernel C or an earlier level) and never rewritten, so the pool is not
// __restrict__ but is race-free. The children are read through L2 only
// (__ldcg): another block may have written them earlier in this launch, and
// this SM's L1 may hold a stale copy of their line.
__global__ void __launch_bounds__(128)
sha256_merkle_sweep_kernel(uint32_t* pool, const __grid_constant__ ct_sweep_plan plan) {
    cooperative_groups::grid_group grid = cooperative_groups::this_grid();
    int stride = (int)(gridDim.x * blockDim.x);
    for (int lv = 0; lv < plan.levels; lv++) {
        if (lv) grid.sync();
        const int32_t* left = plan.left[lv];
        const int32_t* right = plan.right[lv];
        int base = plan.first[lv], m = plan.count[lv];
        for (int i = (int)(blockIdx.x * blockDim.x + threadIdx.x); i < m; i += stride) {
            const uint4* l = reinterpret_cast<const uint4*>(pool + (size_t)__ldg(left + i) * 8);
            const uint4* r = reinterpret_cast<const uint4*>(pool + (size_t)__ldg(right + i) * 8);
            uint4 l0 = __ldcg(l), l1 = __ldcg(l + 1), r0 = __ldcg(r), r1 = __ldcg(r + 1);
            uint32_t lw[8] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
            uint32_t rw[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
            uint32_t d[8];
            ct_sha256_pair(d, lw, rw);
            uint4* o = reinterpret_cast<uint4*>(pool + (size_t)(base + i) * 8);
            o[0] = make_uint4(d[0], d[1], d[2], d[3]);
            o[1] = make_uint4(d[4], d[5], d[6], d[7]);
        }
    }
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

// pool: (rows, 8) words, 16-byte aligned; for each of `levels` levels (at
// most CT_SWEEP_MAX_LEVELS) the device addresses of its (count,) int32
// left and right row indices (host arrays `lefts`, `rights`), its first
// parent row and its pair count (host arrays `firsts`, `counts`). Launches
// on `stream`, returns the cudaError_t of the launch.
extern "C" int ct_sha256_merkle_sweep(void* pool, const int64_t* lefts, const int64_t* rights,
                                      const int32_t* firsts, const int32_t* counts, int levels,
                                      void* stream) {
    if (levels < 1 || levels > CT_SWEEP_MAX_LEVELS) return (int)cudaErrorInvalidValue;
    ct_sweep_plan plan;
    int widest = 1;
    for (int l = 0; l < levels; l++) {
        plan.left[l] = (const int32_t*)(intptr_t)lefts[l];
        plan.right[l] = (const int32_t*)(intptr_t)rights[l];
        plan.first[l] = firsts[l];
        plan.count[l] = counts[l];
        widest = counts[l] > widest ? counts[l] : widest;
    }
    plan.levels = levels;
    int dev, sms, per_sm;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sha256_merkle_sweep_kernel,
                                                            128, 0);
    if (err != cudaSuccess) return (int)err;
    int blocks = (widest + 127) / 128;
    if (blocks > per_sm * sms) blocks = per_sm * sms;
    void* args[] = {&pool, &plan};
    err = cudaLaunchCooperativeKernel((const void*)sha256_merkle_sweep_kernel, dim3(blocks),
                                      dim3(128), args, 0, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
