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
// What bounds them on this card: 32-bit integer operations, about 1,384 a
// block (64 rounds of 14, 48 schedule words of 10, the final 8 adds)
// against 64 bytes read a block, so well above the card's ratio of
// operations to bytes. The TPU pads the batch to a power of two and the
// block count to the longest message so XLA compiles one shape; here C
// takes one ragged launch instead: every message's padded blocks laid end
// to end, with a block offset and count per message.
//
// C's time is set by its longest message: a lane's blocks are one serial
// chain, and one warp's integer instructions issue at one every two cycles
// on its scheduler. So C splits each compression across two warps on two
// schedulers (warp w runs on sub-partition w mod 4). A warp pair serves 32
// messages at a time: its producer warp stages each message's next blocks
// into shared memory with cp.async two blocks ahead and expands the
// schedule into W[t] + K[t], a block ahead, into one of two shared slots;
// its consumer warp runs only the 64 rounds and the final adds (904 of
// the 1,384 operations), reading the sums with 16-byte shared loads. Named
// barriers hand each slot over (FULL: producer to consumer; EMPTY: back).
// A warp runs as many blocks as its longest message, so the messages take
// a lane order, longest first, and each warp's 32 are nearly equal; each
// digest is written through the order, so `out` stays in message order.
// Each block takes a contiguous range of the messages (ct_c_range) and
// orders them itself, a chunk of CT_C_CHUNK at a time, one message a
// thread: a message's place is its rank by block count in the chunk, ties
// in message order (ct_c_rank). A block holds two pairs, one warp a
// scheduler, and the launch at most one block an SM; a chunk's groups of
// 32 go to the pairs back and forth (ct_c_slot), so the longest group gets
// a pair to itself and the shortest rides with the second longest. A
// window's long leaves recur every few messages, so every range holds its
// share of them. The leaves are public data, so trip counts and lane order
// may depend on them.
//
// D runs one thread per pair.
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

// The producer's copy of one message's block into a staging slot, chunk j
// of lane l at slot[j][l] (conflict-free 16-byte accesses), or nothing
// past the message's last block.
__device__ __forceinline__ void ct_c_stage(uint4 (*slot)[32], int lane, const uint8_t* blk,
                                           bool live) {
    if (live) {
#pragma unroll
        for (int j = 0; j < 4; j++) ct_cp_async16(&slot[j][lane], blk + 16 * j);
    }
    ct_cp_async_commit();
}

// Slot i (0, 1, ...) of worker q of Q: q, 2Q - 1 - q, 2Q + q, 4Q - 1 - q,
// ... Slots come longest first, so the first Q go one a worker and the
// rest back and forth: a worker with a long slot gets few others.
__device__ __forceinline__ int ct_c_slot(int i, int q, int workers) {
    return (i & 1) ? (i + 1) * workers - 1 - q : i * workers + q;
}

// A slot's message for this lane (from the chunk's order `msgs`, whose
// first message is c0 and block counts `cnts`), its block count (and its
// block offset, where `offsets` is given), and the warp's longest count
// (the blocks both warps of the pair run for the slot).
__device__ __forceinline__ int ct_c_lane(const int* msgs, const int* cnts, int c0,
                                         const int32_t* offsets, int slot, int lane, int m,
                                         int* msg, int* cnt, int* off) {
    int j = 32 * slot + lane;
    *msg = j < m ? msgs[j] : 0;
    *cnt = j < m ? cnts[*msg - c0] : 0;
    if (offsets) *off = j < m ? __ldg(offsets + *msg) : 0;
    return __reduce_max_sync(0xffffffffu, *cnt);
}

__global__ void __launch_bounds__(64 * CT_C_PAIRS)
sha256_leaves_kernel(const uint8_t* __restrict__ blocks,
                     const int32_t* __restrict__ offsets,
                     const int32_t* __restrict__ counts,
                     uint32_t* __restrict__ out, int n) {
    // per pair: a block of each lane and W + K of each lane, two slots each
    __shared__ __align__(16) uint4 stage[CT_C_PAIRS][2][4][32];
    __shared__ __align__(16) uint4 wk[CT_C_PAIRS][2][16][32];
    // the chunk's block counts in message order, and its messages in lane order
    __shared__ int cnts[CT_C_CHUNK], msgs[CT_C_CHUNK];
    const int pair = threadIdx.x >> 6, lane = threadIdx.x & 31, tid = threadIdx.x;
    const int full = 1 + 4 * pair, empty = 3 + 4 * pair;  // FULL / EMPTY ids of slot s: + s
    int lo, hi;
    ct_c_range(n, gridDim.x, blockIdx.x, &lo, &hi);
    for (int c0 = lo; c0 < hi; c0 += CT_C_CHUNK) {
        const int m = min(CT_C_CHUNK, hi - c0), slots = (m + 31) / 32;
        __syncthreads();  // every warp is done with the last chunk
        if (tid < m) cnts[tid] = __ldg(counts + c0 + tid);
        __syncthreads();
        if (tid < m) msgs[ct_c_rank(cnts, m, tid)] = c0 + tid;
        __syncthreads();
        int kk = 0;  // the pair's blocks so far in the chunk: block kk's shared slot is kk & 1
        int msg, cnt, off;
        if (!(threadIdx.x & 32)) {
            for (int i = 0, j; (j = ct_c_slot(i, pair, CT_C_PAIRS)) < slots; i++) {
                const int nmax =
                    ct_c_lane(msgs, cnts, c0, offsets, j, lane, m, &msg, &cnt, &off);
                const uint8_t* src = blocks + (size_t)off * 64;
                ct_c_stage(stage[pair][kk & 1], lane, src, cnt > 0);
                ct_c_stage(stage[pair][(kk + 1) & 1], lane, src + 64, cnt > 1);
#pragma unroll 1
                for (int k = 0; k < nmax; k++, kk++) {
                    const int s = kk & 1;
                    ct_cp_async_wait<1>();  // this lane's block k has landed
                    uint32_t w[16];
#pragma unroll
                    for (int c = 0; c < 4; c++) {
                        uint4 v = stage[pair][s][c][lane];
                        w[4 * c + 0] = __byte_perm(v.x, 0, 0x0123);
                        w[4 * c + 1] = __byte_perm(v.y, 0, 0x0123);
                        w[4 * c + 2] = __byte_perm(v.z, 0, 0x0123);
                        w[4 * c + 3] = __byte_perm(v.w, 0, 0x0123);
                    }
                    if (kk >= 2) ct_bar_sync(empty + s, 64);  // the consumer is done with kk-2
#pragma unroll
                    for (int c = 0; c < 4; c++) {
                        uint32_t t[16];
                        ct_sha256_wk_chunk(t, w, c);
#pragma unroll
                        for (int i4 = 0; i4 < 4; i4++)
                            wk[pair][s][4 * c + i4][lane] = make_uint4(
                                t[4 * i4], t[4 * i4 + 1], t[4 * i4 + 2], t[4 * i4 + 3]);
                    }
                    // the staged words are consumed: refill the slot with block k + 2
                    ct_c_stage(stage[pair][s], lane, src + 64 * (k + 2), k + 2 < cnt);
                    ct_bar_arrive(full + s, 64);
                }
            }
            ct_cp_async_wait<0>();
        } else {
            // the blocks this pair runs in all, so the consumer knows its last
            // EMPTY release
            int total = 0;
            for (int i = 0, j; (j = ct_c_slot(i, pair, CT_C_PAIRS)) < slots; i++)
                total += ct_c_lane(msgs, cnts, c0, nullptr, j, lane, m, &msg, &cnt, &off);
            const uint32_t iv[8] = CT_SHA256_IV_INIT;
            for (int i = 0, j; (j = ct_c_slot(i, pair, CT_C_PAIRS)) < slots; i++) {
                const int nmax =
                    ct_c_lane(msgs, cnts, c0, nullptr, j, lane, m, &msg, &cnt, &off);
                uint32_t st[8];
#pragma unroll
                for (int r = 0; r < 8; r++) st[r] = iv[r];
#pragma unroll 1
                for (int k = 0; k < nmax; k++, kk++) {
                    const int s = kk & 1;
                    ct_bar_sync(full + s, 64);
                    uint32_t v[8];
#pragma unroll
                    for (int r = 0; r < 8; r++) v[r] = st[r];
#pragma unroll
                    for (int c = 0; c < 4; c++) {
                        uint32_t t[16];
#pragma unroll
                        for (int i4 = 0; i4 < 4; i4++) {
                            uint4 x = wk[pair][s][4 * c + i4][lane];
                            t[4 * i4] = x.x;
                            t[4 * i4 + 1] = x.y;
                            t[4 * i4 + 2] = x.z;
                            t[4 * i4 + 3] = x.w;
                        }
                        ct_sha256_rounds_chunk(v, t);
                    }
                    if (kk + 2 < total) ct_bar_arrive(empty + s, 64);
                    if (k < cnt) {
#pragma unroll
                        for (int r = 0; r < 8; r++) st[r] += v[r];
                    }
                }
                if (32 * j + lane < m) {
                    uint4* o = reinterpret_cast<uint4*>(out + (size_t)msg * 8);
                    o[0] = make_uint4(st[0], st[1], st[2], st[3]);
                    o[1] = make_uint4(st[4], st[5], st[6], st[7]);
                }
            }
        }
    }
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

// blocks: padded messages end to end (uint8, 16-byte aligned); offsets,
// counts: (n,) int32 block offset and block count of each message; out:
// (n, 8) words, in message order. Launches on `stream`, returns the
// cudaError_t of the launch.
extern "C" int ct_sha256_leaves(const void* blocks, const void* offsets,
                                const void* counts, void* out, int n, void* stream) {
    int dev, sms;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    sha256_leaves_kernel<<<ct_c_grid(n, sms), 64 * CT_C_PAIRS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)blocks, (const int32_t*)offsets, (const int32_t*)counts,
        (uint32_t*)out, n);
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
