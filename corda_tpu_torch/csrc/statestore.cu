// Kernels I, J and K: the device state store's probe, commit and remove.
//
// They replace the three shard_map steps of corda_tpu/statestore/table.py:
// I, statestore_probe, replaces _probe_step (:190); J, statestore_commit,
// _commit_step (:225), the fused conflict check and insert; K,
// statestore_remove, _remove_step (:317). The table is one open-addressing
// table of S slots in device memory (statestore.cuh has its layout and
// arithmetic), one shard on one card: n_shards is 1, and the owner test is
// kept as the reference has it.
//
// What bounds them on this card: bytes. A probe reads a window of
// max_probe tags (4 bytes each) and the 32-byte key of each live slot in
// it, a few hundred bytes a row against a handful of integer operations.
// I and J's first phase give each row a warp, lane j testing window slot
// j, 32 slots a step, and a ballot answers: one 128-byte read of tags and
// the keys of the live slots, every row in parallel.
//
// J's second phase and K are walks in row order: a row takes the first free
// slot of its window (J) or tombstones the first live slot holding its key
// (K) in the table as the rows before it left it, so a row waits for the
// writes of the rows before it whose windows overlap its own. One warp
// walks the rows: lanes test 32 window slots, a ballot picks the first, and
// the warp's own writes are ordered by __syncwarp before the next row
// reads. That keeps the reference's slot layout and its overflow masks
// exactly (a parallel insert with atomics would move rows between slots and
// change which rows overflow in a crowded window), and costs one dependent
// round trip to device memory a row: the walk's serial floor. The walk's
// warp reads its rows' flags 32 rows at a time and skips the rows with
// nothing to do. J's launches share the stream, so the second sees the
// first's flags; the wrapper reads the result back once.
#include <cuda_runtime.h>

#include "statestore.cuh"

#define CT_SS_FULL 0xffffffffu
#define CT_SS_WARPS 8   // warps a block of I and J's first phase

// One warp's test of q's window: the ballot of live slots that hold q, 32
// slots from window slot c on.
__device__ __forceinline__ unsigned ct_ss_hits(const int32_t* keys, const int32_t* tags,
                                               uint32_t home, uint32_t slots, int max_probe,
                                               int c, const int32_t* q, int lane,
                                               uint32_t* slot) {
    bool hit = false;
    *slot = 0;
    if (c + lane < max_probe) {
        *slot = ct_ss_window_slot(home, (uint32_t)(c + lane), slots);
        hit = ct_ss_live_match(keys, tags, *slot, q);
    }
    return __ballot_sync(CT_SS_FULL, hit);
}

// Kernel I: found[i] = 1 when q[i] is a live key of the table.
__global__ void __launch_bounds__(32 * CT_SS_WARPS)
    statestore_probe_kernel(const int32_t* keys, const int32_t* tags, uint32_t slots,
                            int max_probe, uint32_t n_shards, uint32_t shard, const int32_t* q,
                            int n, int32_t* found) {
    int i = blockIdx.x * CT_SS_WARPS + (threadIdx.x >> 5);
    int lane = threadIdx.x & 31;
    if (i >= n) return;
    const int32_t* qi = q + 8 * (size_t)i;
    int any = 0;
    if (ct_ss_owner(qi, n_shards) == shard) {
        uint32_t home = ct_ss_home(qi, slots), slot;
        for (int c = 0; c < max_probe && !any; c += 32)
            any = ct_ss_hits(keys, tags, home, slots, max_probe, c, qi, lane, &slot) != 0;
    }
    if (lane == 0) found[i] = any;
}

// Kernel J, phase 1: for each of the r*k rows, present (a live slot holds
// its key) and conflict (such a slot's payload differs from its request's
// tx), over the whole window; rows that are not valid are neither.
__global__ void __launch_bounds__(32 * CT_SS_WARPS)
    statestore_commit_check_kernel(const int32_t* keys, const int32_t* txs, const int32_t* tags,
                                   uint32_t slots, int max_probe, uint32_t n_shards,
                                   uint32_t shard, const int32_t* q, const int32_t* qtx,
                                   const int32_t* valid, int rk, int k, int32_t* present,
                                   int32_t* conf_row) {
    int i = blockIdx.x * CT_SS_WARPS + (threadIdx.x >> 5);
    int lane = threadIdx.x & 31;
    if (i >= rk) return;
    const int32_t* qi = q + 8 * (size_t)i;
    const int32_t* tx = qtx + 8 * (size_t)(i / k);
    int pres = 0, conf = 0;
    if (valid[i] != 0 && ct_ss_owner(qi, n_shards) == shard) {
        uint32_t home = ct_ss_home(qi, slots), slot;
        for (int c = 0; c < max_probe; c += 32) {
            unsigned hits = ct_ss_hits(keys, tags, home, slots, max_probe, c, qi, lane, &slot);
            bool differs = ((hits >> lane) & 1) && !ct_ss_row_eq(txs + 8 * (size_t)slot, tx);
            pres |= hits != 0;
            conf |= __ballot_sync(CT_SS_FULL, differs) != 0;
        }
    }
    if (lane == 0) {
        present[i] = pres;
        conf_row[i] = conf;
    }
}

// Kernel J, phase 2, one block: each request's verdict (in parallel), then
// one warp inserts, in row order, every valid row of a request that passed
// whose key was not present: into the first free slot of its window, or it
// overflows. out: conflict (r,), overflow (r*k,), then the insert count.
__global__ void __launch_bounds__(1024)
    statestore_commit_insert_kernel(int32_t* keys, int32_t* txs, int32_t* tags, uint32_t slots,
                                    int max_probe, uint32_t n_shards, uint32_t shard,
                                    const int32_t* q, const int32_t* qtx, const int32_t* qtag,
                                    const int32_t* valid, const int32_t* pre_conflict,
                                    const int32_t* force, int r, int k, const int32_t* present,
                                    const int32_t* conf_row, int32_t* out) {
    int rk = r * k;
    int32_t* conflict = out;
    int32_t* overflow = out + r;
    for (int t = threadIdx.x; t < r; t += blockDim.x)
        conflict[t] = ct_ss_request_conflict(conf_row + (size_t)t * k, k, pre_conflict[t],
                                             force[t]);
    __syncthreads();
    if (threadIdx.x >= 32) return;
    int lane = threadIdx.x;
    int inserted = 0;
    for (int i0 = 0; i0 < rk; i0 += 32) {
        int i = i0 + lane;
        bool todo = false;
        uint32_t my_home = 0;
        if (i < rk) {
            const int32_t* qi = q + 8 * (size_t)i;
            todo = valid[i] != 0 && ct_ss_owner(qi, n_shards) == shard &&
                   conflict[i / k] == 0 && present[i] == 0;
            if (todo) my_home = ct_ss_home(qi, slots);
            else overflow[i] = 0;
        }
        unsigned rows = __ballot_sync(CT_SS_FULL, todo);
        while (rows) {
            int t = __ffs(rows) - 1;
            int row = i0 + t;
            rows &= rows - 1;
            const int32_t* qr = q + 8 * (size_t)row;
            uint32_t home = __shfl_sync(CT_SS_FULL, my_home, t);
            int64_t slot = -1;
            for (int c = 0; c < max_probe && slot < 0; c += 32) {
                bool fr = c + lane < max_probe &&
                          ct_ss_free(tags, ct_ss_window_slot(home, (uint32_t)(c + lane), slots));
                unsigned free_lanes = __ballot_sync(CT_SS_FULL, fr);
                if (free_lanes)
                    slot = ct_ss_window_slot(home, (uint32_t)(c + __ffs(free_lanes) - 1), slots);
            }
            if (slot >= 0) {
                // lanes 0-7 the key, 8-15 the payload, 16 the tag
                size_t s = (size_t)slot;
                if (lane < 8) keys[8 * s + lane] = qr[lane];
                else if (lane < 16) txs[8 * s + lane - 8] = qtx[8 * (size_t)(row / k) + lane - 8];
                else if (lane == 16) tags[s] = qtag[row] | 1;
                inserted++;
            }
            if (lane == 0) overflow[row] = slot < 0;
            __syncwarp();
        }
    }
    if (lane == 0) out[r + rk] = inserted;
}

// Kernel K, one warp: in row order, each valid row's first live slot that
// holds its key becomes a tombstone (zero key and payload, tag 2). out:
// removed (n,), then the count removed.
__global__ void __launch_bounds__(32)
    statestore_remove_kernel(int32_t* keys, int32_t* txs, int32_t* tags, uint32_t slots,
                             int max_probe, uint32_t n_shards, uint32_t shard, const int32_t* q,
                             const int32_t* valid, int n, int32_t* out) {
    int lane = threadIdx.x;
    int removed = 0;
    for (int i0 = 0; i0 < n; i0 += 32) {
        int i = i0 + lane;
        bool todo = false;
        uint32_t my_home = 0;
        if (i < n) {
            const int32_t* qi = q + 8 * (size_t)i;
            todo = valid[i] != 0 && ct_ss_owner(qi, n_shards) == shard;
            if (todo) my_home = ct_ss_home(qi, slots);
            else out[i] = 0;
        }
        unsigned rows = __ballot_sync(CT_SS_FULL, todo);
        while (rows) {
            int t = __ffs(rows) - 1;
            int row = i0 + t;
            rows &= rows - 1;
            const int32_t* qr = q + 8 * (size_t)row;
            uint32_t home = __shfl_sync(CT_SS_FULL, my_home, t), slot;
            int64_t at = -1;
            for (int c = 0; c < max_probe && at < 0; c += 32) {
                unsigned hits = ct_ss_hits(keys, tags, home, slots, max_probe, c, qr, lane, &slot);
                if (hits)
                    at = ct_ss_window_slot(home, (uint32_t)(c + __ffs(hits) - 1), slots);
            }
            if (at >= 0) {
                size_t s = (size_t)at;
                if (lane < 8) keys[8 * s + lane] = 0;
                else if (lane < 16) txs[8 * s + lane - 8] = 0;
                else if (lane == 16) tags[s] = CT_SS_TOMBSTONE;
                removed++;
            }
            if (lane == 0) out[row] = at >= 0;
            __syncwarp();
        }
    }
    if (lane == 0) out[n] = removed;
}

// Not a port of a TPU kernel: a measurement probe for the walks' serial
// floor. One thread follows `hops` links of `next` (a cycle through an
// array as large as a table's tags) from index 0, each load's address the
// last load's value, and writes where it ended: the time of one dependent
// round trip to device memory is the launch's time over `hops`.
__global__ void statestore_chase_kernel(const int32_t* next, int hops, int32_t* out) {
    int32_t at = 0;
    for (int h = 0; h < hops; h++) at = __ldcg(next + at);
    *out = at;
}

// keys (slots, 8), tags (slots,), q (n, 8) int32, 16-byte aligned; found
// (n,) int32. Launches on `stream`, returns the cudaError_t of the launch.
extern "C" int ct_statestore_probe(const void* keys, const void* tags, int slots, int max_probe,
                                   int n_shards, int shard, const void* q, int n, void* found,
                                   void* stream) {
    if (n <= 0) return 0;
    statestore_probe_kernel<<<(n + CT_SS_WARPS - 1) / CT_SS_WARPS, 32 * CT_SS_WARPS, 0,
                              (cudaStream_t)stream>>>(
        (const int32_t*)keys, (const int32_t*)tags, (uint32_t)slots, max_probe,
        (uint32_t)n_shards, (uint32_t)shard, (const int32_t*)q, n, (int32_t*)found);
    return (int)cudaGetLastError();
}

// keys, txs (slots, 8), tags (slots,): the table, updated in place; q
// (r*k, 8), qtx (r, 8), qtag, valid (r*k,), pre_conflict, force (r,)
// int32, 16-byte aligned; scratch (2*r*k,) int32; out (r + r*k + 1,)
// int32: conflict, overflow, insert count. Launches both phases on
// `stream`, returns the cudaError_t of the launches.
extern "C" int ct_statestore_commit(void* keys, void* txs, void* tags, int slots, int max_probe,
                                    int n_shards, int shard, const void* q, const void* qtx,
                                    const void* qtag, const void* valid,
                                    const void* pre_conflict, const void* force, int r, int k,
                                    void* scratch, void* out, void* stream) {
    int rk = r * k;
    if (r <= 0) return 0;
    int32_t* present = (int32_t*)scratch;
    int32_t* conf_row = present + rk;
    cudaStream_t st = (cudaStream_t)stream;
    if (rk > 0) {
        statestore_commit_check_kernel<<<(rk + CT_SS_WARPS - 1) / CT_SS_WARPS,
                                         32 * CT_SS_WARPS, 0, st>>>(
            (const int32_t*)keys, (const int32_t*)txs, (const int32_t*)tags, (uint32_t)slots,
            max_probe, (uint32_t)n_shards, (uint32_t)shard, (const int32_t*)q,
            (const int32_t*)qtx, (const int32_t*)valid, rk, k, present, conf_row);
        cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    statestore_commit_insert_kernel<<<1, 1024, 0, st>>>(
        (int32_t*)keys, (int32_t*)txs, (int32_t*)tags, (uint32_t)slots, max_probe,
        (uint32_t)n_shards, (uint32_t)shard, (const int32_t*)q, (const int32_t*)qtx,
        (const int32_t*)qtag, (const int32_t*)valid, (const int32_t*)pre_conflict,
        (const int32_t*)force, r, k, present, conf_row, (int32_t*)out);
    return (int)cudaGetLastError();
}

// keys, txs (slots, 8), tags (slots,): the table, updated in place; q (n,
// 8), valid (n,) int32, 16-byte aligned; out (n + 1,) int32: removed, then
// the count. Launches on `stream`, returns the cudaError_t of the launch.
extern "C" int ct_statestore_remove(void* keys, void* txs, void* tags, int slots, int max_probe,
                                    int n_shards, int shard, const void* q, const void* valid,
                                    int n, void* out, void* stream) {
    if (n <= 0) return 0;
    statestore_remove_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
        (int32_t*)keys, (int32_t*)txs, (int32_t*)tags, (uint32_t)slots, max_probe,
        (uint32_t)n_shards, (uint32_t)shard, (const int32_t*)q, (const int32_t*)valid, n,
        (int32_t*)out);
    return (int)cudaGetLastError();
}

// next: (m,) int32 links; out: one int32. Launches one thread on `stream`.
extern "C" int ct_statestore_chase(const void* next, int hops, void* out, void* stream) {
    statestore_chase_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((const int32_t*)next, hops,
                                                               (int32_t*)out);
    return (int)cudaGetLastError();
}
