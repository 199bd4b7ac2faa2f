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
// J's second phase and K change the table in row order, as the reference's
// fori_loop does: a row takes the first free slot of its window (J) or
// tombstones the first live slot holding its key (K) in the table as the
// rows before it left it. The exactness rule: a row's result depends only
// on its window, and an earlier row writes only inside its own, so a row
// whose window overlaps no earlier row still to do sees the table as the
// serial order would show it, whatever else has run. Both run as one
// cooperative launch in rounds: each round marks every row left in its
// bucket (an atomicMin of the row index; statestore.cuh has the buckets
// and the test), then the rows free in the round, whose windows overlap no
// earlier row left and so no other free row, take their row step in
// parallel, a warp a row as in I. A free row's earlier overlapping rows
// were all done in earlier rounds, and a later one that overlaps it cannot
// be free before it. Equal keys have equal homes, so K's true dependency
// (a key named twice) is covered too. The marks alternate between two
// arrays, each cleared in the round after its own, so a round costs two
// grid barriers (this_grid().sync()). Once a round frees fewer than
// min_free rows, or after CT_SS_MAX_ROUNDS, one warp walks the rows left in
// row order, found by a bit a row that the last pass sets: lanes test 32
// window slots, a ballot picks the first, and __syncwarp orders the warp's
// writes before the next row reads. What bounds J's insert and K: the
// rounds' dependent round trips to device memory and grid barriers, and
// one round trip a walked row; at the tables' load few rows wait on an
// earlier one, so a batch takes a few rounds and walks few rows. Atomics
// on the slots themselves are still not used: rows racing for free slots
// would land in other slots than the serial order gives, and change which
// rows overflow in a crowded window. The launches of J share the stream,
// so the second sees the first's flags; the rounds and the walk read what
// other blocks wrote in the same launch through L2 only (__ldcg).
#include <cooperative_groups.h>
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

// One launch of J's insert or K: the table, the batch's rows and flags, the
// scratch and the outputs.
struct ct_ss_batch {
    int32_t* keys;
    int32_t* txs;
    int32_t* tags;
    uint32_t slots, n_shards, shard;
    int max_probe;
    const int32_t* q;
    const int32_t* qtx;           // J: one payload a request
    const int32_t* qtag;          // J
    const int32_t* valid;
    const int32_t* pre_conflict;  // J
    const int32_t* force;         // J
    const int32_t* present;       // J: phase 1's flags
    const int32_t* conf_row;      // J
    int r, k, n;                  // requests, rows a request, n = r * k (K: k = 1)
    int32_t* state;               // (n,) row states
    int32_t* marks;               // (2 * buckets,) CT_SS_UNMARKED
    int32_t* counts;              // (CT_SS_COUNTS,) zero
    int32_t* left_bits;           // (ceil(n / 32),) the rows the walk takes, a bit a row
    int min_free;
    int32_t* conflict;            // J: (r,) verdicts
    int32_t* flag;                // (n,) J's overflow, K's removed
    int32_t* total;               // the rows inserted or removed
};

// Adds the sum of every thread's v in this block to *dst: a block
// reduction, then one atomicAdd. Every thread of the block must call it.
__device__ __forceinline__ void ct_ss_block_add(int v, int32_t* dst) {
    __shared__ int part[CT_SS_WARPS];
    v = __reduce_add_sync(CT_SS_FULL, v);
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
    __syncthreads();
    if (threadIdx.x == 0) {
        int sum = 0;
        for (int w = 0; w < CT_SS_WARPS; w++) sum += part[w];
        if (sum) atomicAdd(dst, sum);
    }
    __syncthreads();
}

template <bool kCommit>
__device__ __forceinline__ bool ct_ss_todo(const ct_ss_batch& b, int i) {
    if (b.valid[i] == 0 || ct_ss_owner(b.q + 8 * (size_t)i, b.n_shards) != b.shard) return false;
    if (!kCommit) return true;
    int t = i / b.k;
    return b.present[i] == 0 && ct_ss_request_conflict(b.conf_row + (size_t)t * b.k, b.k,
                                                       b.pre_conflict[t], b.force[t]) == 0;
}

// One row's step on one warp, on the table as it stands: J inserts the row
// into the first free slot of its window or flags it overflowing; K
// tombstones the first live slot holding its key (lanes 0-7 the key, 8-15
// the payload, 16 the tag) and flags it removed. Returns 1 when it wrote.
template <bool kCommit>
__device__ __forceinline__ int ct_ss_row_step(const ct_ss_batch& b, int row, uint32_t home,
                                              int lane) {
    const int32_t* qr = b.q + 8 * (size_t)row;
    int64_t at = -1;
    for (int c = 0; c < b.max_probe && at < 0; c += 32) {
        bool hit = false;
        if (c + lane < b.max_probe) {
            uint32_t s = ct_ss_window_slot(home, (uint32_t)(c + lane), b.slots);
            int32_t tag = __ldcg(b.tags + s);
            if (kCommit) {
                hit = (tag & 1) == 0;
            } else if (tag & 1) {
                const int4* key = reinterpret_cast<const int4*>(b.keys + 8 * (size_t)s);
                int4 k0 = __ldcg(key), k1 = __ldcg(key + 1);
                hit = k0.x == qr[0] && k0.y == qr[1] && k0.z == qr[2] && k0.w == qr[3] &&
                      k1.x == qr[4] && k1.y == qr[5] && k1.z == qr[6] && k1.w == qr[7];
            }
        }
        unsigned lanes = __ballot_sync(CT_SS_FULL, hit);
        if (lanes) at = ct_ss_window_slot(home, (uint32_t)(c + __ffs(lanes) - 1), b.slots);
    }
    if (at >= 0) {
        size_t s = (size_t)at;
        if (lane < 8)
            b.keys[8 * s + lane] = kCommit ? qr[lane] : 0;
        else if (lane < 16)
            b.txs[8 * s + lane - 8] = kCommit ? b.qtx[8 * (size_t)(row / b.k) + lane - 8] : 0;
        else if (lane == 16)
            b.tags[s] = kCommit ? (b.qtag[row] | 1) : CT_SS_TOMBSTONE;
    }
    if (lane == 0) b.flag[row] = kCommit ? at < 0 : at >= 0;
    return at >= 0;
}

// Kernel J's phase 2 (kCommit) and kernel K, one cooperative launch of
// CT_SS_WARPS-warp blocks: each request's verdict and each row's state,
// then the rounds, then one warp walks the rows left, in row order.
template <bool kCommit>
__global__ void __launch_bounds__(32 * CT_SS_WARPS)
    statestore_rounds_kernel(const __grid_constant__ ct_ss_batch b) {
    cooperative_groups::grid_group grid = cooperative_groups::this_grid();
    int lane = threadIdx.x & 31;
    int tid = (int)(blockIdx.x * blockDim.x + threadIdx.x), threads = (int)(gridDim.x * blockDim.x);
    int gwarp = tid >> 5, warps = threads >> 5;
    uint32_t nb = ct_ss_bucket_count(b.slots, b.max_probe);
    if (kCommit)
        for (int t = tid; t < b.r; t += threads)
            b.conflict[t] = ct_ss_request_conflict(b.conf_row + (size_t)t * b.k, b.k,
                                                   b.pre_conflict[t], b.force[t]);
    if (tid == 0) *b.total = 0;
    int todo = 0;
    for (int i = tid; i < b.n; i += threads) {
        bool t = ct_ss_todo<kCommit>(b, i);
        b.state[i] = t ? CT_SS_LEFT : CT_SS_IDLE;
        if (!t) b.flag[i] = 0;
        todo += t;
    }
    ct_ss_block_add(todo, b.counts + CT_SS_COUNT_TODO);
    grid.sync();
    int left = __ldcg(b.counts + CT_SS_COUNT_TODO), last = left, round = 0, wrote = 0;
    for (; round < CT_SS_MAX_ROUNDS && left > 0 && last >= b.min_free; round++) {
        int32_t* mark = b.marks + (size_t)(round & 1) * nb;
        int32_t* stale = b.marks + (size_t)((round + 1) & 1) * nb;
        // mark the rows left; clear the last round's marks (its rows: those
        // left and those it did)
        for (int i = tid; i < b.n; i += threads) {
            int s = __ldcg(b.state + i);
            if (s == CT_SS_LEFT || (round && s == 1 + round)) {
                uint32_t bk = ct_ss_bucket(ct_ss_home(b.q + 8 * (size_t)i, b.slots), nb,
                                           b.max_probe);
                if (round) stale[bk] = CT_SS_UNMARKED;
                if (s == CT_SS_LEFT) atomicMin(mark + bk, i);
            }
        }
        grid.sync();
        int freed = 0;
        for (int i = gwarp; i < b.n; i += warps) {
            if (__ldcg(b.state + i) != CT_SS_LEFT) continue;
            uint32_t home = ct_ss_home(b.q + 8 * (size_t)i, b.slots);
            if (!ct_ss_round_free(mark, nb, ct_ss_bucket(home, nb, b.max_probe), i)) continue;
            wrote += ct_ss_row_step<kCommit>(b, i, home, lane);
            if (lane == 0) b.state[i] = 2 + round;
            freed++;
        }
        ct_ss_block_add(lane == 0 ? freed : 0, b.counts + round);
        grid.sync();
        last = __ldcg(b.counts + round);
        left -= last;
    }
    // clear the last round's marks, and set a bit for each row left
    int32_t* mark = b.marks + (size_t)((round + 1) & 1) * nb;
    for (int c = gwarp; c * 32 < b.n; c += warps) {
        int i = c * 32 + lane;
        int s = i < b.n ? __ldcg(b.state + i) : CT_SS_IDLE;
        if (round && (s == CT_SS_LEFT || s == 1 + round))
            mark[ct_ss_bucket(ct_ss_home(b.q + 8 * (size_t)i, b.slots), nb, b.max_probe)] =
                CT_SS_UNMARKED;
        unsigned bits = __ballot_sync(CT_SS_FULL, s == CT_SS_LEFT);
        if (lane == 0) b.left_bits[c] = (int32_t)bits;
    }
    ct_ss_block_add(lane == 0 ? wrote : 0, b.total);
    if (left == 0) return;
    grid.sync();
    if (blockIdx.x != 0 || threadIdx.x >= 32) return;
    // the walk: the rows left, in row order, on one warp, which reads their
    // bits 1,024 rows at a time
    int walked = 0, words = (b.n + 31) >> 5;
    wrote = 0;
    for (int w0 = 0; w0 < words; w0 += 32) {
        unsigned word = w0 + lane < words ? (unsigned)__ldcg(b.left_bits + w0 + lane) : 0u;
        unsigned busy = __ballot_sync(CT_SS_FULL, word != 0);
        while (busy) {
            int t = __ffs(busy) - 1;
            busy &= busy - 1;
            unsigned rows = __shfl_sync(CT_SS_FULL, word, t);
            int i0 = (w0 + t) * 32;
            uint32_t my_home =
                (rows >> lane) & 1 ? ct_ss_home(b.q + 8 * (size_t)(i0 + lane), b.slots) : 0;
            while (rows) {
                int r = __ffs(rows) - 1;
                rows &= rows - 1;
                wrote += ct_ss_row_step<kCommit>(b, i0 + r, __shfl_sync(CT_SS_FULL, my_home, r),
                                                 lane);
                walked++;
                __syncwarp();
            }
        }
    }
    if (lane == 0) {
        atomicAdd(b.total, wrote);
        b.counts[CT_SS_COUNT_WALKED] = walked;
    }
}

// The cooperative launch of the rounds kernel: one warp a row, at most as
// many blocks as the card holds at once.
template <bool kCommit>
static int ct_ss_launch_rounds(ct_ss_batch& b, cudaStream_t st) {
    int dev, sms, per_sm;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, statestore_rounds_kernel<kCommit>, 32 * CT_SS_WARPS, 0);
    if (err != cudaSuccess) return (int)err;
    int blocks = (b.n + CT_SS_WARPS - 1) / CT_SS_WARPS;
    if (blocks > per_sm * sms) blocks = per_sm * sms;
    void* args[] = {&b};
    err = cudaLaunchCooperativeKernel((const void*)statestore_rounds_kernel<kCommit>, dim3(blocks),
                                      dim3(32 * CT_SS_WARPS), args, 0, st);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
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

// Kernel J's phase 1 alone, for a table striped over shards: keys, txs
// (slots, 8), tags (slots,) the shard's table, read only; q (r*k, 8), qtx
// (r, 8), valid (r*k,) int32, 16-byte aligned; out (2*r*k,) int32: each
// row's present bit, then its conflict bit. Launches on `stream`, returns
// the cudaError_t of the launch.
extern "C" int ct_statestore_commit_check(const void* keys, const void* txs, const void* tags,
                                          int slots, int max_probe, int n_shards, int shard,
                                          const void* q, const void* qtx, const void* valid,
                                          int r, int k, void* out, void* stream) {
    int rk = r * k;
    if (rk <= 0) return 0;
    int32_t* present = (int32_t*)out;
    statestore_commit_check_kernel<<<(rk + CT_SS_WARPS - 1) / CT_SS_WARPS, 32 * CT_SS_WARPS, 0,
                                     (cudaStream_t)stream>>>(
        (const int32_t*)keys, (const int32_t*)txs, (const int32_t*)tags, (uint32_t)slots,
        max_probe, (uint32_t)n_shards, (uint32_t)shard, (const int32_t*)q, (const int32_t*)qtx,
        (const int32_t*)valid, rk, k, present, present + rk);
    return (int)cudaGetLastError();
}

// keys, txs (slots, 8), tags (slots,): the table, updated in place; q
// (r*k, 8), qtx (r, 8), qtag, valid (r*k,), pre_conflict, force (r,)
// int32, 16-byte aligned; scratch (3*r*k + CT_SS_COUNTS + ceil(r*k / 32),)
// int32 zeroed: the check's flags, the row states, the counts (rows freed
// a round, rows to do, rows walked), then the walk's row bits; marks
// (2 * ct_ss_bucket_count) int32, all CT_SS_UNMARKED, left so; rounds run
// while the last freed at least min_free rows (the rows to do before the
// first). out (r + r*k + 1,) int32: conflict, overflow, insert count.
// Launches both phases on `stream`, returns the cudaError_t of the
// launches.
extern "C" int ct_statestore_commit(void* keys, void* txs, void* tags, int slots, int max_probe,
                                    int n_shards, int shard, const void* q, const void* qtx,
                                    const void* qtag, const void* valid,
                                    const void* pre_conflict, const void* force, int r, int k,
                                    void* scratch, void* marks, int min_free, void* out,
                                    void* stream) {
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
    ct_ss_batch b = {(int32_t*)keys, (int32_t*)txs, (int32_t*)tags, (uint32_t)slots,
                     (uint32_t)n_shards, (uint32_t)shard, max_probe, (const int32_t*)q,
                     (const int32_t*)qtx, (const int32_t*)qtag, (const int32_t*)valid,
                     (const int32_t*)pre_conflict, (const int32_t*)force, present, conf_row,
                     r, k, rk, conf_row + rk, (int32_t*)marks, conf_row + 2 * rk,
                     conf_row + 2 * rk + CT_SS_COUNTS, min_free, (int32_t*)out,
                     (int32_t*)out + r, (int32_t*)out + r + rk};
    return ct_ss_launch_rounds<true>(b, st);
}

// keys, txs (slots, 8), tags (slots,): the table, updated in place; q (n,
// 8), valid (n,) int32, 16-byte aligned; scratch (n + CT_SS_COUNTS +
// ceil(n / 32),) int32 zeroed: the row states, the counts, the walk's row
// bits; marks and min_free as for the commit; out (n + 1,) int32: removed,
// then the count. Launches on `stream`, returns the cudaError_t of the
// launch.
extern "C" int ct_statestore_remove(void* keys, void* txs, void* tags, int slots, int max_probe,
                                    int n_shards, int shard, const void* q, const void* valid,
                                    int n, void* scratch, void* marks, int min_free, void* out,
                                    void* stream) {
    if (n <= 0) return 0;
    ct_ss_batch b = {(int32_t*)keys, (int32_t*)txs, (int32_t*)tags, (uint32_t)slots,
                     (uint32_t)n_shards, (uint32_t)shard, max_probe, (const int32_t*)q,
                     nullptr, nullptr, (const int32_t*)valid, nullptr, nullptr, nullptr, nullptr,
                     n, 1, n, (int32_t*)scratch, (int32_t*)marks, (int32_t*)scratch + n,
                     (int32_t*)scratch + n + CT_SS_COUNTS, min_free, nullptr, (int32_t*)out,
                     (int32_t*)out + n};
    return ct_ss_launch_rounds<false>(b, (cudaStream_t)stream);
}

// next: (m,) int32 links; out: one int32. Launches one thread on `stream`.
extern "C" int ct_statestore_chase(const void* next, int hops, void* out, void* stream) {
    statestore_chase_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((const int32_t*)next, hops,
                                                               (int32_t*)out);
    return (int)cudaGetLastError();
}
