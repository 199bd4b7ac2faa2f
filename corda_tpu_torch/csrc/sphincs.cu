// Kernel H: sphincs_verify, batched verification of the hash-based scheme
// (scheme 5) on the card.
//
// Replaces corda_tpu/ops/sphincs_batch.py::_sphincs_pipeline (:279, under
// jax.jit :336), which ran the whole FORS and hypertree walk as one fused
// XLA program over 13 host-packed planes, with sha256_bytes_device
// (ops/sha256.py:206) for every hash and _device_digits (:69) for the
// Winternitz digits. Here the host hands over the signature rows, the FORS
// digests, the hypertree indices and its precheck, and the kernel computes
// every prefix, address and digit itself (sphincs.cuh).
//
// What bounds it on this card: 32-bit integer operations, about 4,600
// SHA-256 compressions a signature of about 1,384 operations each, against
// 13,522 bytes read a signature. But a signature's work is long serial
// chains (a FORS tree of 26 blocks, its pk of 9, then per layer a chain of
// up to 30 blocks, the WOTS pk of 35 and 6 node hashes of 3, one after the
// other), and the verifier's SPHINCS buckets are small (8-32 lanes): the
// time is one lane's chain of dependent rounds. So the design is one block
// a lane, and it shortens that chain (sphincs.cuh):
// - no byte is moved: every message block is assembled as words in
//   registers, and shared memory carries only what crosses threads;
// - the rounds that read only words known at launch run once, in stage 0,
//   on a warp the FORS stage leaves idle;
// - the serial hashes (the FORS trees, the FORS pk, each WOTS pk and auth
//   path) run on a warp pair, the schedule on one warp's scheduler and the
//   rounds on another's;
// - a round's sums are regrouped so its critical path is three dependent
//   operations, not four: the rounds' latency, not the issue rate, bounds
//   a serial hash on this card;
// - each chain runs only the steps it needs (digit .. 14), where the TPU's
//   masked loop ran all 15;
// - the code stays small (one chunk's code in a loop where a loop does),
//   for at 1,024 lanes eight blocks share an SM in different stages;
// - a lane that failed the host's precheck leaves as a whole block, before
//   any barrier; no thread leaves before a named barrier it is counted in.
#include <cuda_runtime.h>

#include "sphincs.cuh"

__global__ void __launch_bounds__(CT_SP_THREADS, 8)
sphincs_verify_kernel(const uint8_t* __restrict__ sigs, const uint8_t* __restrict__ dgs,
                      const int64_t* __restrict__ idxs, const uint8_t* __restrict__ pre,
                      uint8_t* __restrict__ out) {
    __shared__ ct_sp_smem S;
    const int b = blockIdx.x;
    if (!pre[b]) {  // the whole block: every thread reads the same flag
        if (threadIdx.x == 0) out[b] = 0;
        return;
    }
    ct_sp_lane L;
    ct_sp_lane_init(L, sigs + (size_t)b * CT_SP_SIG_LEN, dgs + (size_t)b * CT_SP_N,
                    (uint64_t)idxs[b]);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

    // stage 0: the FORS trees on the pair, the hoisted states on warp 2
    if (warp == CT_SP_HOISTER) {
        ct_sp_hoist(S, L, lane, 0);
        ct_bar_arrive(CT_SP_BAR_HOIST, 64);
        ct_sp_hoist(S, L, lane, 1);
    } else {
        ct_sp_ring ch{&S, lane, 0};
        const int t = min(lane, CT_SP_K - 1);
        if (warp == CT_SP_PROD) {
#pragma unroll 1
            for (int h = 0; h <= CT_SP_A; h++) ct_sp_fors_put(ch, L, t, h);
            ch.drain();
        } else {
            uint32_t node[8];
            ct_bar_sync(CT_SP_BAR_HOIST, 64);
#pragma unroll 1
            for (int h = 0; h <= CT_SP_A; h++) ct_sp_fors_get(ch, S, h, node);
            if (lane < CT_SP_K) ct_sp_store8(S.data, 8 * lane, node);
        }
    }
    __syncthreads();

    // stage 1: the FORS pk
    if (warp == CT_SP_PROD) {
        ct_sp_ring ch{&S, lane, 0};
        ct_sp_fpk_put(ch, L, S);
        ch.drain();
    } else if (warp == CT_SP_CONS) {
        ct_sp_ring ch{&S, lane, 0};
        uint32_t dg[8];
        ct_sp_get_hash(ch, dg, S.hoist + CT_SP_AT(8 * CT_SP_H_FPK), CT_SP_PK_FROM,
                       CT_SP_BLOCKS(CT_SP_FPK_LEN), nullptr);
        if (lane == 0)
            for (int i = 0; i < 8; i++) S.digest[i] = dg[i];
    }
    __syncthreads();

#pragma unroll 1
    for (int layer = 0; layer < CT_SP_D; layer++) {
        // stage 2 + 2L: the chains
        if (threadIdx.x < CT_SP_LEN) ct_sp_chain(S, L, threadIdx.x, layer);
        __syncthreads();
        // stage 3 + 2L: the WOTS pk and the auth path
        if (warp == CT_SP_PROD) {
            ct_sp_ring ch{&S, lane, 0};
#pragma unroll 1
            for (int h = 0; h <= CT_SP_HT; h++) ct_sp_layer_put(ch, L, S, layer, h);
            ch.drain();
        } else if (warp == CT_SP_CONS) {
            ct_sp_ring ch{&S, lane, 0};
            uint32_t node[8];
#pragma unroll 1
            for (int h = 0; h <= CT_SP_HT; h++) ct_sp_layer_get(ch, L, S, layer, h, node);
            if (lane == 0)
                for (int i = 0; i < 8; i++) S.digest[i] = node[i];
        }
        __syncthreads();
    }
    if (threadIdx.x == 0) out[b] = (uint8_t)ct_sp_verdict(S, L.sig);
}

// sigs: (n, 13480) uint8, 4-byte aligned; dgs: (n, 32) uint8 FORS digests;
// idxs: (n,) int64 hypertree indices; pre: (n,) uint8 host precheck; out:
// (n,) uint8 verdicts. One block a lane, launched on `stream`; returns the
// cudaError_t.
extern "C" int ct_sphincs_verify(const void* sigs, const void* dgs, const void* idxs,
                                 const void* pre, void* out, int n, void* stream) {
    if (n <= 0) return 0;
    sphincs_verify_kernel<<<n, CT_SP_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)sigs, (const uint8_t*)dgs, (const int64_t*)idxs, (const uint8_t*)pre,
        (uint8_t*)out);
    return (int)cudaGetLastError();
}

// Static shared memory of one block.
extern "C" int ct_sphincs_smem_bytes() { return (int)sizeof(ct_sp_smem); }
