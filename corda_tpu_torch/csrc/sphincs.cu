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
// chains: a FORS tree of 26 blocks, its pk of 9, then per layer a chain of
// up to 30 blocks, the WOTS pk of 35 and 6 node hashes of 3, one after the
// other; and the verifier's SPHINCS buckets are small (8-32 lanes). So the
// design is one block a lane, its independent chains on separate threads:
// - 14 threads walk the FORS trees at once, 67 threads a layer's chains;
// - each chain runs only the steps it needs (digit .. 14), where the TPU's
//   masked loop ran all 15;
// - the messages live in shared memory, written by the threads that make
//   their parts and hashed by one, a barrier between stages;
// - a lane that failed the host's precheck leaves as a whole block, before
//   any barrier.
// Its floor is then the longest lane's serial chain of blocks; making it
// faster (more lanes a block, the serial hashes split across warps) is
// later work.
#include <cuda_runtime.h>

#include "sphincs.cuh"

__global__ void __launch_bounds__(CT_SP_THREADS)
sphincs_verify_kernel(const uint8_t* __restrict__ sigs, const uint8_t* __restrict__ dgs,
                      const int64_t* __restrict__ idxs, const uint8_t* __restrict__ pre,
                      uint8_t* __restrict__ out) {
    __shared__ ct_sp_smem S;
    const int lane = blockIdx.x;
    if (!pre[lane]) {  // the whole block: every thread reads the same flag
        if (threadIdx.x == 0) out[lane] = 0;
        return;
    }
    const uint8_t* sig = sigs + (size_t)lane * CT_SP_SIG_LEN;
    const uint8_t* dg = dgs + (size_t)lane * CT_SP_N;
    const uint64_t idx = (uint64_t)idxs[lane];
    for (int s = 0; s < CT_SP_STAGES; s++) {
        ct_sp_stage(S, s, (int)threadIdx.x, sig, dg, idx);
        __syncthreads();
    }
    if (threadIdx.x == 0) out[lane] = (uint8_t)ct_sp_verdict(S, sig);
}

// sigs: (n, 13480) uint8; dgs: (n, 32) uint8 FORS digests; idxs: (n,)
// int64 hypertree indices; pre: (n,) uint8 host precheck; out: (n,) uint8
// verdicts. One block a lane, launched on `stream`; returns the cudaError_t.
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
