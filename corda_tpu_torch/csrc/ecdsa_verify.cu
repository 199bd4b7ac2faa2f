// Kernel F: ecdsa_verify_k1 and ecdsa_verify_r1, batched ECDSA verification
// over secp256k1 and secp256r1.
//
// Replaces corda_tpu/ops/secp256_pallas.py::_make_kernel (:1120, running
// _verify_block :1028), launched there by ecdsa_verify_pallas (:1231,
// pallas_call :1272) from ops/secp256.py::_ecdsa_pallas_donated (:590).
//
// One thread per signature, one source with one instantiation per curve
// (secp256_field.cuh's curve traits); the arithmetic is ecdsa_ladder.cuh.
// What bounds it on this card: integer multiply-adds, about 263 doublings
// and 103 complete additions a lane of 14 field multiplies each, 64
// products of 32 x 32 -> 64 bits a multiply; the bytes moved (194 in, 1
// out a lane) are negligible beside them. As in kernel B, each lane is
// one long dependent chain, so at the verifier's buckets latency and
// occupancy, not the multiply rate, set the time. The design keeps the
// accumulator in registers, puts the 16-entry k*Q table (1,536 bytes a
// thread) in local memory, which L1 caches, and reads the 256-entry G comb
// (24,576 bytes a curve, entry indices differing from lane to lane)
// through the read-only data cache (__ldg) rather than staging it in
// shared memory. A lane whose host precheck failed returns before the
// ladder: the verifier pads a bucket at its end, so whole warps of padding
// exit at once.
#include <cuda_runtime.h>

#include "ecdsa_ladder.cuh"

template <class C>
__device__ __forceinline__ void ecdsa_verify_body(const uint8_t* __restrict__ packed,
                                                  const int32_t* __restrict__ table,
                                                  uint8_t* __restrict__ out, int n) {
    int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    ct_sp_point qtab[16];
    out[lane] = (uint8_t)ct_ecdsa_verify_lane<C>(packed + (size_t)lane * CT_ECDSA_ROW,
                                                 table, qtab);
}

__global__ void __launch_bounds__(128)
ecdsa_verify_k1_kernel(const uint8_t* __restrict__ packed, const int32_t* __restrict__ table,
                       uint8_t* __restrict__ out, int n) {
    ecdsa_verify_body<ct_secp256k1>(packed, table, out, n);
}

__global__ void __launch_bounds__(128)
ecdsa_verify_r1_kernel(const uint8_t* __restrict__ packed, const int32_t* __restrict__ table,
                       uint8_t* __restrict__ out, int n) {
    ecdsa_verify_body<ct_secp256r1>(packed, table, out, n);
}

// packed: (n, 194) uint8; table: (771, 8) int32 of the launch's curve;
// out: (n,) uint8 verdicts. Launches on `stream`, returns the cudaError_t.
extern "C" int ct_ecdsa_verify_k1(const void* packed, const void* table, void* out,
                                  int n, void* stream) {
    ecdsa_verify_k1_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)packed, (const int32_t*)table, (uint8_t*)out, n);
    return (int)cudaGetLastError();
}

extern "C" int ct_ecdsa_verify_r1(const void* packed, const void* table, void* out,
                                  int n, void* stream) {
    ecdsa_verify_r1_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)packed, (const int32_t*)table, (uint8_t*)out, n);
    return (int)cudaGetLastError();
}
