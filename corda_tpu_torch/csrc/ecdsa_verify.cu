// Kernel F: ecdsa_verify_k1 and ecdsa_verify_r1, batched ECDSA verification
// over secp256k1 and secp256r1.
//
// Replaces corda_tpu/ops/secp256_pallas.py::_make_kernel (:1120, running
// _verify_block :1028), launched there by ecdsa_verify_pallas (:1231,
// pallas_call :1272) from ops/secp256.py::_ecdsa_pallas_donated (:590).
//
// One source with one instantiation per curve (secp256_field.cuh's curve
// traits); the arithmetic is ecdsa_ladder.cuh. What bounds it on this card:
// integer multiply-adds, about 263 doublings and 103 complete additions a
// signature of 12-14 field products each, 64 products of 32 x 32 -> 64 bits
// a multiply (36 a square); the bytes moved (194 in, 1 out a signature) are
// negligible beside them. A signature's work is one long dependent chain,
// and the verifier's buckets are small (a curve's share of a mixed batch is
// about 1,365 signatures): at one thread a signature they fill 11 blocks of
// one warp on a card of 132 SMs, and the chain's latency sets the time.
// The design:
// - four threads a signature (a quad): every value of the point formulas
//   is held by all four, and the formulas' independent products are dealt
//   out one a thread a round (ecdsa_ladder.cuh), 3-4 rounds a point
//   operation where one thread ran 12-14 products in a row;
// - the quad leaves as one (a failed precheck, Q off the curve, or past
//   the batch's end: every thread of a quad computes the same verdict), and
//   every shuffle names only its quad's four threads, so lanes that left
//   early never block one;
// - the 16-entry k*Q table (1,536 bytes a signature) in dynamic shared
//   memory, written once and read by all four threads of the quad, where
//   one thread a signature kept it in local memory;
// - dedicated squarings for the doublings' X^2, Y^2, Z^2 and the on-curve
//   check (36 products, not 64);
// - the 256-entry G comb (24,576 bytes a curve, entry indices differing
//   from signature to signature) read through the read-only data cache.
#include <cuda_runtime.h>

#include "ecdsa_ladder.cuh"

#define CT_ECDSA_BLOCK 128  // threads a block: 32 signatures

// dynamic shared memory of a block: its signatures' k*Q tables
constexpr int ct_ecdsa_smem_bytes() { return 16 * 24 * 4 * (CT_ECDSA_BLOCK / 4); }

template <class C>
__device__ __forceinline__ void ecdsa_verify_body(const uint8_t* __restrict__ packed,
                                                  const int32_t* __restrict__ table,
                                                  uint8_t* __restrict__ out, int n) {
    extern __shared__ int32_t ct_ecdsa_smem[];
    int sig = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 2);
    if (sig >= n) return;  // the whole quad: its four threads share sig
    ct_gq g{0xFu << (threadIdx.x & 28)};
    ct_sp_qtab qtab{ct_ecdsa_smem + (threadIdx.x >> 2), CT_ECDSA_BLOCK / 4};
    int ok = ct_ecdsa_verify_lane<C>(packed + (size_t)sig * CT_ECDSA_ROW, table, qtab, g);
    if ((threadIdx.x & 3) == 0) out[sig] = (uint8_t)ok;
}

__global__ void __launch_bounds__(CT_ECDSA_BLOCK)
ecdsa_verify_k1_kernel(const uint8_t* __restrict__ packed, const int32_t* __restrict__ table,
                       uint8_t* __restrict__ out, int n) {
    ecdsa_verify_body<ct_secp256k1>(packed, table, out, n);
}

__global__ void __launch_bounds__(CT_ECDSA_BLOCK)
ecdsa_verify_r1_kernel(const uint8_t* __restrict__ packed, const int32_t* __restrict__ table,
                       uint8_t* __restrict__ out, int n) {
    ecdsa_verify_body<ct_secp256r1>(packed, table, out, n);
}

typedef void (*ct_ecdsa_kernel_t)(const uint8_t*, const int32_t*, uint8_t*, int);

// four threads a signature; returns the cudaError_t of raising the kernel's
// shared memory limit or of the launch
static int ct_ecdsa_launch(ct_ecdsa_kernel_t kernel, const void* packed, const void* table,
                           void* out, int n, void* stream) {
    int smem = ct_ecdsa_smem_bytes();
    cudaError_t err = cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((unsigned)((4LL * n + CT_ECDSA_BLOCK - 1) / CT_ECDSA_BLOCK));
    kernel<<<grid, CT_ECDSA_BLOCK, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)packed, (const int32_t*)table, (uint8_t*)out, n);
    return (int)cudaGetLastError();
}

// packed: (n, 194) uint8; table: (771, 8) int32 of the launch's curve;
// out: (n,) uint8 verdicts. Launches on `stream`, returns the cudaError_t.
extern "C" int ct_ecdsa_verify_k1(const void* packed, const void* table, void* out,
                                  int n, void* stream) {
    return ct_ecdsa_launch(ecdsa_verify_k1_kernel, packed, table, out, n, stream);
}

extern "C" int ct_ecdsa_verify_r1(const void* packed, const void* table, void* out,
                                  int n, void* stream) {
    return ct_ecdsa_launch(ecdsa_verify_r1_kernel, packed, table, out, n, stream);
}

// Dynamic shared memory of one block, as the launch sets it.
extern "C" int ct_ecdsa_verify_smem_bytes() { return ct_ecdsa_smem_bytes(); }
