// Measuring probes, on no path of the port.
//
// ct_fe_chain_probe: the two exponent chains of one ed25519 verification
// (fe_chain.cuh: the decompression's z^((p - 5) / 8) and the encoding's
// inversion), run whole on every thread in the launch shape of kernels B
// and G (four threads a signature, 128-thread blocks), over either field.
// Timed beside the ladders (chip_smoke.py phase 11), it gives what the
// chains cost of a verify in the four-thread design, where every thread of
// a quad runs them.
//
// ct_comb_chain_probe: kernel E's inversion alone (the eight-word field's),
// in E's launch shape (ed25519_comb.cu: 128-thread blocks of 8 signatures,
// the chain whole on every thread of warp 0, the other warps idle). Timed
// beside E (chip_smoke.py phase 8), it gives the chain's share of E's time.
//
// They stay in csrc/ only while those readings are needed to choose
// between running the chains whole on each thread and splitting their
// products across the quad (ROADMAP Queue 4, item 2); once that is decided
// they leave the kernel build.
#include <cuda_runtime.h>

#include "ed25519_quad.cuh"
#include "fe25519_w8.cuh"

// each thread: y from its signature's A (packed row bytes 32..63), then
// z = y^((p - 5) / 8) and 1/z; one word of the result is written so the
// work cannot be dropped
template <class F>
__global__ void __launch_bounds__(CT_QUAD_BLOCK)
fe_chain_probe_kernel(const uint8_t* __restrict__ packed, uint32_t* __restrict__ out, int n) {
    int t = (int)(blockIdx.x * blockDim.x + threadIdx.x);
    int sig = t >> 2;
    int s = sig < n ? sig : n - 1;
    typename F::fe y, z, zinv;
    F::from_bytes(y, packed + (size_t)s * CT_PACKED_ROW + 32);
    F::pow_p58(z, y);
    F::inv(zinv, z);
    if (sig < n) out[t] = (uint32_t)zinv.v[0];
}

// packed: (n, 161) uint8; out: (4n,) uint32; field: 10 (kernel B's) or 8
// (kernel G's). Launches on `stream`, returns the cudaError_t.
extern "C" int ct_fe_chain_probe(const void* packed, void* out, int n, int field,
                                 void* stream) {
    dim3 grid((unsigned)((4LL * n + CT_QUAD_BLOCK - 1) / CT_QUAD_BLOCK));
    if (field == 10)
        fe_chain_probe_kernel<ct_fe10><<<grid, CT_QUAD_BLOCK, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)packed, (uint32_t*)out, n);
    else if (field == 8)
        fe_chain_probe_kernel<ct_fe8><<<grid, CT_QUAD_BLOCK, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)packed, (uint32_t*)out, n);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

// each thread of warp 0: z from its signature's scalar bytes, then 1/z;
// one word written so the work cannot be dropped
__global__ void __launch_bounds__(128)
comb_chain_probe_kernel(const uint8_t* __restrict__ r, uint32_t* __restrict__ out, int n) {
    if (threadIdx.x >= 32) return;
    int sig = (int)(blockIdx.x * 8 + (threadIdx.x >> 2));
    int s = sig < n ? sig : n - 1;
    ct_u256 z, zinv;
    ct_fe8::from_bytes(z, r + (size_t)s * 32);
    ct_fe8::inv(zinv, z);
    if (sig < n) out[(size_t)sig * 4 + (threadIdx.x & 3)] = zinv.v[0];
}

// r: (n, 32) uint8; out: (4n,) uint32. Launches on `stream`, returns the
// cudaError_t.
extern "C" int ct_comb_chain_probe(const void* r, void* out, int n, void* stream) {
    dim3 grid((unsigned)((n + 7) / 8));
    comb_chain_probe_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>((const uint8_t*)r,
                                                                   (uint32_t*)out, n);
    return (int)cudaGetLastError();
}
