// Kernel A: ed25519_challenge.
//
// Replaces the XLA prologue of corda_tpu/ops/ed25519.py::_tpu_verify_fixedlen
// (:355-362): sha512.py::sha512_blocks over one block, then
// scalar25519.py::challenge_windows (Barrett mod L, 4-bit windows).
//
// One thread per lane: 80 rounds of SHA-512 on native 64-bit words, the
// Barrett reduction on 32-bit limbs, 64 windows out. What bounds it on this
// card: integer instructions (each 64-bit rotate or add is two 32-bit
// instructions; about 5.5k per lane) against 384 bytes moved per lane, so it
// is bound by operations, far below the ladder it feeds. The windows go out
// as (64, B) int32 so that neighbouring threads write, and kernel B reads,
// neighbouring addresses.
#include <cuda_runtime.h>

#include "sha512_modl.cuh"

__global__ void __launch_bounds__(128)
ed25519_challenge_kernel(const uint8_t* __restrict__ packed,
                         int32_t* __restrict__ win, int n) {
    int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    ct_challenge_lane(packed + (size_t)lane * CT_PACKED_ROW, win + lane, n);
}

// packed: (n, 161) uint8; win: (64, n) int32. Launches on `stream`, returns
// the cudaError_t of the launch.
extern "C" int ct_ed25519_challenge(const void* packed, void* win, int n,
                                    void* stream) {
    dim3 grid((n + 127) / 128);
    ed25519_challenge_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)packed, (int32_t*)win, n);
    return (int)cudaGetLastError();
}

extern "C" const char* ct_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
