// Shared qualifiers for code that is compiled both by nvcc (for the card)
// and by a plain C++ compiler (host_check.cpp, the CPU check of the same
// arithmetic). Outside nvcc, CT_HD expands to nothing.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define CT_HD __host__ __device__ __forceinline__
#else
#define CT_HD inline
#endif

// A read of constant table data: through the read-only data cache on the
// card, a plain load on the host.
template <typename T>
CT_HD T ct_ldg(const T* p) {
#if defined(__CUDA_ARCH__)
    return __ldg(p);
#else
    return *p;
#endif
}

// __byte_perm: byte i of the result is byte (s >> 4i) & 7 of y:x (x the low
// four). The host's copy ignores the sign-replicating mode (bit 3), which
// no caller uses.
CT_HD uint32_t ct_byte_perm(uint32_t x, uint32_t y, uint32_t s) {
#if defined(__CUDA_ARCH__)
    return __byte_perm(x, y, s);
#else
    uint64_t v = ((uint64_t)y << 32) | x;
    uint32_t r = 0;
    for (int i = 0; i < 4; i++)
        r |= (uint32_t)((v >> (8 * ((s >> (4 * i)) & 7))) & 0xffu) << (8 * i);
    return r;
#endif
}

#if defined(__CUDACC__)
// Warp specialisation's plumbing (kernels A and C): 16-byte asynchronous
// copies from global into shared memory, and named barriers between a
// producer warp (bar.arrive) and a consumer warp (bar.sync). A barrier
// orders the shared-memory writes and reads of the threads that take part.
__device__ __forceinline__ void ct_cp_async16(void* smem, const void* gmem) {
    uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
// The same copy of only the first `src_bytes` (0..16) bytes at gmem, the
// rest of the 16 zero-filled: no byte past them is read.
__device__ __forceinline__ void ct_cp_async16_part(void* smem, const void* gmem, int src_bytes) {
    uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
                 "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void ct_cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void ct_cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ct_bar_sync(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void ct_bar_arrive(int id, int threads) {
    asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
#endif

// Bytes per lane of the packed verify plane: a padded SHA-512 block
// carrying R || A || M (0..127), s (128..159), the host precheck (160).
#define CT_PACKED_ROW 161
#define CT_WINDOWS 64
