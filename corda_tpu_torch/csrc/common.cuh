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

// Bytes per lane of the packed verify plane: a padded SHA-512 block
// carrying R || A || M (0..127), s (128..159), the host precheck (160).
#define CT_PACKED_ROW 161
#define CT_WINDOWS 64
