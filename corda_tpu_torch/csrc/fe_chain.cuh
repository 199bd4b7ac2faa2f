// The two fixed exponents of p = 2^255 - 19 as ref10's curve25519 addition
// chains, over a field trait F (F::fe, F::sq, F::mul), so kernel B's ten-limb
// field (fe25519.cuh) and kernel G's eight-word field (fe25519_w8.cuh) run
// one schedule: the same one as corda_tpu_torch/ops/addchain.py.
#pragma once

#include "common.cuh"

// h = f^(2^n)
template <class F>
CT_HD void ct_sq_n(typename F::fe& h, const typename F::fe& f, int n) {
    h = f;
#pragma unroll 1
    for (int k = 0; k < n; k++) F::sq(h, h);
}

// z -> (z^11, z^(2^250 - 1))
template <class F>
CT_HD void ct_chain_core(const typename F::fe& z, typename F::fe& z11,
                         typename F::fe& z250) {
    typename F::fe z2, z9, t, z5, z10, z20, z40, z50, z100, z200;
    F::sq(z2, z);
    ct_sq_n<F>(t, z2, 2);
    F::mul(z9, z, t);
    F::mul(z11, z2, z9);
    F::sq(t, z11);
    F::mul(z5, z9, t);
    ct_sq_n<F>(t, z5, 5);
    F::mul(z10, t, z5);
    ct_sq_n<F>(t, z10, 10);
    F::mul(z20, t, z10);
    ct_sq_n<F>(t, z20, 20);
    F::mul(z40, t, z20);
    ct_sq_n<F>(t, z40, 10);
    F::mul(z50, t, z10);
    ct_sq_n<F>(t, z50, 50);
    F::mul(z100, t, z50);
    ct_sq_n<F>(t, z100, 100);
    F::mul(z200, t, z100);
    ct_sq_n<F>(t, z200, 50);
    F::mul(z250, t, z50);
}

// z^(p - 2) = 1/z (0 -> 0): 254 squarings + 11 multiplies
template <class F>
CT_HD void ct_pow_inv(typename F::fe& out, const typename F::fe& z) {
    typename F::fe z11, z250, t;
    ct_chain_core<F>(z, z11, z250);
    ct_sq_n<F>(t, z250, 5);
    F::mul(out, t, z11);
}

// z^((p - 5) / 8): 251 squarings + 11 multiplies
template <class F>
CT_HD void ct_pow_p58(typename F::fe& out, const typename F::fe& z) {
    typename F::fe z11, z250, t;
    ct_chain_core<F>(z, z11, z250);
    ct_sq_n<F>(t, z250, 2);
    F::mul(out, t, z);
}
