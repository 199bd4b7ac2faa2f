// The port's copy of native/ed25519_portable.cpp: the host CPU anchor that
// ops/host_ref.py binds. It runs on the host, never on the card.
//
// Portable scalar ed25519 verification — the measured stand-in for the
// reference's CPU path.
//
// The reference verifies transaction signatures one at a time on the JVM
// through net.i2p.crypto.eddsa (Crypto.kt:621-624 via the EdDSA provider
// registered in Crypto.kt:115-137) — a pure-software, non-SIMD, scalar
// implementation. No JVM exists in this environment, so the north-star
// multiple ("N x the reference CPU path") is anchored to THIS library
// instead: a pure-software scalar engine (radix-2^25.5 field elements,
// schoolbook multiplication, a joint double-scalar bit ladder), compiled
// -O2 without vector intrinsics. The anchor is not claimed to dominate
// the Java engine — i2p uses ref10-style windowed/NAF scalar
// multiplication (fewer point ops than this ladder) while paying JVM
// overhead; BASELINE.md carries the robustness analysis for the
// north-star verdict under a generous allowance for that difference.
//
// Scope: the hot core only. The caller supplies h = SHA-512(R‖A‖M) mod L
// (hashing is <1% of a verify and would only pad the baseline); the
// library decompresses A, walks the 256-step joint ladder for
// [s]B + [h](−A), inverts, and compares the canonical encoding with R.
// Variable-time (branchy table picks) — verification is public data.

#include <cstdint>
#include <cstring>

typedef int32_t fe[10]; // radix 2^25.5: limb i has 26 bits (even) / 25 (odd)

static const int WIDTH[10] = {26, 25, 26, 25, 26, 25, 26, 25, 26, 25};

// 2p with every limb maxed: added before subtraction to keep limbs
// non-negative (value unchanged mod p)
static const int32_t TWO_P[10] = {
    0x7ffffda, 0x3fffffe, 0x7fffffe, 0x3fffffe, 0x7fffffe,
    0x3fffffe, 0x7fffffe, 0x3fffffe, 0x7fffffe, 0x3fffffe,
};

static void fe_copy(fe h, const fe f) { memcpy(h, f, sizeof(fe)); }

static void fe_zero(fe h) { memset(h, 0, sizeof(fe)); }

static void fe_one(fe h) { fe_zero(h); h[0] = 1; }

static void carry64(int64_t c[10], fe out) {
    // three passes settle any product column sum; the 2^255 wrap is *19
    for (int pass = 0; pass < 3; pass++) {
        for (int i = 0; i < 10; i++) {
            int64_t q = c[i] >> WIDTH[i];
            c[i] -= q << WIDTH[i];
            if (i == 9) c[0] += 19 * q; else c[i + 1] += q;
        }
    }
    for (int i = 0; i < 10; i++) out[i] = (int32_t)c[i];
}

static void fe_add(fe h, const fe f, const fe g) {
    int64_t c[10];
    for (int i = 0; i < 10; i++) c[i] = (int64_t)f[i] + g[i];
    carry64(c, h);
}

static void fe_sub(fe h, const fe f, const fe g) {
    int64_t c[10];
    for (int i = 0; i < 10; i++) c[i] = (int64_t)f[i] + TWO_P[i] - g[i];
    carry64(c, h);
}

static void fe_mul(fe h, const fe f, const fe g) {
    int64_t c[19];
    memset(c, 0, sizeof(c));
    for (int i = 0; i < 10; i++)
        for (int j = 0; j < 10; j++) {
            int64_t t = (int64_t)f[i] * g[j];
            // odd*odd limbs land one bit below their column's weight
            if ((i & 1) && (j & 1)) t *= 2;
            c[i + j] += t;
        }
    for (int k = 18; k >= 10; k--) c[k - 10] += 19 * c[k];
    carry64(c, h);
}

static void fe_sq(fe h, const fe f) { fe_mul(h, f, f); }

static void fe_mul_small(fe h, const fe f, int32_t n) {
    int64_t c[10];
    for (int i = 0; i < 10; i++) c[i] = (int64_t)f[i] * n;
    carry64(c, h);
}

// z^e for a fixed 255-bit exponent given as little-endian bits
static void fe_pow(fe out, const fe z, const uint8_t *bits, int nbits) {
    fe r, t;
    fe_one(r);
    for (int i = nbits - 1; i >= 0; i--) {
        fe_sq(t, r);
        fe_copy(r, t);
        if (bits[i]) {
            fe_mul(t, r, z);
            fe_copy(r, t);
        }
    }
    fe_copy(out, r);
}

static uint8_t P_MINUS_2_BITS[255];
static uint8_t P_PLUS_3_OVER_8_BITS[252];
static int exp_ready = 0;

static void init_exponents() {
    if (exp_ready) return;
    // p - 2 = 2^255 - 21: bits via big-endian subtraction done by hand —
    // p-2 = 0x7fff...ffeb
    uint8_t pm2[32];
    memset(pm2, 0xff, 32);
    pm2[0] = 0xeb;
    pm2[31] = 0x7f;
    for (int i = 0; i < 255; i++)
        P_MINUS_2_BITS[i] = (pm2[i >> 3] >> (i & 7)) & 1;
    // (p + 3) / 8 = 2^252 - 2
    uint8_t pe[32];
    memset(pe, 0xff, 32);
    pe[0] = 0xfe;
    pe[31] = 0x0f;
    for (int i = 0; i < 252; i++)
        P_PLUS_3_OVER_8_BITS[i] = (pe[i >> 3] >> (i & 7)) & 1;
    exp_ready = 1;
}

static void fe_invert(fe out, const fe z) { fe_pow(out, z, P_MINUS_2_BITS, 255); }

static void fe_frombytes(fe h, const uint8_t s[32]) {
    int64_t c[10];
    memset(c, 0, sizeof(c));
    int bit = 0;
    for (int i = 0; i < 10; i++) {
        int64_t v = 0;
        for (int b = 0; b < WIDTH[i] && bit < 255; b++, bit++) {
            v |= (int64_t)((s[bit >> 3] >> (bit & 7)) & 1) << b;
        }
        c[i] = v;
    }
    carry64(c, h);
}

static void fe_tobytes(uint8_t s[32], const fe f) {
    // canonical reduction: limbs are non-negative (< 2^26); estimate
    // q = floor(v / p) (0 or a few), fold q*19 into limb 0, carry with
    // masking and drop bit 255
    int64_t h[10];
    for (int i = 0; i < 10; i++) h[i] = f[i];
    int64_t q = (19 * h[9] + (((int64_t)1) << 24)) >> 25;
    for (int i = 0; i < 10; i++) q = (h[i] + q) >> WIDTH[i];
    h[0] += 19 * q;
    int64_t carry = 0;
    for (int i = 0; i < 10; i++) {
        h[i] += carry;
        carry = h[i] >> WIDTH[i];
        h[i] &= ((int64_t)1 << WIDTH[i]) - 1;
    }
    memset(s, 0, 32);
    int bit = 0;
    for (int i = 0; i < 10; i++)
        for (int b = 0; b < WIDTH[i] && bit < 255; b++, bit++)
            if ((h[i] >> b) & 1) s[bit >> 3] |= 1 << (bit & 7);
}

static int fe_isnegative(const fe f) {
    uint8_t s[32];
    fe_tobytes(s, f);
    return s[0] & 1;
}

static int fe_iszero(const fe f) {
    uint8_t s[32];
    fe_tobytes(s, f);
    for (int i = 0; i < 32; i++)
        if (s[i]) return 0;
    return 1;
}

// d and sqrt(-1) as byte constants (standard curve parameters)
static const uint8_t D_BYTES[32] = {
    0xa3, 0x78, 0x59, 0x13, 0xca, 0x4d, 0xeb, 0x75, 0xab, 0xd8, 0x41,
    0x41, 0x4d, 0x0a, 0x70, 0x00, 0x98, 0xe8, 0x79, 0x77, 0x79, 0x40,
    0xc7, 0x8c, 0x73, 0xfe, 0x6f, 0x2b, 0xee, 0x6c, 0x03, 0x52,
};
static const uint8_t SQRTM1_BYTES[32] = {
    0xb0, 0xa0, 0x0e, 0x4a, 0x27, 0x1b, 0xee, 0xc4, 0x78, 0xe4, 0x2f,
    0xad, 0x06, 0x18, 0x43, 0x2f, 0xa7, 0xd7, 0xfb, 0x3d, 0x99, 0x00,
    0x4d, 0x2b, 0x0b, 0xdf, 0xc1, 0x4f, 0x80, 0x24, 0x83, 0x2b,
};
// base point y = 4/5
static const uint8_t BY_BYTES[32] = {
    0x58, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66,
    0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66,
    0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66,
};

struct ge { fe x, y, z, t; }; // extended twisted-Edwards

static void ge_identity(ge *p) {
    fe_zero(p->x); fe_one(p->y); fe_one(p->z); fe_zero(p->t);
}

static void ge_add(ge *r, const ge *p, const ge *q, const fe d2) {
    fe a, b, c, dd, e, f, g, h, t1, t2;
    fe_sub(t1, p->y, p->x);
    fe_sub(t2, q->y, q->x);
    fe_mul(a, t1, t2);
    fe_add(t1, p->y, p->x);
    fe_add(t2, q->y, q->x);
    fe_mul(b, t1, t2);
    fe_mul(t1, p->t, d2);
    fe_mul(c, t1, q->t);
    fe_mul(t1, p->z, q->z);
    fe_mul_small(dd, t1, 2);
    fe_sub(e, b, a);
    fe_sub(f, dd, c);
    fe_add(g, dd, c);
    fe_add(h, b, a);
    fe_mul(r->x, e, f);
    fe_mul(r->y, g, h);
    fe_mul(r->z, f, g);
    fe_mul(r->t, e, h);
}

static void ge_dbl(ge *r, const ge *p) {
    fe a, b, c, e, f, g, h, t1;
    fe_sq(a, p->x);
    fe_sq(b, p->y);
    fe_sq(t1, p->z);
    fe_mul_small(c, t1, 2);
    fe_add(h, a, b);
    fe_add(t1, p->x, p->y);
    fe_sq(t1, t1);
    fe_sub(e, h, t1);
    fe_sub(g, a, b);
    fe_add(f, c, g);
    fe_mul(r->x, e, f);
    fe_mul(r->y, g, h);
    fe_mul(r->z, f, g);
    fe_mul(r->t, e, h);
}

static void ge_neg(ge *r, const ge *p) {
    fe zero;
    fe_zero(zero);
    fe_sub(r->x, zero, p->x);
    fe_copy(r->y, p->y);
    fe_copy(r->z, p->z);
    fe_sub(r->t, zero, p->t);
}

// RFC 8032 decompression; returns 0 on failure
static int ge_frombytes(ge *p, const uint8_t s[32], const fe d) {
    fe u, v, v3, x2, m1, one, t;
    init_exponents();
    fe_frombytes(p->y, s);
    fe_one(one);
    fe_sq(u, p->y);
    fe_mul(v, u, d);
    fe_sub(u, u, one);   // y^2 - 1
    fe_add(v, v, one);   // d y^2 + 1
    // x = (u/v)^((p+3)/8) = u v^3 (u v^7)^((p-5)/8); use the pow-based
    // route: x = u v^3 * (u v^7)^((p-5)/8)  ==  (u/v)^((p+3)/8)
    fe_sq(t, v);
    fe_mul(v3, t, v);          // v^3
    fe_sq(t, v3);
    fe_mul(t, t, v);           // v^7
    fe_mul(t, t, u);           // u v^7
    // (p-5)/8 = (p+3)/8 - 1 → z^((p-5)/8) = z^((p+3)/8) / z
    fe x;
    fe_pow(x, t, P_PLUS_3_OVER_8_BITS, 252); // t^((p+3)/8)
    fe tinv;
    fe_invert(tinv, t);
    fe_mul(x, x, tinv);        // t^((p-5)/8)
    fe_mul(x, x, v3);
    fe_mul(x, x, u);           // u v^3 (u v^7)^((p-5)/8)
    fe_sq(x2, x);
    fe_mul(x2, x2, v);
    fe_sub(t, x2, u);
    if (!fe_iszero(t)) {
        fe_add(t, x2, u);
        if (!fe_iszero(t)) return 0;
        fe_frombytes(m1, SQRTM1_BYTES);
        fe_mul(x, x, m1);
    }
    if (fe_iszero(x) && (s[31] >> 7)) return 0;
    if (fe_isnegative(x) != (s[31] >> 7)) {
        fe zero;
        fe_zero(zero);
        fe_sub(x, zero, x);
    }
    fe_copy(p->x, x);
    fe_one(p->z);
    fe_mul(p->t, p->x, p->y);
    return 1;
}

static void ge_tobytes(uint8_t s[32], const ge *p) {
    fe zi, x, y;
    fe_invert(zi, p->z);
    fe_mul(x, p->x, zi);
    fe_mul(y, p->y, zi);
    fe_tobytes(s, y);
    s[31] ^= (uint8_t)(fe_isnegative(x) << 7);
}

extern "C" {

// Verify one signature given the reduced challenge h = SHA512(R‖A‖M) mod L.
// Returns 1 valid / 0 invalid. (s < L and encoding lengths are checked by
// the Python caller, as the JVM wrapper does before the engine call.)
static ge CACHED_B;
static fe CACHED_D, CACHED_D2;
static int b_ready = 0;

static int init_base() {
    // the engine caches the curve constants and base point, as the JVM
    // implementation's parameter spec does
    if (b_ready) return 1;
    init_exponents();
    fe_frombytes(CACHED_D, D_BYTES);
    fe_add(CACHED_D2, CACHED_D, CACHED_D);
    uint8_t by[32];
    memcpy(by, BY_BYTES, 32);
    if (!ge_frombytes(&CACHED_B, by, CACHED_D)) return 0;
    b_ready = 1;
    return 1;
}

int ed25519_verify_core(const uint8_t pk[32], const uint8_t rb[32],
                        const uint8_t sb[32], const uint8_t hb[32]) {
    if (!init_base()) return 0;
    fe d2;
    fe_copy(d2, CACHED_D2);

    ge A, negA, B, bmA, acc, tmp;
    B = CACHED_B;
    if (!ge_frombytes(&A, pk, CACHED_D)) return 0;
    ge_neg(&negA, &A);

    ge_add(&bmA, &B, &negA, d2);
    ge_identity(&acc);
    // joint MSB-first bit ladder: dbl then add {1: B, 2: -A, 3: B-A}
    for (int i = 255; i >= 0; i--) {
        ge_dbl(&tmp, &acc);
        acc = tmp;
        int s_bit = (sb[i >> 3] >> (i & 7)) & 1;
        int h_bit = (hb[i >> 3] >> (i & 7)) & 1;
        if (s_bit && h_bit) { ge_add(&tmp, &acc, &bmA, d2); acc = tmp; }
        else if (s_bit)     { ge_add(&tmp, &acc, &B, d2); acc = tmp; }
        else if (h_bit)     { ge_add(&tmp, &acc, &negA, d2); acc = tmp; }
    }
    uint8_t enc[32];
    ge_tobytes(enc, &acc);
    return memcmp(enc, rb, 32) == 0 ? 1 : 0;
}

// Sequential batch loop — the per-signature shape of the reference's
// TransactionWithSignatures.checkSignaturesAreValid.
int ed25519_verify_loop(const uint8_t *pks, const uint8_t *rs,
                        const uint8_t *ss, const uint8_t *hs, int n,
                        uint8_t *out) {
    int ok = 0;
    for (int i = 0; i < n; i++) {
        out[i] = (uint8_t)ed25519_verify_core(
            pks + 32 * i, rs + 32 * i, ss + 32 * i, hs + 32 * i);
        ok += out[i];
    }
    return ok;
}

} // extern "C"
