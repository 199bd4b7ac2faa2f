// The device state store's row steps (kernels I, J and K), shared by the
// kernels in statestore.cu and by host_check.cpp, which runs them one row
// and one window slot at a time so the CPU tests can hold the kernels' slot
// choice against the reference's table.
//
// A table of S slots: keys (S, 8) int32 (the "<i4" words of a SHA-256),
// txs (S, 8) int32 (a 32-byte payload), tags (S,) int32: 0 empty, odd live,
// 2 a tombstone. A slot is free when its tag's low bit is clear (empty or
// tombstone). A key's owner shard is u32(word 1) mod n_shards and its home
// slot u32(word 2) mod S; its window is the max_probe slots from the home
// slot on, wrapping. The words are reduced as unsigned 32-bit numbers, as
// the reference's astype(uint32) does.
#pragma once

#include <stddef.h>

#include "common.cuh"

#define CT_SS_TOMBSTONE 2

CT_HD uint32_t ct_ss_owner(const int32_t* q, uint32_t n_shards) {
    return (uint32_t)q[1] % n_shards;
}

CT_HD uint32_t ct_ss_home(const int32_t* q, uint32_t slots) {
    return (uint32_t)q[2] % slots;
}

// slot j (0 <= j < max_probe <= slots) of the window from `home`
CT_HD uint32_t ct_ss_window_slot(uint32_t home, uint32_t j, uint32_t slots) {
    uint32_t s = home + j;
    return s >= slots ? s - slots : s;
}

// eight words equal
CT_HD bool ct_ss_row_eq(const int32_t* a, const int32_t* b) {
#if defined(__CUDA_ARCH__)
    int4 a0 = reinterpret_cast<const int4*>(a)[0], a1 = reinterpret_cast<const int4*>(a)[1];
    int4 b0 = reinterpret_cast<const int4*>(b)[0], b1 = reinterpret_cast<const int4*>(b)[1];
    return a0.x == b0.x && a0.y == b0.y && a0.z == b0.z && a0.w == b0.w && a1.x == b1.x &&
           a1.y == b1.y && a1.z == b1.z && a1.w == b1.w;
#else
    for (int w = 0; w < 8; w++)
        if (a[w] != b[w]) return false;
    return true;
#endif
}

CT_HD bool ct_ss_free(const int32_t* tags, uint32_t slot) { return (tags[slot] & 1) == 0; }

// slot holds the live key q
CT_HD bool ct_ss_live_match(const int32_t* keys, const int32_t* tags, uint32_t slot,
                            const int32_t* q) {
    return (tags[slot] & 1) != 0 && ct_ss_row_eq(keys + 8 * (size_t)slot, q);
}

// The insert of one row into its slot.
CT_HD void ct_ss_write_row(int32_t* keys, int32_t* txs, int32_t* tags, uint32_t slot,
                           const int32_t* q, const int32_t* tx, int32_t tag) {
    for (int w = 0; w < 8; w++) {
        keys[8 * (size_t)slot + w] = q[w];
        txs[8 * (size_t)slot + w] = tx[w];
    }
    tags[slot] = tag | 1;
}

// The remove of the row in its slot: a zero key and payload, a tombstone.
CT_HD void ct_ss_tombstone(int32_t* keys, int32_t* txs, int32_t* tags, uint32_t slot) {
    for (int w = 0; w < 8; w++) {
        keys[8 * (size_t)slot + w] = 0;
        txs[8 * (size_t)slot + w] = 0;
    }
    tags[slot] = CT_SS_TOMBSTONE;
}

// Phase 1 of a commit for one row, one window slot at a time (the kernel
// tests 32 slots at once, one a lane): present when a live slot holds the
// key, conflict when such a slot's payload differs from tx.
CT_HD void ct_ss_check_row(const int32_t* keys, const int32_t* txs, const int32_t* tags,
                           uint32_t slots, int max_probe, const int32_t* q, const int32_t* tx,
                           int* present, int* conflict) {
    uint32_t home = ct_ss_home(q, slots);
    *present = 0;
    *conflict = 0;
    for (int j = 0; j < max_probe; j++) {
        uint32_t s = ct_ss_window_slot(home, (uint32_t)j, slots);
        if (ct_ss_live_match(keys, tags, s, q)) {
            *present = 1;
            if (!ct_ss_row_eq(txs + 8 * (size_t)s, tx)) *conflict = 1;
        }
    }
}

// The first free slot of q's window, or -1 (the window overflows).
CT_HD int64_t ct_ss_first_free(const int32_t* tags, uint32_t slots, int max_probe,
                               const int32_t* q) {
    uint32_t home = ct_ss_home(q, slots);
    for (int j = 0; j < max_probe; j++) {
        uint32_t s = ct_ss_window_slot(home, (uint32_t)j, slots);
        if (ct_ss_free(tags, s)) return s;
    }
    return -1;
}

// The first live slot of q's window that holds q, or -1.
CT_HD int64_t ct_ss_first_hit(const int32_t* keys, const int32_t* tags, uint32_t slots,
                              int max_probe, const int32_t* q) {
    uint32_t home = ct_ss_home(q, slots);
    for (int j = 0; j < max_probe; j++) {
        uint32_t s = ct_ss_window_slot(home, (uint32_t)j, slots);
        if (ct_ss_live_match(keys, tags, s, q)) return s;
    }
    return -1;
}

// A request's verdict from its rows' conflicts: any row, or a conflict the
// host found (pre_conflict); force clears it.
CT_HD int ct_ss_request_conflict(const int32_t* conf_row, int k, int32_t pre_conflict,
                                 int32_t force) {
    int32_t c = pre_conflict;
    for (int j = 0; j < k; j++) c += conf_row[j];
    if (force) return 0;
    return c != 0 ? 1 : 0;
}
