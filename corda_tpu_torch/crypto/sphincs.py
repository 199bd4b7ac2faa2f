"""Hash-based signature scheme, scheme id 5 (copy of corda_tpu/crypto/sphincs.py).

A SPHINCS+-shaped construction over SHA-256 with the reference's
parameters (n=32, W=16, H=24, D=4, K=14, A=8): a FORS few-time signature
of the message digest under the hypertree instance the digest selects,
then D layers of XMSS trees whose WOTS+ leaves sign the root below, the
top root committed to by the 33-byte public key. Every hash is addressed
(``>IQII``: layer, tree, leaf, j) and keyed by the public seed. Keys and
signatures are the reference's bytes: the same seed gives the same key,
and the same key and message the same signature.

This is the host engine (keys, signing, the oracle). Batched verification
on the card is ``ops/sphincs_batch.py`` (kernel H).
"""

from __future__ import annotations

import hashlib
import struct

N = 32              # hash output bytes
W = 16              # Winternitz parameter
LEN1 = 64           # 256-bit digest, 4 bits/digit
LEN2 = 3            # checksum digits (max 64*15 = 960 < 16^3)
LEN = LEN1 + LEN2   # 67 WOTS chains
H = 24              # total hypertree height
D = 4               # hypertree layers
HT = H // D         # XMSS subtree height (6)
K = 14              # FORS trees
A = 8               # FORS tree height (2^A leaves each)

FORS_LAYER = 0xFF   # address-layer tag for FORS hashes


def _h(tag: bytes, pub_seed: bytes, addr: tuple, *parts: bytes) -> bytes:
    """Addressed, keyed hash: every call site is domain-separated by its
    position in the structure (SPHINCS+ 'tweakable hash')."""
    ctx = hashlib.sha256()
    ctx.update(tag)
    ctx.update(pub_seed)
    ctx.update(struct.pack(">IQII", *addr))
    for p in parts:
        ctx.update(p)
    return ctx.digest()


def _prf(seed: bytes, addr_bytes: bytes) -> bytes:
    return hashlib.sha256(b"sphincs.prf" + seed + addr_bytes).digest()


# ------------------------------------------------------------------- WOTS

def _wots_sk(seed: bytes, layer: int, tree: int, leaf: int, j: int) -> bytes:
    return _prf(seed, struct.pack(">IQII", layer, tree, leaf, j))


def _chain(x: bytes, pub_seed: bytes, layer: int, tree: int, leaf: int,
           j: int, start: int, steps: int) -> bytes:
    for k in range(start, start + steps):
        x = _h(b"ch", pub_seed, (layer, tree, leaf, (j << 8) | k), x)
    return x


def _digits(digest: bytes) -> list[int]:
    out = []
    for byte in digest:
        out.append(byte >> 4)
        out.append(byte & 0xF)
    checksum = sum((W - 1) - d for d in out)
    for _ in range(LEN2):
        out.append(checksum & 0xF)
        checksum >>= 4
    return out


def _wots_pk(seed, pub_seed, layer, tree, leaf) -> bytes:
    tips = [
        _chain(_wots_sk(seed, layer, tree, leaf, j), pub_seed,
               layer, tree, leaf, j, 0, W - 1)
        for j in range(LEN)
    ]
    return _h(b"wotspk", pub_seed, (layer, tree, leaf, 0), *tips)


def _wots_sign(seed, pub_seed, layer, tree, leaf, digest: bytes) -> bytes:
    digs = _digits(digest)
    return b"".join(
        _chain(_wots_sk(seed, layer, tree, leaf, j), pub_seed,
               layer, tree, leaf, j, 0, digs[j])
        for j in range(LEN)
    )


def _wots_pk_from_sig(sig: bytes, pub_seed, layer, tree, leaf,
                      digest: bytes) -> bytes:
    digs = _digits(digest)
    tips = [
        _chain(sig[j * N:(j + 1) * N], pub_seed, layer, tree, leaf, j,
               digs[j], (W - 1) - digs[j])
        for j in range(LEN)
    ]
    return _h(b"wotspk", pub_seed, (layer, tree, leaf, 0), *tips)


# ------------------------------------------------------------------- XMSS

def _xmss_levels(seed, pub_seed, layer, tree) -> list[list[bytes]]:
    row = [_wots_pk(seed, pub_seed, layer, tree, i) for i in range(1 << HT)]
    levels = [row]
    lvl = 1
    while len(row) > 1:
        row = [
            _h(b"node", pub_seed, (layer, tree, lvl, i // 2),
               row[i], row[i + 1])
            for i in range(0, len(row), 2)
        ]
        levels.append(row)
        lvl += 1
    return levels


def _xmss_root_from_auth(node, auth, pub_seed, layer, tree, leaf) -> bytes:
    idx = leaf
    for lvl, sib in enumerate(auth, start=1):
        if idx % 2 == 0:
            node = _h(b"node", pub_seed, (layer, tree, lvl, idx // 2),
                      node, sib)
        else:
            node = _h(b"node", pub_seed, (layer, tree, lvl, idx // 2),
                      sib, node)
        idx //= 2
    return node


# ------------------------------------------------------------------- FORS

def _fors_leaf_sk(seed, instance: int, tree: int, leaf: int) -> bytes:
    return _prf(seed, struct.pack(">IQII", FORS_LAYER, instance, tree, leaf))


def _fors_levels(seed, pub_seed, instance, tree) -> list[list[bytes]]:
    row = [
        _h(b"forsleaf", pub_seed, (FORS_LAYER, instance, tree, i),
           _fors_leaf_sk(seed, instance, tree, i))
        for i in range(1 << A)
    ]
    levels = [row]
    lvl = 1
    while len(row) > 1:
        row = [
            _h(b"forsnode", pub_seed,
               (FORS_LAYER, instance, (tree << 8) | lvl, i // 2),
               row[i], row[i + 1])
            for i in range(0, len(row), 2)
        ]
        levels.append(row)
        lvl += 1
    return levels


def _fors_indices(digest: bytes) -> list[int]:
    """K indices of A bits each from the message digest."""
    bits = int.from_bytes(digest, "big")
    out = []
    for i in range(K):
        out.append((bits >> (i * A)) & ((1 << A) - 1))
    return out


def _fors_pk_from_roots(roots, pub_seed, instance) -> bytes:
    return _h(b"forspk", pub_seed, (FORS_LAYER, instance, 0, 0), *roots)


# ------------------------------------------------------------------ scheme

def generate(seed: bytes) -> tuple[bytes, bytes]:
    """Returns (public_encoded, private_encoded). Public = pub_seed ‖ top
    root (+ scheme tag byte so encodings stay 33B like the r1 format)."""
    pub_seed = hashlib.sha256(b"sphincs.pubseed" + seed).digest()
    top_tree = _xmss_levels(seed, pub_seed, D - 1, 0)
    root = top_tree[-1][0]
    pub = b"\x02" + hashlib.sha256(pub_seed + root).digest()
    # the private encoding carries everything needed to re-derive
    priv = seed + pub_seed + root
    return pub, priv


def _split_priv(private_encoded: bytes):
    return (
        private_encoded[:32],
        private_encoded[32:64],
        private_encoded[64:96],
    )


def _msg_digest(randomizer, pub_seed, root, message):
    """(FORS digest, hypertree leaf index) from the randomized hash."""
    dg = hashlib.sha256(
        b"sphincs.msg" + randomizer + pub_seed + root + message
    ).digest()
    idx = int.from_bytes(dg[:8], "big") % (1 << H)
    fors_dg = hashlib.sha256(b"sphincs.fors" + dg).digest()
    return fors_dg, idx


def sign(private_encoded: bytes, message: bytes) -> bytes:
    seed, pub_seed, root = _split_priv(private_encoded)
    randomizer = _prf(seed, b"rand" + hashlib.sha256(message).digest())
    fors_dg, idx = _msg_digest(randomizer, pub_seed, root, message)

    out = [randomizer, struct.pack(">Q", idx)]

    # FORS signature under hypertree instance ``idx``
    indices = _fors_indices(fors_dg)
    roots = []
    for t, leaf in enumerate(indices):
        levels = _fors_levels(seed, pub_seed, idx, t)
        out.append(_fors_leaf_sk(seed, idx, t, leaf))
        pos = leaf
        for lvl in range(A):
            out.append(levels[lvl][pos ^ 1])
            pos //= 2
        roots.append(levels[-1][0])
    node = _fors_pk_from_roots(roots, pub_seed, idx)

    # hypertree: each layer's WOTS leaf signs the node below
    tree_idx = idx
    for layer in range(D):
        leaf = tree_idx & ((1 << HT) - 1)
        tree_idx >>= HT
        levels = _xmss_levels(seed, pub_seed, layer, tree_idx)
        out.append(_wots_sign(seed, pub_seed, layer, tree_idx, leaf, node))
        pos = leaf
        for lvl in range(HT):
            out.append(levels[lvl][pos ^ 1])
            pos //= 2
        node = levels[-1][0]
    # the public key is a 32-byte COMMITMENT to (pub_seed, root); the
    # signature transports both openly and verification checks the
    # commitment (keeps the wire public-key at the compact 33B the
    # registry uses; hash-based security is unaffected — the pair is
    # public data)
    out.append(pub_seed)
    out.append(root)
    return b"".join(out)


# randomizer ‖ idx ‖ FORS ‖ hypertree ‖ pub_seed ‖ root
SIG_LEN = N + 8 + K * (N + A * N) + D * (LEN * N + HT * N) + 2 * N


def verify(public_encoded: bytes, signature: bytes, message: bytes) -> bool:
    try:
        if len(public_encoded) != 33 or public_encoded[0] != 0x02:
            return False
        if len(signature) != SIG_LEN:
            return False
        return _verify_inner(public_encoded, signature, message)
    except Exception:
        return False


def _verify_inner(public_encoded, signature, message) -> bool:
    randomizer = signature[:N]
    (idx,) = struct.unpack(">Q", signature[N:N + 8])
    if idx >= 1 << H:
        return False
    pub_seed = signature[-2 * N:-N]
    root = signature[-N:]
    if hashlib.sha256(pub_seed + root).digest() != public_encoded[1:]:
        return False
    fors_dg, expect_idx = _msg_digest(randomizer, pub_seed, root, message)
    if idx != expect_idx:
        return False
    off = N + 8

    indices = _fors_indices(fors_dg)
    roots = []
    for t, leaf in enumerate(indices):
        sk = signature[off:off + N]
        off += N
        node = _h(b"forsleaf", pub_seed, (FORS_LAYER, idx, t, leaf), sk)
        pos = leaf
        for lvl in range(A):
            sib = signature[off:off + N]
            off += N
            pair = (node, sib) if pos % 2 == 0 else (sib, node)
            node = _h(b"forsnode", pub_seed,
                      (FORS_LAYER, idx, (t << 8) | (lvl + 1), pos // 2),
                      *pair)
            pos //= 2
        roots.append(node)
    node = _fors_pk_from_roots(roots, pub_seed, idx)

    tree_idx = idx
    for layer in range(D):
        leaf = tree_idx & ((1 << HT) - 1)
        tree_idx >>= HT
        wots_sig = signature[off:off + LEN * N]
        off += LEN * N
        leaf_pk = _wots_pk_from_sig(
            wots_sig, pub_seed, layer, tree_idx, leaf, node
        )
        auth = []
        for _ in range(HT):
            auth.append(signature[off:off + N])
            off += N
        node = _xmss_root_from_auth(
            leaf_pk, auth, pub_seed, layer, tree_idx, leaf
        )
    return node == root
