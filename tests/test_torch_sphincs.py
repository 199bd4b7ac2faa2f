"""The hash-based scheme (scheme 5) in the port against the reference:

- the port's ``crypto/sphincs.py`` gives the reference's key and signature
  bytes, directly and through the scheme registry;
- the plain version of kernel H (``sphincs_stages_plain``) and the
  kernel's own arithmetic (csrc/sphincs.cuh through host_check's
  ``hc_sphincs_verify``, every stage for every thread in turn) give the
  reference's host helpers' FORS pk and layer roots, stage by stage;
- both give the verdicts of the reference's ``sphincs_verify_batch`` (JAX
  on the CPU, as its own tests run it) on a valid lane and every
  adversarial kind of ``testing.sphincs_adversarial_lanes``;
- the dispatch pads a bucket as the reference's does.

Every comparison is exact (tolerance zero: bytes and verdicts)."""

import hashlib
import shutil

import numpy as np
import pytest
import torch

from corda_tpu.crypto import schemes as ref_schemes
from corda_tpu.crypto import sphincs as ref_sphincs
from corda_tpu.crypto.keys import PrivateKey as RefPrivateKey
from corda_tpu.ops import sphincs_batch as ref_batch
from corda_tpu_torch.crypto import schemes, sphincs
from corda_tpu_torch.crypto.keys import PrivateKey
from corda_tpu_torch.ops import _build
from corda_tpu_torch.ops import sphincs_batch as port_batch
from corda_tpu_torch.testing import sphincs_adversarial_lanes

KINDS = ["valid", "tampered_randomizer", "tampered_index", "tampered_fors_secret",
         "tampered_fors_sibling", "tampered_root", "tampered_pub_seed",
         "tampered_last_fors_sibling", "tampered_wots_chain", "tampered_xmss_sibling",
         "wrong_message", "steered_index", "wrong_key", "wrong_tag", "short_signature",
         "long_signature", "garbage"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain version runs many small integer ops: beside the suite's
    other worker processes a torch thread pool only contends, so these
    tests run torch on one thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def packed(triples, b=None):
    """The dispatch's packed plane of the triples, and its four views."""
    b = b or port_batch.pow2_at_least(len(triples), 8)
    plane = np.zeros(b * port_batch.ROW_BYTES, np.uint8)
    pks, sigs, msgs = map(list, zip(*triples))
    port_batch.pack_plane(plane, pks, sigs, msgs)
    return plane, port_batch.split_plane(torch.from_numpy(plane))


def ref_stages(sig, msg):
    """The FORS pk and each layer's root by the reference's host helpers."""
    n = ref_sphincs.N
    pub_seed, root = sig[-2 * n:-n], sig[-n:]
    fors_dg, idx = ref_sphincs._msg_digest(sig[:n], pub_seed, root, msg)
    off, roots = n + 8, []
    for t, leaf in enumerate(ref_sphincs._fors_indices(fors_dg)):
        node = ref_sphincs._h(b"forsleaf", pub_seed, (ref_sphincs.FORS_LAYER, idx, t, leaf),
                              sig[off:off + n])
        off += n
        pos = leaf
        for lvl in range(ref_sphincs.A):
            sib = sig[off:off + n]
            off += n
            pair = (node, sib) if pos % 2 == 0 else (sib, node)
            node = ref_sphincs._h(b"forsnode", pub_seed,
                                  (ref_sphincs.FORS_LAYER, idx, (t << 8) | (lvl + 1), pos // 2),
                                  *pair)
            pos //= 2
        roots.append(node)
    out = [ref_sphincs._fors_pk_from_roots(roots, pub_seed, idx)]
    tree_idx = idx
    for layer in range(ref_sphincs.D):
        leaf = tree_idx & ((1 << ref_sphincs.HT) - 1)
        tree_idx >>= ref_sphincs.HT
        wots = sig[off:off + ref_sphincs.LEN * n]
        off += ref_sphincs.LEN * n
        pk = ref_sphincs._wots_pk_from_sig(wots, pub_seed, layer, tree_idx, leaf, out[-1])
        auth = [sig[off + n * i:off + n * (i + 1)] for i in range(ref_sphincs.HT)]
        off += ref_sphincs.HT * n
        out.append(ref_sphincs._xmss_root_from_auth(pk, auth, pub_seed, layer, tree_idx, leaf))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_keys_and_signatures_are_the_references_bytes(seed):
    entropy = hashlib.sha256(b"port sphincs %d" % seed).digest()
    kp = schemes.derive_keypair_from_entropy(5, entropy)
    ref_kp = ref_schemes.derive_keypair_from_entropy(5, entropy)
    assert kp.public.encoded == ref_kp.public.encoded
    assert kp.private.encoded == ref_kp.private.encoded
    msg = b"message %d" % seed
    sig = schemes.sign(kp.private, msg)
    assert sig == ref_schemes.sign(RefPrivateKey(5, ref_kp.private.encoded), msg)
    assert len(sig) == sphincs.SIG_LEN == ref_sphincs.SIG_LEN == 13480
    assert sphincs.generate(bytes([seed]) * 32) == ref_sphincs.generate(bytes([seed]) * 32)
    assert schemes.is_valid(kp.public, sig, msg)
    assert not schemes.is_valid(kp.public, sig, msg + b"x")
    assert schemes.public_key_on_curve(kp.public)


def test_generated_keypair_signs_and_verifies():
    kp = schemes.generate_keypair(5)
    sig = schemes.sign(PrivateKey(5, kp.private.encoded), b"m")
    assert sphincs.verify(kp.public.encoded, sig, b"m")
    assert ref_sphincs.verify(kp.public.encoded, sig, b"m")


@pytest.fixture(scope="module")
def valid_lanes():
    out = []
    for k in range(3):
        kp = schemes.derive_keypair_from_entropy(5, hashlib.sha256(b"stage %d" % k).digest())
        msg = b"stage message %d" % k
        out.append((kp.public.encoded, schemes.sign(kp.private, msg), msg))
    return out


@pytest.fixture(scope="module")
def plain_stages(valid_lanes):
    _plane, (sigs, dgs, idxs, _pre) = packed(valid_lanes)
    return port_batch.sphincs_stages_plain(sigs, dgs, idxs)


@pytest.fixture(scope="module")
def hc_stages(valid_lanes):
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    plane, (sigs, dgs, idxs, pre) = packed(valid_lanes)
    b = sigs.shape[0]
    out = np.zeros(b, np.uint8)
    stages = np.zeros((b, 5, 32), np.uint8)
    _build.host_check().hc_sphincs_verify(
        sigs.numpy().ctypes.data, dgs.numpy().ctypes.data, idxs.numpy().ctypes.data,
        pre.numpy().ctypes.data, b, out.ctypes.data, stages.ctypes.data)
    return out, stages


@pytest.mark.parametrize("lane", [0, 1, 2])
def test_plain_stages_equal_reference_host_helpers(valid_lanes, plain_stages, lane):
    want = ref_stages(valid_lanes[lane][1], valid_lanes[lane][2])
    assert [bytes(s[lane].numpy()) for s in plain_stages] == want
    assert want[-1] == valid_lanes[lane][1][-32:]  # the top root is the claimed one


@pytest.mark.parametrize("lane", [0, 1, 2])
def test_kernel_arithmetic_stages_equal_reference_host_helpers(valid_lanes, hc_stages, lane):
    out, stages = hc_stages
    want = ref_stages(valid_lanes[lane][1], valid_lanes[lane][2])
    assert [bytes(stages[lane, k]) for k in range(5)] == want
    assert out[lane] == 1
    assert not out[len(valid_lanes):].any()  # pad lanes fail the precheck


def test_lane_work_from_plain_stages(valid_lanes, plain_stages):
    """Phase 16's bound and serial floor (``chip_smoke.sphincs_lane_work``):
    a lane's blocks follow from the digits of the digests its layers sign,
    read from the plain version's stages (steps k >= digit only)."""
    import chip_smoke

    for lane, (_pk, sig, msg) in enumerate(valid_lanes):
        signed = ref_stages(sig, msg)[:4]
        assert [bytes(s[lane].numpy()) for s in plain_stages[:4]] == signed
        blocks, chain = chip_smoke.sphincs_lane_work(signed)
        steps = sum(15 - d for dg in signed for d in ref_sphincs._digits(dg))
        assert blocks == 14 * 26 + 9 + 2 * steps + 4 * (35 + 18)
        longest = sum(15 - min(ref_sphincs._digits(dg)) for dg in signed)
        assert chain == 26 + 9 + 2 * longest + 4 * (35 + 18)


@pytest.fixture(scope="module")
def lanes():
    out = sphincs_adversarial_lanes(1)
    assert [kind for kind, *_ in out] == KINDS
    return out


@pytest.fixture(scope="module")
def lane_triples(lanes):
    return [(pk, sig, msg) for _k, pk, sig, msg in lanes]


@pytest.fixture(scope="module")
def reference_verdicts(lane_triples):
    pks, sigs, msgs = map(list, zip(*lane_triples))
    got = ref_batch.sphincs_verify_batch(pks, sigs, msgs)
    host = [ref_sphincs.verify(*t) for t in lane_triples]
    assert got.tolist() == host
    return got.tolist()


@pytest.fixture(scope="module")
def plain_verdicts(lane_triples):
    return port_batch.sphincs_verify_batch(*map(list, zip(*lane_triples)), device="cpu").tolist()


@pytest.fixture(scope="module")
def hc_verdicts(lane_triples):
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    _plane, (sigs, dgs, idxs, pre) = packed(lane_triples)
    b = sigs.shape[0]
    out = np.zeros(b, np.uint8)
    _build.host_check().hc_sphincs_verify(
        sigs.numpy().ctypes.data, dgs.numpy().ctypes.data, idxs.numpy().ctypes.data,
        pre.numpy().ctypes.data, b, out.ctypes.data, None)
    assert not out[len(lane_triples):].any()
    return out[: len(lane_triples)].astype(bool).tolist()


@pytest.mark.parametrize("kind", KINDS)
def test_plain_version_matches_reference_batch(kind, reference_verdicts, plain_verdicts):
    i = KINDS.index(kind)
    assert plain_verdicts[i] == reference_verdicts[i] == (kind == "valid")


@pytest.mark.parametrize("kind", KINDS)
def test_kernel_arithmetic_matches_reference_batch(kind, reference_verdicts, hc_verdicts):
    i = KINDS.index(kind)
    assert hc_verdicts[i] == reference_verdicts[i] == (kind == "valid")


@pytest.mark.parametrize("n", [1, 8, 9, 33])
@pytest.mark.parametrize("min_bucket", [None, 4, 1024])
def test_pad_bucket_matches_reference(n, min_bucket, lanes, monkeypatch):
    """The padded lane count of the two dispatches (each with its device
    half stubbed out: only the bucket is compared here)."""
    import jax.numpy as jnp

    monkeypatch.setattr(ref_batch, "_sphincs_pipeline",
                        lambda *planes: jnp.zeros(planes[-1].shape, bool))
    monkeypatch.setattr(port_batch, "sphincs_verify",
                        lambda sigs, dgs, idx, pre: torch.zeros_like(pre))
    pk, sig, msg = lanes[0][1:]
    args = ([pk] * n, [sig] * n, [msg] * n)
    want = ref_batch.sphincs_verify_dispatch(*args, min_bucket=min_bucket).shape[0]
    got = port_batch.sphincs_verify_dispatch(*args, min_bucket=min_bucket, device="cpu")
    assert got.shape[0] == want


def test_dispatch_pad_lanes_fail(lanes):
    pk, sig, msg = lanes[0][1:]
    mask = port_batch.sphincs_verify_dispatch([pk], [sig], [msg], device="cpu")
    assert mask.shape[0] == 8 and mask.tolist() == [True] + [False] * 7
    assert port_batch.sphincs_verify_batch([], [], [], device="cpu").shape == (0,)


def test_wrapper_checks_its_planes(lanes):
    _plane, (sigs, dgs, idxs, pre) = packed([lanes[0][1:]])
    with pytest.raises(ValueError, match="idx"):
        port_batch.sphincs_verify(sigs, dgs, idxs.to(torch.int32), pre)
    with pytest.raises(ValueError, match="sigs"):
        port_batch.sphincs_verify(sigs[:, :-1].contiguous(), dgs, idxs, pre)


@pytest.mark.device
def test_kernel_h_matches_plain_version_on_the_card(lane_triples):
    """Kernel H against its plain version on the card, every adversarial
    kind (skips without CUDA; ``python3 chip_smoke.py`` runs the full
    check)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _plane, views = packed(lane_triples)
    on_card = [v.cuda() for v in views]
    assert torch.equal(port_batch.sphincs_verify(*on_card).cpu(),
                       port_batch.sphincs_verify_plain(*views))


# ------------------------------------- kernel H's word-level arithmetic

import struct  # noqa: E402

TAGS = {0: b"forsleaf", 1: b"forsnode", 2: b"forspk", 3: b"ch", 4: b"wotspk", 5: b"node"}
DATA_BYTES = {0: 32, 1: 64, 2: 14 * 32, 3: 32, 4: 67 * 32, 5: 64}
HOISTED_FROM = {0: 13, 1: 13, 2: 14, 3: 13, 4: 14, 5: 14}


@pytest.fixture(scope="module")
def host_lib():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    return _build.host_check()


def message_case(kind, draw):
    """A seeded random (seed, address, data) for a message of ``kind``,
    with the address fields its callers give: a FORS node's leaf field is
    (tree << 8) | level, a chain step's j is (chain << 8) | step."""
    rng = np.random.default_rng(1000 * kind + draw)
    seed = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
    data = rng.integers(0, 256, DATA_BYTES[kind], dtype=np.uint8).tobytes()
    layer = 0xFF if kind in (0, 1, 2) else int(rng.integers(0, 4))
    tree = int(rng.integers(0, 1 << 24)) >> (6 * (draw % 4))
    leaf = {0: int(rng.integers(0, 14)), 1: (int(rng.integers(0, 14)) << 8) | (draw % 8 + 1),
            2: 0, 3: int(rng.integers(0, 64)), 4: int(rng.integers(0, 64)),
            5: draw % 6 + 1}[kind]
    j = {0: int(rng.integers(0, 256)), 1: int(rng.integers(0, 128)), 2: 0,
         3: (int(rng.integers(0, 67)) << 8) | int(rng.integers(0, 15)), 4: 0,
         5: int(rng.integers(0, 32))}[kind]
    return seed, (layer, tree, leaf, j), data


@pytest.mark.parametrize("kind,mode", [(k, m) for k in range(6) for m in (0, 1)] + [(5, 2)])
def test_message_words_equal_hashlib(host_lib, kind, mode):
    """Each of kernel H's six message kinds, its blocks assembled as words
    (csrc/sphincs.cuh), equals hashlib.sha256 of the message bytes and the
    reference's addressed hash: from the IV (mode 0), from the hoisted
    state of the rounds that read only words known at launch (mode 1), and
    for the auth node from its first block's chaining value (mode 2, an odd
    position's hoist)."""
    for draw in range(8):
        seed, addr, data = message_case(kind, draw)
        msg = TAGS[kind] + seed + struct.pack(">IQII", *addr) + data
        want = hashlib.sha256(msg).digest()
        assert want == ref_sphincs._h(TAGS[kind], seed, addr, data)
        words = np.array([addr[0], addr[1] >> 32, addr[1] & 0xFFFFFFFF, addr[2], addr[3]],
                         np.uint32)
        out = np.zeros(32, np.uint8)
        host_lib.hc_sp_message(kind, seed, words.ctypes.data, data, mode, out.ctypes.data)
        assert out.tobytes() == want, (kind, mode, draw, len(msg))


def ref_stages_of(sig, fors_dg, idx):
    """The FORS pk and each layer's root by the reference's host helpers,
    from a signature row's bytes, a FORS digest and an index of any value
    (the message does not enter)."""
    n = ref_sphincs.N
    pub_seed = sig[-2 * n:-n]
    off, roots = n + 8, []
    for t, leaf in enumerate(ref_sphincs._fors_indices(fors_dg)):
        node = ref_sphincs._h(b"forsleaf", pub_seed, (ref_sphincs.FORS_LAYER, idx, t, leaf),
                              sig[off:off + n])
        off += n
        pos = leaf
        for lvl in range(ref_sphincs.A):
            sib = sig[off:off + n]
            off += n
            pair = (node, sib) if pos % 2 == 0 else (sib, node)
            node = ref_sphincs._h(b"forsnode", pub_seed,
                                  (ref_sphincs.FORS_LAYER, idx, (t << 8) | (lvl + 1), pos // 2),
                                  *pair)
            pos //= 2
        roots.append(node)
    out = [ref_sphincs._fors_pk_from_roots(roots, pub_seed, idx)]
    for layer in range(ref_sphincs.D):
        out.append(ref_layer_root(sig, idx, layer, out[-1]))
    return out


def ref_layer_root(sig, idx, layer, digest):
    n, ht = ref_sphincs.N, ref_sphincs.HT
    off = n + 8 + ref_sphincs.K * n * (1 + ref_sphincs.A) + layer * n * (ref_sphincs.LEN + ht)
    tree, leaf = idx >> (ht * (layer + 1)), (idx >> (ht * layer)) & ((1 << ht) - 1)
    pub_seed = sig[-2 * n:-n]
    pk = ref_sphincs._wots_pk_from_sig(sig[off:off + ref_sphincs.LEN * n], pub_seed, layer,
                                       tree, leaf, digest)
    off += ref_sphincs.LEN * n
    auth = [sig[off + n * i:off + n * (i + 1)] for i in range(ht)]
    return ref_sphincs._xmss_root_from_auth(pk, auth, pub_seed, layer, tree, leaf)


def random_row(seed):
    return np.random.default_rng(seed).integers(0, 256, ref_sphincs.SIG_LEN,
                                                dtype=np.uint8).tobytes()


# digests whose digits force every message chain to 15 steps (0x00) or
# none (0xff, then the 3 checksum chains run 15), and mixes
DIGESTS = {"zeros": bytes(32), "ones": b"\xff" * 32, "lo_nibbles": b"\x0f" * 32,
           "hi_nibbles": b"\xf0" * 32, "mixed": bytes(range(0, 256, 8))}
# a layer's leaf: every auth level even (0), odd (63), or alternating
LEAVES = {"even": 0, "odd": 63, "odd_even": 0b101010, "even_odd": 0b010101}


@pytest.mark.parametrize("leaf", list(LEAVES))
@pytest.mark.parametrize("digest", list(DIGESTS))
def test_layer_forced_digits_and_positions(host_lib, digest, leaf):
    """One layer of kernel H's arithmetic (its chains from the hoisted
    state, the WOTS pk and the auth path on the pair's halves) against the
    reference's WOTS and XMSS helpers, at digits that force chains of 0
    and 15 steps and at odd and even positions on every auth level."""
    k = list(DIGESTS).index(digest) * len(LEAVES) + list(LEAVES).index(leaf)
    layer = k % 4
    rng = np.random.default_rng(k)
    idx = int(rng.integers(0, 1 << 24))
    idx = (idx & ~(63 << (6 * layer))) | (LEAVES[leaf] << (6 * layer))
    sig = random_row(100 + k)
    out = np.zeros(32, np.uint8)
    host_lib.hc_sphincs_layer(sig, idx, layer, DIGESTS[digest], out.ctypes.data)
    assert out.tobytes() == ref_layer_root(sig, idx, layer, DIGESTS[digest])


@pytest.mark.parametrize("fors_dg", ["even", "odd", "alternating", "random"])
def test_fors_forced_positions(host_lib, fors_dg):
    """Kernel H's stages on a random row with FORS leaves at even (0x00)
    and odd (0xff) positions on every level, alternating (0x55 and 0xaa)
    and random, against the reference's helpers stage by stage."""
    dg = {"even": bytes(32), "odd": b"\xff" * 32, "alternating": b"\x55\xaa" * 16,
          "random": random_row(7)[:32]}[fors_dg]
    sig = random_row(200 + len(fors_dg))
    idx = 0x5A5A5A
    idxs, pre = np.array([idx], np.int64), np.ones(1, np.uint8)
    out = np.zeros(1, np.uint8)
    stages = np.zeros((1, 5, 32), np.uint8)
    host_lib.hc_sphincs_verify(sig, dg, idxs.ctypes.data, pre.ctypes.data, 1, out.ctypes.data,
                               stages.ctypes.data)
    assert [bytes(s) for s in stages[0]] == ref_stages_of(sig, dg, idx)
    assert out[0] == 0  # a random row's root is not the claimed one


def test_chain_ops_from_plain_stages(valid_lanes, plain_stages, packed_valid_idx):
    """Phase 16's serial floor of the redesigned kernel H
    (``chip_smoke.sphincs_chain_ops``): the FORS tree and pk on the pair's
    consumer, each layer's longest chain on one thread, the WOTS pk and the
    auth path on the consumer, hoisted rounds and blocks left out."""
    import chip_smoke

    for lane, (_pk, sig, msg) in enumerate(valid_lanes):
        signed = [bytes(s[lane].numpy()) for s in plain_stages[:4]]
        idx = packed_valid_idx[lane]
        want = (722 + 904) + 8 * (722 + 2 * 904) + 708 + 8 * 904
        for layer, dg in enumerate(signed):
            leaf = (idx >> (6 * layer)) & 63
            want += (15 - min(ref_sphincs._digits(dg))) * (722 + 480 + 1384) + 708 + 34 * 904
            want += sum(2 * 904 if (leaf >> lvl) & 1 else 708 + 2 * 904 for lvl in range(6))
        assert chip_smoke.sphincs_chain_ops(signed, idx) == want


@pytest.fixture(scope="module")
def packed_valid_idx(valid_lanes):
    _plane, (_sigs, _dgs, idxs, _pre) = packed(valid_lanes)
    return [int(i) for i in idxs.tolist()]
