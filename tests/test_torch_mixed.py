"""The mixed-scheme slice as a whole on the CPU: ed25519, secp256k1 and
secp256r1 rows in one batch through the port's ``dispatch_signature_rows``
(one bucket a scheme, each on its plain version) and its
``DeviceScheduler`` (device="cpu"), against the reference's
``dispatch_signature_rows(rows, use_device=False)`` (its host oracles,
OpenSSL for ECDSA); the reference's padding rule; the buckets' settling
order; SPHINCS and RSA rows still refused."""

import random

import numpy as np
import pytest
import torch

pytest.importorskip("cryptography")  # the reference's ECDSA oracle is OpenSSL

from corda_tpu.crypto.keys import PublicKey as RefPublicKey
from corda_tpu.ops._blockpack import pow2_at_least as ref_pow2_at_least
from corda_tpu.verifier.batch import dispatch_signature_rows as ref_dispatch
from corda_tpu_torch.crypto import PublicKey, is_valid
from corda_tpu_torch.ops._blockpack import HostCopy
from corda_tpu_torch.serving import BULK, INTERACTIVE, SERVICE, DeviceScheduler
from corda_tpu_torch.testing import (
    MIXED_COMPOSITION,
    adversarial_lanes,
    ecdsa_adversarial_lanes,
    mixed_rows,
)
from corda_tpu_torch.verifier import dispatch_signature_rows
from corda_tpu_torch.verifier.batch import PendingRows

# the ECDSA kinds of the 48-row batch (8 a curve)
ECDSA_KINDS = ("valid", "valid_uncompressed", "second_candidate", "high_s_twin",
               "flipped_r_bit", "wrong_key", "key_x_ge_p", "other_curve_key")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run many small integer ops: beside the suite's
    other worker processes a torch thread pool only contends, so these
    tests run torch on one thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def rows():
    """48 rows: 32 ed25519 (every ed25519 adversarial kind, the rest
    valid mixed rows) and 8 a curve of ECDSA adversarial kinds, shuffled."""
    ed = [(PublicKey(4, pk), s, m) for _k, pk, s, m in adversarial_lanes(0)]
    ed += mixed_rows((("eddsa", 32 - len(ed)),), keys_per_scheme=4, device="cpu")
    ecdsa = []
    for sid, name in ((2, "secp256k1"), (3, "secp256r1")):
        lanes = {k: (pk, s, m) for k, pk, s, m in ecdsa_adversarial_lanes(name, seed=21)}
        ecdsa += [(PublicKey(sid, lanes[k][0]), *lanes[k][1:]) for k in ECDSA_KINDS]
    out = ed + ecdsa
    random.Random(7).shuffle(out)
    assert len(out) == 48
    return out


def ref_rows(rows):
    return [(RefPublicKey(k.scheme_id, k.encoded), s, m) for k, s, m in rows]


@pytest.fixture(scope="module")
def reference_mask(rows):
    return ref_dispatch(ref_rows(rows), use_device=False).collect()


def test_dispatch_matches_reference(rows, reference_mask):
    want = reference_mask.tolist()
    for sid in (2, 3, 4):  # every scheme has rows accepted and rejected
        assert {w for (k, _s, _m), w in zip(rows, want) if k.scheme_id == sid} == {True, False}
    pending = dispatch_signature_rows(rows, device="cpu")
    assert pending.collect().tolist() == want
    assert pending.device_rows == 48 and pending.device_mask.all()
    host = dispatch_signature_rows(rows, use_device=False)
    assert host.collect().tolist() == want and host.device_rows == 0
    assert [is_valid(k, s, m) for k, s, m in rows] == want


@pytest.mark.parametrize("min_bucket", [None, 16, 64])
def test_padded_lanes_follow_reference_rule(rows, min_bucket):
    """One bucket a scheme, each padded to pow2_at_least(n, max(min_bucket,
    8)), the reference's rule off its TPU."""
    sub = rows[:40]
    counts = {}
    for key, _s, _m in sub:
        counts[key.scheme_id] = counts.get(key.scheme_id, 0) + 1
    pending = dispatch_signature_rows(sub, min_bucket=min_bucket, device="cpu")
    assert len(pending._deferred) == len(counts) == 3
    assert pending.padded_lanes == sum(
        ref_pow2_at_least(c, max(min_bucket or 0, 8)) for c in counts.values())


def test_scheduler_serves_the_mixed_batch(rows, reference_mask):
    """The 48 rows as requests of 1-12 rows across the three classes,
    coalesced into mixed batches: every request's verdicts equal the
    reference's, all on the device path."""
    sizes = [5, 1, 12, 3, 9, 2, 8, 4, 4]
    assert sum(sizes) == 48
    sched = DeviceScheduler(device="cpu")
    try:
        sched.pause()
        futures, at = [], 0
        for k, size in enumerate(sizes):
            futures.append((at, size, sched.submit_rows(
                rows[at : at + size], priority=(BULK, SERVICE, INTERACTIVE)[k % 3])))
            at += size
        sched.resume()
        for at, size, fut in futures:
            rr = fut.result(timeout=300)
            assert rr.mask.tolist() == reference_mask[at : at + size].tolist()
            assert rr.n_device == size
        assert sched.counters["serving.rows"] == 48
        assert sched.counters["serving.device_rows"] == 48
        assert sched.counters["serving.padded_lanes"] >= 48
    finally:
        sched.shutdown()


class _Event:
    def __init__(self, log, name, ready):
        self.log, self.name, self.ready = log, name, ready

    def query(self):
        return self.ready

    def synchronize(self):
        self.log.append(self.name)


def test_mixed_buckets_settle_in_completion_order():
    """A batch's buckets settle in the order their copies complete: the
    ECDSA buckets that landed first are read before the ed25519 bucket
    that is still on the card."""
    log = []
    pending = PendingRows(6)
    for name, idxs, ready, verdicts in (("ed25519", [0, 3], False, [True, False]),
                                        ("secp256k1", [1, 4], True, [False, True]),
                                        ("secp256r1", [2, 5], True, [True, True])):
        handle = HostCopy(torch.tensor(verdicts + [False] * 6), _Event(log, name, ready))
        pending._deferred.append((idxs, handle))
    assert not pending.ready()
    mask = pending.collect()
    assert log == ["secp256k1", "secp256r1", "ed25519"]
    assert mask.tolist() == [True, False, True, False, True, True]


@pytest.mark.parametrize("scheme,item", [(5, "Queue 1 item 10"), (1, "Queue 1 item 13")],
                         ids=["sphincs", "rsa"])
def test_sphincs_and_rsa_rows_still_raise(rows, scheme, item):
    bad = rows[:3] + [(PublicKey(scheme, b"\x01" * 33), b"sig", b"msg")]
    with pytest.raises(NotImplementedError, match=item):
        dispatch_signature_rows(bad, device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        dispatch_signature_rows(bad, use_device=False)
    sched = DeviceScheduler(device="cpu")
    try:
        with pytest.raises(NotImplementedError, match=item):
            sched.submit_rows(bad)
    finally:
        sched.shutdown()


def test_mixed_rows_composition():
    """The workload's shape: the composition's counts a scheme, keys
    round robin, messages as in bench.py, shuffled with Random(7), tiled."""
    comp = (("eddsa", 6), ("secp256k1", 3), ("secp256r1", 3))
    base = mixed_rows(comp, keys_per_scheme=2, device="cpu")
    tiled = mixed_rows(comp, keys_per_scheme=2, tile=3, device="cpu")
    assert len(base) == 12 and len(tiled) == 36
    by_scheme = {}
    for key, _s, msg in base:
        by_scheme.setdefault(key.scheme_id, set()).add(key)
        assert msg[:4] == b"CTMX" and len(msg) == 36
    assert {k: len(v) for k, v in by_scheme.items()} == {4: 2, 2: 2, 3: 2}
    assert sorted(map(repr, base * 3)) == sorted(map(repr, tiled))
    assert all(is_valid(k, s, m) for k, s, m in base)
    assert [name for name, _n in MIXED_COMPOSITION] == ["eddsa", "secp256k1", "secp256r1"]
    assert np.array_equal(
        ref_dispatch(ref_rows(base), use_device=False).collect(), np.ones(12, bool))
