"""The port's batched ed25519 verify (corda_tpu_torch/ops/ed25519.py) against
the reference's ``ed25519_verify_batch`` on the CPU, on both routes, with
every adversarial lane; the carried-over constants (interop.py); the entry
twin; the staging pool; the device default.

Verdict masks compare exactly. The reference runs its CPU tier (host hash,
XLA ladder); the port runs its plain versions (``device="cpu"``)."""

import json
import os

import numpy as np
import pytest
import torch

from corda_tpu.ops import ed25519_pallas13 as e13
from corda_tpu.ops.ed25519 import ed25519_verify_batch as ref_verify_batch
from corda_tpu_torch import interop
from corda_tpu_torch.crypto import ed25519_host
from corda_tpu_torch.ops import ed25519 as port_ed
from corda_tpu_torch.ops.ed25519_ladder import (
    build_table,
    ladder_table,
    verify_ladder_plain,
)
from corda_tpu_torch.ops.scalar25519 import challenge_windows_plain
from corda_tpu_torch.testing import adversarial_lanes, signed_triples

L = 2**252 + 27742317777372353535851937790883648493


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run many small integer ops: beside the suite's
    other worker processes a torch thread pool only contends, so these
    tests run torch on one thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def adversarial_batch(var_lengths: bool):
    """16 lanes: every adversarial kind (44-byte messages) plus valid rows;
    with ``var_lengths`` the valid rows carry 1-200-byte messages, which
    sends the whole batch down the host-hash route."""
    lanes = adversarial_lanes(0)
    kinds = [k for k, *_ in lanes]
    rows = [(pk, sig, msg) for _k, pk, sig, msg in lanes]
    fill = 16 - len(rows)
    rows += signed_triples(fill, seed=3, msg_len=(1, 200) if var_lengths else 44)
    return kinds + ["valid"] * fill, rows


@pytest.mark.parametrize("var_lengths", [False, True], ids=["fixed44", "var1to200"])
def test_verdicts_match_reference_with_adversarial_lanes(var_lengths):
    kinds, rows = adversarial_batch(var_lengths)
    pks, sigs, msgs = map(list, zip(*rows))
    uniform = len({len(m) for m in msgs}) == 1
    assert uniform != var_lengths  # the batch takes the route it names
    got = port_ed.ed25519_verify_batch(pks, sigs, msgs, device="cpu")
    ref = ref_verify_batch(pks, sigs, msgs)
    oracle = np.array([ed25519_host.verify(*r) for r in rows])
    assert got.dtype == bool and got.shape == (16,)
    assert got.tolist() == ref.tolist(), [k for k, g, r in zip(kinds, got, ref) if g != r]
    assert got.tolist() == oracle.tolist()
    accepted = {k for k, g in zip(kinds, got) if g}
    assert accepted == {"valid", "small_order_a_identity", "mixed_order_accept"}


def test_tpu_gated_lanes_on_both_routes():
    """The four lanes of the reference's on-chip differential (a flipped R
    byte, a flipped message bit, s + L, a truncated key)."""
    for msg_len in (44, (1, 200)):
        rows = signed_triples(16, seed=11, msg_len=msg_len)
        pks, sigs, msgs = map(list, zip(*rows))
        sigs[5] = bytes([sigs[5][0] ^ 1]) + sigs[5][1:]
        msgs[9] = msgs[9][:-1] + bytes([msgs[9][-1] ^ 0x80])
        s = int.from_bytes(sigs[12][32:], "little")
        sigs[12] = sigs[12][:32] + (s + L).to_bytes(32, "little")
        pks[14] = pks[14][:31]
        got = port_ed.ed25519_verify_batch(pks, sigs, msgs, device="cpu")
        assert got.tolist() == [i not in (5, 9, 12, 14) for i in range(16)]
        assert got.tolist() == ref_verify_batch(pks, sigs, msgs).tolist()


def test_empty_and_mismatched_batches():
    assert port_ed.ed25519_verify_batch([], [], [], device="cpu").shape == (0,)
    with pytest.raises(ValueError):
        port_ed.ed25519_verify_batch([b"x" * 32], [], [b""], device="cpu")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from corda_tpu_torch import resolve_device
    from corda_tpu_torch.serving import DeviceScheduler

    rows = signed_triples(1, seed=2)
    pks, sigs, msgs = map(list, zip(*rows))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_ed.ed25519_verify_batch(pks, sigs, msgs)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceScheduler()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_twin_verifies_its_batch():
    from corda_tpu_torch.entry import entry

    fn, (pks, sigs, msgs) = entry()
    assert len(pks) == len(sigs) == len(msgs) == 256
    assert {len(m) for m in msgs} == {44}
    assert fn(pks, sigs, msgs, device="cpu").all()


# -------------------------------------------------------------- interop


def test_consts_from_reference_equal_the_ports_table():
    converted = interop.consts_from_reference(e13._CONSTS_HOST)
    assert converted.dtype == torch.int32 and converted.shape == (771, 10)
    np.testing.assert_array_equal(converted.numpy(), build_table())


def test_consts_round_trip_to_reference_limbs():
    back = interop.consts_to_reference(interop.consts_from_reference(e13._CONSTS_HOST))
    np.testing.assert_array_equal(back, e13._CONSTS_HOST)
    np.testing.assert_array_equal(interop.consts_to_reference(ladder_table("cpu")),
                                  e13._CONSTS_HOST)


def test_plain_ladder_same_verdicts_with_either_table():
    _kinds, rows = adversarial_batch(False)
    pks, sigs, msgs = map(list, zip(*rows))
    pk_arr, sig_arr, ok = port_ed._gather_fixed(pks, sigs, 16)
    _y, _s, s_arr, pre = port_ed._canonical_precheck(pk_arr, sig_arr, ok)
    packed = np.zeros((16, 161), np.uint8)
    port_ed.pack_rows(packed, sig_arr, pk_arr, s_arr, pre, msgs)
    packed = torch.from_numpy(packed)
    win = challenge_windows_plain(packed)
    mine = verify_ladder_plain(packed, win, ladder_table("cpu"))
    theirs = verify_ladder_plain(packed, win, interop.consts_from_reference(e13._CONSTS_HOST))
    assert mine.tolist() == theirs.tolist()
    assert mine.tolist() == [ed25519_host.verify(*r) for r in rows]


def test_consts_from_reference_rejects_other_shapes():
    with pytest.raises(ValueError):
        interop.consts_from_reference(e13._CONSTS_HOST[:64])


def test_shapes_from_reference_keep_the_ladder_not_the_capture():
    from corda_tpu_torch.serving import shape_table

    path = os.path.join(os.path.dirname(__file__), "..", "corda_tpu", "serving",
                        "shapes.json")
    with open(path) as f:
        ref = json.load(f)
    table = interop.shapes_from_reference(ref)
    assert table.buckets == ref["buckets"] == shape_table().buckets
    for t in (table, shape_table()):
        assert "H100" in t.data["device"] and "TPU" not in json.dumps(t.data)


# ------------------------------------------------- staging and readiness


class _FakeEvent:
    def __init__(self, done):
        self.done = done

    def query(self):
        if self.done is None:
            raise RuntimeError("device lost")
        return self.done


def test_staging_reuse_waits_for_the_event():
    from corda_tpu_torch.ops._blockpack import acquire_staging, transfer_done

    assert transfer_done(_FakeEvent(True))
    assert not transfer_done(_FakeEvent(False))
    assert not transfer_done(_FakeEvent(None))  # a raising probe
    assert not transfer_done(object())          # an unknown handle
    host, slot = acquire_staging(torch.device("cpu"), ("ed25519", 8), (8, 161))
    assert slot is None and host.shape == (8, 161) and not host.any()


def test_result_ready_reads_the_copy_event():
    from corda_tpu_torch.ops._blockpack import HostCopy, result_ready, start_host_copy

    mask = torch.tensor([True, False])
    handle = start_host_copy(mask)
    assert result_ready(handle) and handle.wait().tolist() == [True, False]
    assert not result_ready(HostCopy(mask, _FakeEvent(False)))
    assert result_ready(HostCopy(mask, _FakeEvent(True)))


def test_events_record_on_the_tensors_device_stream(monkeypatch):
    """The staging and readback events go on the stream of the device the
    work ran on, not the calling thread's current device."""
    from corda_tpu_torch.ops import _blockpack

    asked, recorded = [], []

    class FakeEvent:
        def record(self, stream=None):
            recorded.append(stream)

    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: asked.append(device) or ("stream", device))
    dev = torch.device("cuda", 1)
    _blockpack.record_event(dev)
    assert asked == [dev] and recorded == [("stream", dev)]


@pytest.mark.device
def test_kernels_match_plain_versions_on_the_card():
    """Both kernels against their plain versions on the card (skips
    without CUDA; ``python3 chip_smoke.py`` runs the full check)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from corda_tpu_torch.ops.ed25519_ladder import ed25519_verify_ladder
    from corda_tpu_torch.ops.scalar25519 import ed25519_challenge

    _kinds, rows = adversarial_batch(False)
    pks, sigs, msgs = map(list, zip(*rows))
    pk_arr, sig_arr, ok = port_ed._gather_fixed(pks, sigs, 16)
    _y, _s, s_arr, pre = port_ed._canonical_precheck(pk_arr, sig_arr, ok)
    host = np.zeros((16, 161), np.uint8)
    port_ed.pack_rows(host, sig_arr, pk_arr, s_arr, pre, msgs)
    packed = torch.from_numpy(host).cuda()
    win = ed25519_challenge(packed)
    assert torch.equal(win, challenge_windows_plain(packed))
    table = ladder_table(packed.device)
    assert torch.equal(ed25519_verify_ladder(packed, win, table),
                       verify_ladder_plain(packed, win, table))


def _gather_fixed_per_row(pubkeys, signatures, b):
    """The per-row gather ``_gather_fixed`` ran for a bucket that held one
    row of the wrong length (before the length mask and one join)."""
    pk = np.zeros((b, 32), np.uint8)
    sg = np.zeros((b, 64), np.uint8)
    ok = np.zeros(b, dtype=bool)
    for i, (p, s) in enumerate(zip(pubkeys, signatures)):
        if len(p) == 32 and len(s) == 64:
            pk[i] = np.frombuffer(p, np.uint8)
            sg[i] = np.frombuffer(s, np.uint8)
            ok[i] = True
    return pk, sg, ok


def test_ragged_bucket_gathers_as_the_per_row_loop():
    """A bucket with rows of the wrong length (a truncated key, a long and
    a short signature, empty ones, among valid and adversarial rows) and
    padding: the gathered planes, the packed plane and the verdicts are
    byte-equal to the per-row loop's, and the verdicts to the oracle's."""
    triples = [(pk, s, m) for _k, pk, s, m in adversarial_lanes(2)] + signed_triples(6, seed=8)
    triples[1] = (triples[1][0], triples[1][1] + b"\x00", triples[1][2])
    triples[5] = (triples[5][0], triples[5][1][:63], triples[5][2])
    triples.append((b"", b"", triples[0][2]))
    pks, sigs, msgs = map(list, zip(*triples))
    b = 32
    got = port_ed._gather_fixed(pks, sigs, b)
    want = _gather_fixed_per_row(pks, sigs, b)
    assert all(np.array_equal(x, y) for x, y in zip(got, want))
    assert not got[2].all() and got[2].sum() == len(triples) - 4

    def plane(gathered):
        pk_arr, sig_arr, ok = gathered
        _y, _s, s_arr, pre = port_ed._canonical_precheck(pk_arr, sig_arr, ok)
        out = np.zeros((b, 161), np.uint8)
        port_ed.pack_rows(out, sig_arr, pk_arr, s_arr, pre, msgs)
        return out

    assert np.array_equal(plane(got), plane(want))
    mask = port_ed.ed25519_verify_batch(pks, sigs, msgs, device="cpu")
    assert mask.tolist() == [ed25519_host.verify(*t) for t in triples]


P25519 = 2**255 - 19
# (kind, key bytes, the reference's answer without OpenSSL, from
# _ed25519_fallback.point_decodable): with OpenSSL, which tier-1's oracle
# has, the reference takes any 32 bytes, and the port follows that branch
ED25519_KEYS = [
    ("valid", ed25519_host.public_from_seed(bytes(range(32))), True),
    ("undecodable_y", (2).to_bytes(32, "little"), False),  # y = 2 has no x
    ("y_ge_p", (P25519 + 1).to_bytes(32, "little"), False),
    ("all_ff", b"\xff" * 32, False),
    ("short_31", ed25519_host.public_from_seed(bytes(32))[:31], False),
    ("long_33", ed25519_host.public_from_seed(bytes(32)) + b"\x00", False),
]


@pytest.mark.parametrize("kind,key,fallback", ED25519_KEYS,
                         ids=[k for k, _key, _f in ED25519_KEYS])
def test_public_key_on_curve_matches_reference(kind, key, fallback):
    pytest.importorskip("cryptography")  # the reference's OpenSSL branch
    from corda_tpu.crypto import _ed25519_fallback
    from corda_tpu.crypto import schemes as ref_schemes
    from corda_tpu.crypto.keys import PublicKey as RefPublicKey
    from corda_tpu_torch.crypto import PublicKey, schemes

    want = ref_schemes.public_key_on_curve(RefPublicKey(4, key))
    assert schemes.public_key_on_curve(PublicKey(4, key)) == want == (len(key) == 32)
    assert _ed25519_fallback.point_decodable(key) == fallback
