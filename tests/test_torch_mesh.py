"""The port's mesh (``corda_tpu_torch/parallel/mesh.py``) on eight logical
CPU ordinals against the reference's ``MeshVerifier`` on its eight virtual
XLA devices (tests/conftest.py), the same seeded inputs through both.

Held exactly (tolerance zero, every verdict, byte and count):

- the sharded ed25519 step with and without the spent rows: the padded
  shape, ``mask[:n]`` on every adversarial kind of
  ``testing.adversarial_lanes`` (the mesh's per-signature rule, no
  cofactor), the all-gathered ``spent_all`` (each ordinal's copy equal to
  the rows given) and the psum'd ``total``;
- the ECDSA fan-out on both curves (kernel F's plain version a shard) and
  the SPHINCS chunk fan-out (kernel H's a chunk, the reference's chunking);
- ``dispatch_signature_rows`` through the mesh (``enable_service_mesh``)
  on a mixed ed25519 + k1 + r1 + SPHINCS batch;
- the ordinal translation (``device_for_ordinal`` raising ``KeyError``),
  the bucket rule and the service-mesh switch.

Each reference call is made once a module: its XLA ladders compile slowly
on the CPU."""

import hashlib

import numpy as np
import pytest
import torch

from corda_tpu.crypto import keys as ref_keys
from corda_tpu.parallel import mesh as ref_mesh
from corda_tpu.verifier import batch as ref_batch
from corda_tpu_torch.crypto import keys as port_keys
from corda_tpu_torch.crypto.keys import (
    ECDSA_SECP256K1_SHA256,
    ECDSA_SECP256R1_SHA256,
    EDDSA_ED25519_SHA512,
    SPHINCS256_SHA256,
)
from corda_tpu_torch.ops.ed25519 import ed25519_verify_batch
from corda_tpu_torch.parallel import mesh as port_mesh
from corda_tpu_torch.testing import (
    adversarial_lanes,
    ecdsa_adversarial_lanes,
    signed_triples,
    sphincs_adversarial_lanes,
)
from corda_tpu_torch.verifier import batch as port_batch

N_ORDINALS = 8


@pytest.fixture(scope="module", autouse=True)
def logical_ordinals():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    port_mesh.set_logical_devices([torch.device("cpu", i) for i in range(N_ORDINALS)])
    yield
    port_mesh.set_logical_devices(None)
    port_mesh.enable_service_mesh(None)
    torch.set_num_threads(before)


def _ed_rows():
    lanes = adversarial_lanes(seed=3)
    rows = [(pk, sig, msg) for _kind, pk, sig, msg in lanes] + signed_triples(9, seed=20)
    kinds = [kind for kind, *_ in lanes] + ["valid"] * 9
    return kinds, [r[0] for r in rows], [r[1] for r in rows], [r[2] for r in rows]


def _spent(n):
    rng = np.random.default_rng(20261018)
    return rng.integers(-2**31, 2**31, size=(n, 8), dtype=np.int64).astype(np.int32)


@pytest.fixture(scope="module")
def ed_case():
    kinds, pks, sigs, msgs = _ed_rows()
    spent = _spent(len(pks))
    rv = ref_mesh.MeshVerifier(ref_mesh.make_mesh(N_ORDINALS))
    r_mask, r_none, r_none2 = rv.dispatch_rows(pks, sigs, msgs)
    r_mask2, r_spent, r_total = rv.dispatch_rows(pks, sigs, msgs, spent_hashes=spent)
    ref = {
        "mask_shape": tuple(r_mask.shape), "mask": np.asarray(r_mask),
        "none": (r_none, r_none2), "mask2": np.asarray(r_mask2),
        "spent": np.asarray(r_spent), "total": int(r_total),
    }
    pv = port_mesh.MeshVerifier(port_mesh.make_mesh(N_ORDINALS))
    p_mask, p_none, p_none2 = pv.dispatch_rows(pks, sigs, msgs)
    p_mask2, p_spent, p_total = pv.dispatch_rows(pks, sigs, msgs, spent_hashes=spent)
    port = {
        "mask_shape": tuple(p_mask.shape), "mask": p_mask.numpy(),
        "none": (p_none, p_none2), "mask2": p_mask2.numpy(),
        "spent": p_spent.numpy(), "total": int(p_total),
        "by_ordinal": [t.numpy() for t in pv.spent_all_by_ordinal],
    }
    return kinds, pks, sigs, msgs, spent, ref, port


def test_verify_step_equals_the_reference(ed_case):
    kinds, pks, sigs, msgs, spent, ref, port = ed_case
    n = len(pks)
    assert port["mask_shape"] == ref["mask_shape"] == (64,)
    assert port["none"] == ref["none"] == (None, None)
    assert port["mask"][:n].tolist() == ref["mask"][:n].tolist()
    assert port["mask2"][:n].tolist() == ref["mask2"][:n].tolist()
    assert not port["mask"][n:].any()
    # every kind: the mesh's per-signature rule, as the one-device path
    one = ed25519_verify_batch(pks, sigs, msgs, device="cpu")
    assert port["mask"][:n].tolist() == one.tolist()
    assert any(port["mask"][:n]) and not all(port["mask"][:n])
    bad = {k for k, ok in zip(kinds, port["mask"][:n]) if not ok}
    assert "flipped_r_byte" in bad and "s_plus_l" in bad and "valid" not in bad


def test_spent_rows_gather_and_total_equal_the_reference(ed_case):
    _kinds, pks, _sigs, _msgs, spent, ref, port = ed_case
    n = len(pks)
    assert port["spent"].shape == ref["spent"].shape == (64, 8)
    assert (port["spent"] == ref["spent"]).all()
    assert (port["spent"][:n] == spent).all() and not port["spent"][n:].any()
    assert len(port["by_ordinal"]) == N_ORDINALS
    for copy in port["by_ordinal"]:
        assert (copy == port["spent"]).all()
    assert port["total"] == ref["total"] == int(port["mask2"][:n].sum())


@pytest.mark.parametrize("curve,scheme", [("secp256k1", ECDSA_SECP256K1_SHA256),
                                          ("secp256r1", ECDSA_SECP256R1_SHA256)])
def test_ecdsa_fan_out_equals_the_reference(curve, scheme):
    lanes = ecdsa_adversarial_lanes(curve, seed=5)
    pks = [pk for _k, pk, _s, _m in lanes]
    sigs = [s for _k, _pk, s, _m in lanes]
    msgs = [m for _k, _pk, _s, m in lanes]
    n = len(pks)
    rv = ref_mesh.MeshVerifier(ref_mesh.make_mesh(N_ORDINALS))
    pv = port_mesh.MeshVerifier(port_mesh.make_mesh(N_ORDINALS))
    ref = np.asarray(rv.dispatch_ecdsa_rows(curve, pks, sigs, msgs))
    port = pv.dispatch_ecdsa_rows(curve, pks, sigs, msgs).numpy()
    assert port.shape == ref.shape
    assert port[:n].tolist() == ref[:n].tolist()
    assert any(port[:n]) and not all(port[:n])


def test_sphincs_fan_out_equals_the_reference():
    lanes = sphincs_adversarial_lanes(seed=7)[:9]
    pks = [pk for _k, pk, _s, _m in lanes]
    sigs = [s for _k, _pk, s, _m in lanes]
    msgs = [m for _k, _pk, _s, m in lanes]
    rv = ref_mesh.MeshVerifier(ref_mesh.make_mesh(N_ORDINALS))
    pv = port_mesh.MeshVerifier(port_mesh.make_mesh(N_ORDINALS))
    ref = np.asarray(rv.dispatch_sphincs_rows(pks, sigs, msgs))
    chunked = pv.dispatch_sphincs_rows(pks, sigs, msgs)
    port = np.asarray(chunked)
    assert port.shape == ref.shape == (9,)
    assert port.tolist() == ref.tolist()
    # the reference's chunking: ceil(9 / 3) lanes a chunk on three ordinals
    assert [(lo, hi) for lo, hi, _m in chunked.parts] == [(0, 3), (3, 6), (6, 9)]
    assert [m.device for _lo, _hi, m in chunked.parts] == [torch.device("cpu")] * 3


def _mixed_rows():
    ed = signed_triples(6, seed=31)
    ed[2] = (ed[2][0], bytes([ed[2][1][0] ^ 1]) + ed[2][1][1:], ed[2][2])
    rows = [(EDDSA_ED25519_SHA512, pk, s, m) for pk, s, m in ed]
    for curve, scheme in (("secp256k1", ECDSA_SECP256K1_SHA256),
                          ("secp256r1", ECDSA_SECP256R1_SHA256)):
        rows += [(scheme, pk, s, m) for _k, pk, s, m in ecdsa_adversarial_lanes(curve, 9)[:6]]
    rows += [(SPHINCS256_SHA256, pk, s, m) for _k, pk, s, m in sphincs_adversarial_lanes(2)[:3]]
    return rows


def test_dispatch_through_the_service_mesh_equals_the_reference():
    rows = _mixed_rows()
    ref_rows = [(ref_keys.PublicKey(sid, pk), s, m) for sid, pk, s, m in rows]
    port_rows = [(port_keys.PublicKey(sid, pk), s, m) for sid, pk, s, m in rows]
    ref_mesh.enable_service_mesh(True)
    try:
        ref = ref_batch.dispatch_signature_rows(ref_rows).collect()
    finally:
        ref_mesh.enable_service_mesh(False)
    port_mesh.enable_service_mesh(True)
    try:
        assert port_mesh.service_mesh_active()
        pending = port_batch.dispatch_signature_rows(port_rows, device=None)
        port = pending.collect()
    finally:
        port_mesh.enable_service_mesh(None)
    assert port.tolist() == ref.tolist()
    assert pending.device_rows == len(rows)
    assert not all(port) and any(port)


def test_pinned_device_takes_no_second_fan_out(monkeypatch):
    """A pinned device means the bucket was placed already: the mesh
    verifier is never asked."""
    rows = [(port_keys.PublicKey(EDDSA_ED25519_SHA512, pk), s, m)
            for pk, s, m in signed_triples(4, seed=40)]

    def refuse():
        raise AssertionError("a pinned dispatch reached the mesh")

    monkeypatch.setattr(port_mesh, "service_mesh_verifier", refuse)
    port_mesh.enable_service_mesh(True)
    try:
        got = port_batch.dispatch_signature_rows(rows, device="cpu").collect()
    finally:
        port_mesh.enable_service_mesh(None)
    assert got.all()


def test_ordinals_bucket_and_switch_follow_the_reference(monkeypatch):
    assert port_mesh.visible_devices() == [torch.device("cpu", i) for i in range(N_ORDINALS)]
    assert port_mesh.device_for_ordinal(5) == torch.device("cpu", 5)
    for bad in (-1, N_ORDINALS, 99):
        with pytest.raises(KeyError):
            port_mesh.device_for_ordinal(bad)
        with pytest.raises(KeyError):
            ref_mesh.device_for_ordinal(bad)
    pv = port_mesh.MeshVerifier(port_mesh.make_mesh(N_ORDINALS))
    rv = ref_mesh.MeshVerifier(ref_mesh.make_mesh(N_ORDINALS))
    for n, mb in ((0, None), (1, None), (64, None), (65, None), (5, 128), (300, 16)):
        assert pv._bucket(n, mb) == rv._bucket(n, mb)
    with pytest.raises(ValueError):
        port_mesh.make_mesh(N_ORDINALS + 1)
    # off unless forced, or more than one CUDA device
    port_mesh.enable_service_mesh(None)
    assert port_mesh.service_mesh_active() == (torch.cuda.device_count() > 1)
    port_mesh.enable_service_mesh(True)
    assert port_mesh.service_mesh_active()
    port_mesh.enable_service_mesh(None)
    # both switches resolve through one rule
    for env in ("CORDA_TPU_SERVICE_MESH", "CORDA_TPU_MESH"):
        for word, want in (("1", True), ("on", True), ("0", False), ("no", False)):
            monkeypatch.setenv(env, word)
            assert port_mesh.mesh_switch(None, env) is want
            assert port_mesh.mesh_switch(not want, env) is not want
        monkeypatch.delenv(env)
        assert port_mesh.mesh_switch(None, env, "cpu") is False
    monkeypatch.setenv("CORDA_TPU_SERVICE_MESH", "1")
    assert port_mesh.service_mesh_active()


def test_consumed_rows_digest_equals_the_reference():
    from corda_tpu.serving.scheduler import _consumed_rows as ref_rows
    from corda_tpu_torch.serving.scheduler import _consumed_rows as port_rows

    msgs = [hashlib.sha256(b"m%d" % i).digest()[:7 + i] for i in range(12)]
    assert (port_rows(msgs) == ref_rows(msgs)).all()
