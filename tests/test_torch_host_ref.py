"""The port's host anchor (``ops/host_ref.py`` over its copy of
``native/ed25519_portable.cpp``) against the reference's
(``corda_tpu/ops/host_ref.py``): both build with g++, and their verdicts are
equal, exactly, on the RFC 8032 vectors, on seeded valid triples, on every
adversarial kind ``testing.adversarial_lanes`` makes and on the malformed
lengths; the port's library lands in ``build/native/`` through the shared
``native_build`` helper; the profiler books the loop under ``host_ref``."""

import random

import numpy as np
import pytest

from corda_tpu.ops import host_ref as ref_host
from corda_tpu_torch import native_build
from corda_tpu_torch.observability.profiler import KERNEL_HOST_REF, DeviceProfiler
from corda_tpu_torch.ops import host_ref as port_host
from corda_tpu_torch.testing import adversarial_lanes, signed_triples

# RFC 8032 section 7.1, tests 1-3
RFC8032 = [
    ("d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a",
     "", "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
     "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b"),
    ("3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c",
     "72", "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da"
     "085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00"),
    ("fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025",
     "af82", "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac"
     "18ff9b538d16f290ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a"),
]


def _rows():
    rows = [("rfc8032", bytes.fromhex(pk), bytes.fromhex(sig), bytes.fromhex(msg))
            for pk, msg, sig in RFC8032]
    rows += [("valid", pk, sig, msg) for pk, sig, msg in signed_triples(24, seed=21, msg_len=(0, 200))]
    rows += list(adversarial_lanes(seed=5))
    pk, sig, msg = signed_triples(1, seed=22)[0]
    rows += [("short_key", pk[:31], sig, msg), ("short_sig", pk, sig[:63], msg),
             ("long_sig", pk, sig + b"\0", msg)]
    random.Random(3).shuffle(rows)
    return rows


@pytest.fixture(scope="module")
def rows():
    return _rows()


def test_verify_loop_equals_the_references(rows):
    kinds, pks, sigs, msgs = (list(c) for c in zip(*rows))
    port = port_host.verify_loop(pks, sigs, msgs)
    ref = ref_host.verify_loop(pks, sigs, msgs)
    assert port.dtype == ref.dtype == np.bool_
    assert port.tolist() == ref.tolist()
    accepted = {k for k, ok in zip(kinds, port) if ok}
    assert {"rfc8032", "valid"} <= accepted
    assert {"short_key", "short_sig", "long_sig"}.isdisjoint(accepted)
    assert len(set(kinds) - {"rfc8032", "valid", "short_key", "short_sig", "long_sig"}) >= 5


def test_verify_one_equals_the_references(rows):
    for kind, pk, sig, msg in rows:
        assert port_host.verify_one(pk, sig, msg) == ref_host.verify_one(pk, sig, msg), kind
    assert port_host.L == ref_host.L


def test_empty_loop():
    assert port_host.verify_loop([], [], []).tolist() == ref_host.verify_loop([], [], []).tolist()


def test_library_built_by_the_shared_helper():
    lib = port_host._load()
    assert "build/native/libed25519_portable_" in lib._name
    assert native_build.library_path(port_host._SRC).exists()
    with pytest.raises(native_build.NativeBuildError, match="missing source"):
        native_build.build_and_load(port_host._SRC.with_name("absent.cpp"))
    assert port_host.PortableEngineUnavailable is native_build.NativeBuildError


def test_profiler_books_the_host_loop(rows, monkeypatch):
    import importlib

    prof_mod = importlib.import_module("corda_tpu_torch.observability.profiler")
    prof = DeviceProfiler(enabled=True)
    monkeypatch.setattr(prof_mod, "_global", prof)
    _kinds, pks, sigs, msgs = (list(c) for c in zip(*rows[:8]))
    out = port_host.verify_loop(pks, sigs, msgs)
    assert out.tolist() == ref_host.verify_loop(pks, sigs, msgs).tolist()
    agg = prof.snapshot()["kernels"][KERNEL_HOST_REF]
    assert agg["rows"] == 8 and agg["padded_lanes"] == 8
    assert "roofline_rows_per_sec" not in agg
