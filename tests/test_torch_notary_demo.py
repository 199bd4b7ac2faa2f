"""The notary demo (samples/notary-demo, BASELINE config #5's named
sample), the port's against the reference's.

``run_demo(n_txs=10, device="cpu")`` in the port and ``run_demo(n_txs=10)``
in the reference notarise the same seeded DAG shape in every mode (single,
Raft, BFT, and the batched notary over Raft: the port's on its device, the
reference's on its host tier): the same notarised and conflict counts, mode
by mode, and both refuse the double spend. With no CUDA device the port's
``run_demo()`` raises instead of running on the CPU."""

import threading

import pytest
import torch

import corda_tpu.notary as ref_notary
from corda_tpu.samples.notary_demo import run_demo as ref_run_demo
from corda_tpu.serving import shutdown_scheduler as ref_shutdown_scheduler
from corda_tpu_torch.samples import notary_demo
from corda_tpu_torch.serving import shutdown_scheduler
from test_torch_raft import cluster_threads, no_cluster_thread_left, one_torch_thread  # noqa: F401

MODES = ("single", "raft", "bft", "batched-raft")


@pytest.fixture(scope="module", autouse=True)
def shared_schedulers():
    yield
    shutdown_scheduler()
    ref_shutdown_scheduler()


@pytest.fixture
def stop_reference_replicas(monkeypatch):
    """The reference's demo leaves its BFT replicas' timers running: keep
    the replicas it makes and stop them after the test."""
    made = []
    make_cluster = ref_notary.BFTUniquenessProvider.make_cluster

    def recording(*args, **kwargs):
        replicas, make_client = make_cluster(*args, **kwargs)
        made.extend(replicas)
        return replicas, make_client

    monkeypatch.setattr(ref_notary.BFTUniquenessProvider, "make_cluster",
                        staticmethod(recording))
    yield
    for r in made:
        r.stop()


def test_demo_counts_match_reference(stop_reference_replicas):
    before = set(threading.enumerate())
    port = notary_demo.run_demo(n_txs=10, verbose=False, device="cpu")
    assert not cluster_threads(before)  # the port's demo stops its clusters
    ref = ref_run_demo(n_txs=10, verbose=False)
    assert list(port) == list(ref) == list(MODES)
    for mode in MODES:
        got = {k: v for k, v in port[mode].items() if k != "elapsed_s"}
        want = {k: v for k, v in ref[mode].items() if k != "elapsed_s"}
        assert got == want, mode
        assert got["double_spend_rejected"] and got["notarised"] > 0


def test_demo_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        notary_demo.run_demo(n_txs=4, verbose=False)
