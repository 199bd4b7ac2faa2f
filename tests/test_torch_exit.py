"""A process that exits with torch work in flight exits cleanly.

The port's service threads are daemons; one caught inside a torch op while
the interpreter finalizes used to abort the process (``terminate called
without an active exception``, rc 134) where the reference exits with rc 0.
At exit one hook of ``serving/scheduler.py`` drains the live flow engines,
then the notary request windows and verifier services registered with its
``drain_at_exit``, joining their threads, and then shuts down the shared
device schedulers.
Each probe runs in a subprocess on ``device="cpu"``, puts work in flight
and exits at once: rc 0, no abort, and every future the drained services
owned is settled by the time the last exit hook runs."""

import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the probe's own exit hook is registered first, so it runs after the
# port's: it reports how many of the in-flight futures were settled
PRELUDE = """
import atexit, sys, time
import torch
FUTS = []
atexit.register(lambda: print("settled", sum(f.done() for f in FUTS), len(FUTS), flush=True))
"""

PROBES = {
    "scheduler": """
from corda_tpu_torch.crypto import PublicKey
from corda_tpu_torch.serving import device_scheduler
from corda_tpu_torch.testing import signed_triples
rows = [(PublicKey(4, pk), s, m) for pk, s, m in signed_triples(64, seed=3)]
FUTS.append(device_scheduler(device="cpu").submit_rows(rows))
""",
    "notary_window": """
from corda_tpu_torch.notary import BatchedNotaryService, InMemoryUniquenessProvider
from corda_tpu_torch.testing import notary_stream
s = notary_stream(9, 4, seed=3, device="cpu")
svc = BatchedNotaryService(s.notary, s.notary_keypair, InMemoryUniquenessProvider(),
                           validating=True, max_batch=4, window_s=0.002, device="cpu")
FUTS.extend(svc.request(*t) for w in s.requests() for t in w)
""",
    "verifier_service": """
from corda_tpu_torch.testing import notary_stream
from corda_tpu_torch.verifier import BatchedVerifierService
s = notary_stream(9, 4, seed=3, device="cpu")
svc = BatchedVerifierService(use_scheduler=False, window_s=0.002, device="cpu")
FUTS.extend(svc.verify_signed(stx, r, {s.notary.owning_key})
            for w in s.requests() for stx, r, _ in w)
""",
    "flow": """
from corda_tpu_torch.finance import CashIssueFlow, CashPaymentFlow
from corda_tpu_torch.testing.mocknet import MockNetworkNodes
net = MockNetworkNodes(device="cpu")
a = net.create_node("Bank A")
b = net.create_node("Bank B")
notary = net.create_notary_node("Notary", validating=True, batched=True,
                                max_batch=8, window_s=0.002)
a.run_flow(CashIssueFlow(1000, "GBP", b"\\x01", notary.party), timeout=300)
a.smm.start_flow(CashPaymentFlow(300, "GBP", b.party))
""",
}


@pytest.mark.parametrize("probe", sorted(PROBES))
def test_exit_with_work_in_flight(probe):
    code = PRELUDE + textwrap.dedent(PROBES[probe]) + """
time.sleep(0.3)
print("exiting", sum(f.done() for f in FUTS), len(FUTS), flush=True)
"""
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1",
             "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")},
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    assert "terminate called" not in proc.stderr
    lines = proc.stdout.split()
    exiting = lines[lines.index("exiting") + 1:lines.index("exiting") + 3]
    settled = lines[lines.index("settled") + 1:lines.index("settled") + 3]
    n = int(settled[1])
    assert int(settled[0]) == n  # drained: every future settled at exit
    if probe != "flow":
        assert n > 0 and int(exiting[0]) < n  # work was in flight at exit
