"""Sample CorDapps (counterpart of corda_tpu/samples; reference:
samples/):

- ``notary_demo`` — drives single / Raft / BFT notary clusters
  (samples/notary-demo — baseline config #5 shape);
- ``trader_demo`` — commercial paper for cash, delivery versus payment
  (samples/trader-demo — baseline config #1).

The other samples (the oracle, IRS, attachment, bank and SIMM demos and
the network visualiser) come with ROADMAP.md Queue 1 step 9.
Each module exposes a ``run_demo()`` entry returning a result summary (and
is runnable via ``python -m corda_tpu_torch.samples.<name>``).
"""

from . import notary_demo, trader_demo

__all__ = ["notary_demo", "trader_demo"]
