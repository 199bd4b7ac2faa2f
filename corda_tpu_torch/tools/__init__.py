"""Tooling (counterpart of corda_tpu/tools): the load-test harness
(``loadtest``: generate, interpret, execute and gather, with disruptions;
tools/loadtest/.../LoadTest.kt:37-69, Disruption.kt).

Not ported yet (ROADMAP.md, Queue 1): the open-loop harness
(``loadharness.py``, with step 4b), the node shell, the web server, the
explorer, the graphs and the demo bench.
"""
