"""Tooling (counterpart of corda_tpu/tools):

- ``loadtest`` — the closed-loop load-test harness (generate, interpret,
  execute and gather, with disruptions;
  tools/loadtest/.../LoadTest.kt:37-69, Disruption.kt);
- ``loadharness`` — the open-loop SLO-attainment harness (seeded Poisson
  arrivals, a stepped qps ramp scored through an SLO monitor, the knee,
  per-step flowprof waterfalls, and the overload certification).

Not ported yet (ROADMAP.md, Queue 1 step 9): the node shell, the web
server, the explorer, the graphs, the demo bench and the load generator's
CLI (the reference's ``tools_loadgen.py``).
"""
