"""repro_torch.serve — the DDM serving layer, ported from the JAX
package's ``repro.serve``.

Multi-tenant, asynchronous serving on top of the ``MatchSpec →
build_plan → MatchPlan`` engine and ``DDMService``: per-tenant
namespaces with one memoized plan per ``(tenant, MatchSpec)``, request
batching + admission control (max-batch/max-delay coalescing, bounded
queues, explicit shed/reject), double-buffered interval-tree rebuilds
so ``update_regions`` churn never blocks readers (every response
carries a snapshot version + staleness bound), and a JSON metrics
surface.  On the card every query batch is one K8 tree walk.

    from repro_torch.serve import DDMServer

    server = DDMServer(warm_start=True)           # device="cuda"
    server.add_tenant("sim-a", S, U)
    server.start()
    fut = server.submit("sim-a", "sub", lo, hi)   # future → QueryResult
    server.update_regions("sim-a", "sub", idx, new_lo, new_hi)
    ...
    server.stop()

``python -m repro_torch.serve --smoke`` runs the self-checking
multi-tenant churn harness (set-parity against a brute oracle, no
library load or new buffer capacity in steady state) on the card;
``--device cpu`` runs it on the plain versions.
"""
from .admission import AdmissionError, AdmissionPolicy
from .batching import BatchPolicy, QueryResult
from .compile_cache import enable as warm_start
from .metrics import Metrics
from .server import DDMServer
from .tenancy import Tenant

__all__ = [
    "DDMServer", "Tenant", "Metrics",
    "AdmissionError", "AdmissionPolicy", "BatchPolicy", "QueryResult",
    "warm_start",
]
