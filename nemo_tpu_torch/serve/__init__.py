"""The serving tier of the sidecar: a copy of the JAX package's ``serve/``.

The sidecar (service/server.py) threads every work RPC through this
policy layer:

  * :mod:`nemo_tpu_torch.serve.admission`: a bounded admission queue with
    per-tenant round-robin fairness, an in-flight cap, RESOURCE_EXHAUSTED
    plus retry-after load shedding, and the drain flag SIGTERM flips;
  * :mod:`nemo_tpu_torch.serve.coalesce`: single-flight deduplication of
    concurrent identical requests, keyed on the result cache's content
    address: N subscribers, one analysis, byte-identical responses;
  * :mod:`nemo_tpu_torch.serve.batch`: cross-request continuous batching:
    compatible kernel dispatches of different in-flight requests merge
    into one padded launch through ``parallel/sched.py``'s job queue.

Above one replica, the fleet: :mod:`nemo_tpu_torch.serve.router` (the
consistent-hash router over N replicas, with spill under load and
failover) and :mod:`nemo_tpu_torch.serve.autoscale` (its scale signal).
The router's names are exported lazily: importing this package never
loads the router, the sidecar's handlers or grpc.

Importing it loads numpy and obs only; torch loads when a merged launch
runs.
"""

from __future__ import annotations

from .admission import (
    AdmissionController,
    AdmissionRejected,
    Ticket,
    controller,
    reset_controller,
    slo_snapshot,
)
from .batch import BATCHABLE_VERBS, KernelBatcher, batcher, reset_batcher
from .coalesce import SingleFlight, flights, reset_flights

#: Names exported from serve/router.py on first access.
_ROUTER_NAMES = ("HashRing", "Router", "RouterLoopback", "make_router_server", "ring_hash", "route_key")


def __getattr__(name: str):
    if name in _ROUTER_NAMES:
        from . import router

        return getattr(router, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "AdmissionController",
    "AdmissionRejected",
    "BATCHABLE_VERBS",
    "KernelBatcher",
    "SingleFlight",
    "Ticket",
    "batcher",
    "controller",
    "flights",
    "reset_batcher",
    "reset_controller",
    "reset_flights",
    "slo_snapshot",
]
