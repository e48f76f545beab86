"""``genai_router_*`` metric families (docs/observability.md).

Counterpart of generativeaiexamples_tpu/router/metrics.py: JAX's eight
families under JAX's names, help, labels and buckets, on the port's
registry.

Registered at import (the repo registry pattern) so the metric-names /
metric-docs lint rules can audit them without building a router.
Replica labels are the short replica ids (``r0``, ``r1`` — bounded
cardinality), never raw URLs.
"""
from __future__ import annotations

from generativeaiexamples_tpu_torch.utils import metrics as metrics_mod

_REG = metrics_mod.get_registry()

PLACEMENTS = _REG.counter(
    "genai_router_placements_total",
    "Placement decisions by policy (affinity, round_robin) and outcome "
    "(affinity: key's effective ring owner; spill: bounded-load walk "
    "past a saturated owner; round_robin: blind baseline; none: no "
    "placeable replica).",
    ("policy", "outcome"),
)
SHEDS = _REG.counter(
    "genai_router_sheds_total",
    "Requests shed 429 + Retry-After at the router before reaching a "
    "replica, by reason (tenant_rate, tenant_inflight, fair_share, "
    "no_replica).",
    ("reason",),
)
FAILOVERS = _REG.counter(
    "genai_router_failovers_total",
    "Re-placements on a sibling replica, by reason: error/overload "
    "(upstream failed before the first forwarded byte), preempted "
    "(drain terminator intercepted mid-stream; sibling restore), "
    "replica_died (mid-stream death; sibling replay). Bounded per "
    "request by router.retry_budget.",
    ("reason",),
)
RETRY_BUDGET_EXHAUSTED = _REG.counter(
    "genai_router_retry_budget_exhausted_total",
    "Proxied requests that still failed after spending their whole "
    "per-request re-placement budget (router.retry_budget); the last "
    "upstream error passes through to the client instead of a "
    "generic 502.",
)
REPLICA_STATE = _REG.gauge(
    "genai_router_replica_state",
    "Replica placement state: 0 unhealthy, 1 healthy, 2 draining.",
    ("replica",),
)
REPLICA_INFLIGHT = _REG.gauge(
    "genai_router_replica_inflight",
    "Requests currently proxied to each replica.",
    ("replica",),
)
REPLICA_QUEUE_DEPTH = _REG.gauge(
    "genai_router_replica_queue_depth",
    "Last engine admission-queue depth observed for each replica "
    "(X-GenAI-Queue-Depth shed headers; feeds bounded-load spill).",
    ("replica",),
)
PROXY_OVERHEAD = _REG.histogram(
    "genai_router_proxy_overhead_seconds",
    "Router-added latency per proxied request: receipt to upstream "
    "connection initiated (placement, tenant admission, body parse).",
)
