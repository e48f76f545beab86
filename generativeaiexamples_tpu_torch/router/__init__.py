"""Cache-aware multi-replica routing tier (docs/router.md).

Counterpart of generativeaiexamples_tpu/router/: a standalone reverse
proxy on the standard library fronting N chain-server (or engine
OpenAI-facade) replicas with the same ``/generate`` + ``/v1`` API
surface. Placement preserves per-replica KV/prefix-cache locality: a
consistent-hash ring keyed on the same session/content identity the
engine's radix prefix cache keys on (the first user message of a
conversation — constant as the history grows, and identical for
repeated questions), with bounded-load spill to the next ring replica
when the owner is saturated. Per-tenant token buckets and weighted
fair queuing shed 429s before a byte reaches a replica; a health
poller drives replicas in and out of placement from their
``/internal/ready`` + wedged + SLO signals, and an explicit drain
endpoint supports rolling restarts.

Run: ``python -m generativeaiexamples_tpu_torch.router --port 9000 \\
         --replica http://127.0.0.1:8081 --replica http://127.0.0.1:8082``
"""
from generativeaiexamples_tpu_torch.router.ring import (  # noqa: F401
    AffinityPlacer,
    HashRing,
    Placement,
    RoundRobinPlacer,
)
