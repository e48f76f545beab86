"""Per-tenant quotas and weighted fair queuing (pure host).

Counterpart of generativeaiexamples_tpu/router/tenants.py, copied: the
same spec grammar, error messages and shed decisions.

The router identifies a tenant from the ``X-GenAI-Tenant`` header (or
an API key mapped by the tenant spec) and sheds 429 + Retry-After at
the router — before a byte reaches a replica — when the tenant
exceeds:

- its **token-bucket rate** (``rate_qps`` refill, ``burst`` capacity);
- its **max inflight** streams;
- its **weighted fair share** of the router-wide inflight cap: below
  the cap every tenant runs unthrottled (work-conserving); at the cap
  a tenant holding at least ``weight/total_weight`` of the cap is the
  one shed, so a runaway tenant cannot starve the others.

Spec grammar (config ``router.tenants``, ``APP_ROUTER_TENANTS``)::

    name:rate=2,burst=4,inflight=8,weight=2,keys=k1|k2;other:rate=1

Unknown tenant ids are accounted individually under the ``default``
entry's limits (every caller gets default fairness, not a shared
bucket); with no spec at all, admission is unlimited.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, Mapping, Optional, Tuple

DEFAULT_TENANT = "default"

TENANT_HEADER = "X-GenAI-Tenant"
AUTH_HEADER = "Authorization"


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """Limits for one tenant (0 = unlimited for rates/caps)."""

    name: str
    rate_qps: float = 0.0
    burst: float = 0.0
    max_inflight: int = 0
    weight: float = 1.0
    api_keys: Tuple[str, ...] = ()

    def validate(self) -> None:
        if self.rate_qps < 0:
            raise ValueError(f"tenant {self.name!r}: rate must be >= 0")
        if self.burst < 0:
            raise ValueError(f"tenant {self.name!r}: burst must be >= 0")
        if self.max_inflight < 0:
            raise ValueError(f"tenant {self.name!r}: inflight must be >= 0")
        if self.weight <= 0:
            raise ValueError(f"tenant {self.name!r}: weight must be > 0")


def parse_tenants(spec: str) -> Dict[str, TenantSpec]:
    """Parse the ``router.tenants`` spec string; raises ValueError with
    the offending fragment (startup validation, never request time)."""
    out: Dict[str, TenantSpec] = {}
    for entry in filter(None, (e.strip() for e in spec.split(";"))):
        name, _, body = entry.partition(":")
        name = name.strip()
        if not name:
            raise ValueError(f"tenant entry missing a name: {entry!r}")
        if name in out:
            raise ValueError(f"duplicate tenant {name!r}")
        kwargs: Dict[str, object] = {}
        for field in filter(None, (f.strip() for f in body.split(","))):
            key, sep, value = field.partition("=")
            if not sep:
                raise ValueError(f"tenant {name!r}: expected key=value, got {field!r}")
            key = key.strip()
            value = value.strip()
            try:
                if key == "rate":
                    kwargs["rate_qps"] = float(value)
                elif key == "burst":
                    kwargs["burst"] = float(value)
                elif key == "inflight":
                    kwargs["max_inflight"] = int(value)
                elif key == "weight":
                    kwargs["weight"] = float(value)
                elif key == "keys":
                    kwargs["api_keys"] = tuple(filter(None, value.split("|")))
                else:
                    raise ValueError(f"unknown field {key!r}")
            except ValueError as exc:
                raise ValueError(f"tenant {name!r}: {exc}") from exc
        ts = TenantSpec(name=name, **kwargs)  # type: ignore[arg-type]
        ts.validate()
        out[name] = ts
    return out


@dataclasses.dataclass
class ShedDecision:
    """Why a request was shed, and how long the client should wait."""

    reason: str  # tenant_rate | tenant_inflight | fair_share
    retry_after_s: float


# Live-account table bound: tenant ids come straight from a client
# header, so without a cap a caller cycling random ids grows router
# memory (and every admit's fair-share scan) without bound. Idle
# accounts past the bound are evicted LRU; accounts holding inflight
# streams are never evicted (their population is bounded by actual
# concurrency).
MAX_ACCOUNTS = 1024


class _Account:
    """Live accounting for one tenant id."""

    __slots__ = ("spec", "tokens", "refilled_at", "inflight", "last_used")

    def __init__(self, spec: TenantSpec, now: float):
        self.spec = spec
        # A full burst at start: the first requests of a quiet tenant
        # never pay a cold-bucket penalty.
        self.tokens = spec.burst if spec.burst > 0 else max(1.0, spec.rate_qps)
        self.refilled_at = now
        self.inflight = 0
        self.last_used = now


class TenantGovernor:
    """Admission decisions for the router's front door.

    Thread-safe (event loop + introspection endpoints + tests);
    ``clock`` is injectable so token-bucket behavior is deterministic
    under test.
    """

    def __init__(
        self,
        tenants: Optional[Mapping[str, TenantSpec]] = None,
        total_inflight_cap: int = 0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self._specs = dict(tenants or {})
        self._cap = int(total_inflight_cap)
        self._clock = clock
        self._lock = threading.Lock()
        self._accounts: Dict[str, _Account] = {}  # guarded by self._lock
        self._keys: Dict[str, str] = {}
        for spec in self._specs.values():
            for key in spec.api_keys:
                self._keys[key] = spec.name

    # ------------------------------------------------------------------ #
    def resolve(self, headers: Mapping[str, str]) -> str:
        """Tenant id for a request: explicit header wins, then an API
        key mapped by the spec, then ``default``."""
        tenant = headers.get(TENANT_HEADER, "").strip()
        if tenant:
            return tenant
        auth = headers.get(AUTH_HEADER, "").strip()
        if auth.lower().startswith("bearer "):
            key = auth[len("bearer "):].strip()
            mapped = self._keys.get(key)
            if mapped:
                return mapped
        return DEFAULT_TENANT

    def _spec_for(self, tenant: str) -> TenantSpec:
        spec = self._specs.get(tenant)
        if spec is not None:
            return spec
        base = self._specs.get(DEFAULT_TENANT)
        if base is not None:
            # Unknown ids get the default LIMITS but their own account.
            return dataclasses.replace(base, name=tenant, api_keys=())
        return TenantSpec(name=tenant)

    def _account(self, tenant: str, now: float) -> _Account:
        """Caller holds self._lock."""
        acct = self._accounts.get(tenant)
        if acct is None:
            if len(self._accounts) >= MAX_ACCOUNTS:
                idle = [
                    (a.last_used, name)
                    for name, a in self._accounts.items()
                    if a.inflight == 0
                ]
                if idle:
                    del self._accounts[min(idle)[1]]
            acct = _Account(self._spec_for(tenant), now)
            self._accounts[tenant] = acct
        acct.last_used = now
        return acct

    # ------------------------------------------------------------------ #
    def admit(self, tenant: str) -> Optional[ShedDecision]:
        """None = admitted (one inflight slot charged — the caller MUST
        :meth:`release` on completion); otherwise the shed decision."""
        now = self._clock()
        with self._lock:
            acct = self._account(tenant, now)
            spec = acct.spec
            if spec.rate_qps > 0:
                cap = spec.burst if spec.burst > 0 else max(1.0, spec.rate_qps)
                acct.tokens = min(
                    cap, acct.tokens + (now - acct.refilled_at) * spec.rate_qps
                )
                acct.refilled_at = now
                if acct.tokens < 1.0:
                    return ShedDecision(
                        "tenant_rate",
                        max(0.05, (1.0 - acct.tokens) / spec.rate_qps),
                    )
            if spec.max_inflight > 0 and acct.inflight >= spec.max_inflight:
                return ShedDecision("tenant_inflight", 1.0)
            if self._cap > 0:
                total = sum(a.inflight for a in self._accounts.values())
                if total >= self._cap:
                    total_weight = sum(
                        a.spec.weight for a in self._accounts.values()
                    ) or 1.0
                    fair = self._cap * (spec.weight / total_weight)
                    if acct.inflight >= fair:
                        return ShedDecision("fair_share", 1.0)
            if spec.rate_qps > 0:
                acct.tokens -= 1.0
            acct.inflight += 1
            return None

    def release(self, tenant: str) -> None:
        with self._lock:
            acct = self._accounts.get(tenant)
            if acct is not None and acct.inflight > 0:
                acct.inflight -= 1

    # ------------------------------------------------------------------ #
    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """Live per-tenant accounting for ``GET /internal/fleet``."""
        with self._lock:
            return {
                name: {
                    "inflight": acct.inflight,
                    "tokens": round(acct.tokens, 3),
                    "weight": acct.spec.weight,
                    "rate_qps": acct.spec.rate_qps,
                    "max_inflight": acct.spec.max_inflight,
                }
                for name, acct in sorted(self._accounts.items())
            }
