"""Per-tenant admission quotas and weighted fair share (a copy of the JAX
package's tenancy/quotas.py).

Sits ON TOP of the overload plane: the global
``AdmissionController`` still bounds the whole backlog; ``TenantQuotas``
additionally bounds each tenant's OWN slice of it, so one tenant's
storm exhausts that tenant's budget — and bounces with a Retry-After
derived from that tenant's own observed queue waits — long before it
can crowd the global queue.

Tenant identity is minted at the frontend (``X-Tenant-Id`` header or
the ``nvext.tenant`` body field; legacy traffic falls into the
``default`` tenant) and rides ``PreprocessedRequest.tenant`` end to
end. Fair share uses start-time virtual clocks (SFQ): each tenant
advances a virtual-finish-time counter by prompt-cost / weight per
enqueued request, and the engine's waiting queue orders same-priority
entries by that stamp — a storming tenant's backlog self-paces behind
its own stamps while a light tenant's fresh arrival lands near the
global virtual clock, i.e. near the queue head.
"""
from __future__ import annotations

import logging
import threading
from collections import deque
from typing import Any, Optional

from dynamo_tpu_torch.overload.admission import (
    DEFAULT_QUEUE_WAIT_S,
    RETRY_AFTER_MAX_S,
    RETRY_AFTER_MIN_S,
)
from dynamo_tpu_torch.overload.errors import EngineOverloadedError

log = logging.getLogger(__name__)

TENANT_HEADER = "X-Tenant-Id"
DEFAULT_TENANT = "default"

# per-tenant queue-wait observations kept for the p50 retry hint
_WAIT_WINDOW = 128


def parse_tenant(value: Any) -> str:
    """Header/body tenant value -> a label-safe tenant id. Malformed or
    empty values fall into the default tenant — a bad hint must not
    fail the request."""
    if value is None:
        return DEFAULT_TENANT
    t = "".join(
        ch for ch in str(value).strip() if ch not in '"\\\n\r'
    )
    return t[:64] or DEFAULT_TENANT


class TenantQuotas:
    """Pure per-tenant budget arithmetic + queue-wait accounting.

    Budgets are UNIFORM caps applied to each tenant's own backlog
    (0 = unbounded, matching AdmissionController's convention);
    ``weights`` biases the fair-share dequeue order, not the budgets."""

    def __init__(
        self,
        max_waiting_requests: int = 0,
        max_waiting_prefill_tokens: int = 0,
        weights: Optional[dict[str, float]] = None,
    ):
        self.max_waiting_requests = max(0, int(max_waiting_requests))
        self.max_waiting_prefill_tokens = max(
            0, int(max_waiting_prefill_tokens)
        )
        self._weights = dict(weights or {})
        self._lock = threading.Lock()
        self._waits: dict[str, deque] = {}

    @property
    def bounded(self) -> bool:
        return bool(self.max_waiting_requests
                    or self.max_waiting_prefill_tokens)

    def weight(self, tenant: str) -> float:
        """Fair-share weight (default 1.0; floored so a mistyped zero
        weight can't divide the virtual clock by zero)."""
        return max(1e-3, float(self._weights.get(tenant, 1.0)))

    def note_queue_wait(self, tenant: str, wait_s: float) -> None:
        with self._lock:
            dq = self._waits.get(tenant)
            if dq is None:
                dq = self._waits[tenant] = deque(maxlen=_WAIT_WINDOW)
            dq.append(float(wait_s))

    def queue_wait_p50(self, tenant: str) -> Optional[float]:
        with self._lock:
            dq = self._waits.get(tenant)
            if not dq:
                return None
            vals = sorted(dq)
        return vals[len(vals) // 2]

    def retry_after_s(self, tenant: str, waiting_requests: int) -> float:
        """Expected drain time of THIS tenant's backlog: the tenant's
        own observed per-request queue wait (p50) x its depth, clamped
        to the overload plane's sane window."""
        per_req = self.queue_wait_p50(tenant)
        if per_req is None or per_req <= 0:
            per_req = DEFAULT_QUEUE_WAIT_S
        est = max(1, waiting_requests) * per_req
        return min(RETRY_AFTER_MAX_S, max(RETRY_AFTER_MIN_S, est))

    def over_budget(self, waiting_requests: int,
                    waiting_tokens: int) -> bool:
        if (self.max_waiting_requests
                and waiting_requests >= self.max_waiting_requests):
            return True
        if (self.max_waiting_prefill_tokens
                and waiting_tokens >= self.max_waiting_prefill_tokens):
            return True
        return False

    def check(self, tenant: str, waiting_requests: int,
              waiting_tokens: int) -> None:
        """Raise the retriable overload error — carrying the tenant key
        and a TENANT-derived Retry-After — when the tenant's backlog is
        at its budget."""
        if not self.over_budget(waiting_requests, waiting_tokens):
            return
        raise EngineOverloadedError(
            f"tenant {tenant!r} over quota: {waiting_requests} waiting "
            f"requests / {waiting_tokens} waiting prefill tokens "
            f"(max {self.max_waiting_requests} requests, "
            f"{self.max_waiting_prefill_tokens} tokens per tenant)",
            retry_after_s=self.retry_after_s(tenant, waiting_requests),
            tenant=tenant,
        )

    def snapshot(self) -> dict[str, dict[str, Any]]:
        """Per-tenant quota view for /debug/tenants."""
        with self._lock:
            tenants = list(self._waits)
        out: dict[str, dict[str, Any]] = {}
        for t in tenants:
            out[t] = {
                "weight": self.weight(t),
                "queue_wait_p50_s": self.queue_wait_p50(t),
            }
        return out
