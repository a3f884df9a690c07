"""Request deadlines and priority classes — minted at the frontend,
threaded through ``PreprocessedRequest`` (a copy of the JAX package's
overload/deadline.py).

Deadlines are ABSOLUTE unix times (``time.time()`` seconds): they cross
process boundaries (frontend -> router -> worker) where monotonic clocks
don't compare; the engine's shed check tolerates small skew by
construction (a request shed a few hundred ms late just wastes that
long in queue, never correctness).

Clients express a deadline as a RELATIVE budget — the
``X-Request-Timeout-Ms`` header or the ``nvext.timeout_ms`` body field —
and a priority class via ``X-Request-Priority`` / ``nvext.priority``
(two classes: 0 = normal, 1 = high; a high-priority arrival queues ahead
of waiting low-priority work).
"""
from __future__ import annotations

import time
from typing import Any, Optional

from dynamo_tpu_torch.tenancy.quotas import TENANT_HEADER, parse_tenant

DEADLINE_HEADER = "X-Request-Timeout-Ms"
PRIORITY_HEADER = "X-Request-Priority"

PRIORITY_HIGH = 1
PRIORITY_NORMAL = 0

_PRIORITY_NAMES = {
    "high": PRIORITY_HIGH,
    "normal": PRIORITY_NORMAL,
    "low": PRIORITY_NORMAL,
}


def mint_deadline(timeout_ms: float,
                  now: Optional[float] = None) -> Optional[float]:
    """Relative budget (ms) -> absolute unix deadline; None for
    non-positive/unparseable budgets (no deadline)."""
    try:
        budget = float(timeout_ms)
    except (TypeError, ValueError):
        return None
    if budget <= 0:
        return None
    return (time.time() if now is None else now) + budget / 1e3


def parse_priority(value: Any) -> int:
    """Header/body priority value -> the two-class field. Unknown values
    map to normal — a malformed hint must not fail the request."""
    if value is None:
        return PRIORITY_NORMAL
    if isinstance(value, bool):
        return PRIORITY_HIGH if value else PRIORITY_NORMAL
    if isinstance(value, (int, float)):
        return PRIORITY_HIGH if value >= 1 else PRIORITY_NORMAL
    name = str(value).strip().lower()
    if name in _PRIORITY_NAMES:
        return _PRIORITY_NAMES[name]
    try:
        return PRIORITY_HIGH if int(name) >= 1 else PRIORITY_NORMAL
    except ValueError:
        return PRIORITY_NORMAL


def apply_request_hints(pre: Any, headers: Any = None,
                        nvext: Optional[dict] = None) -> None:
    """Fold priority/deadline/tenant hints onto a PreprocessedRequest.
    Body (nvext) first, headers override — a proxy injecting headers
    wins over a stale client body."""
    nvext = nvext or {}
    if nvext.get("priority") is not None:
        pre.priority = parse_priority(nvext.get("priority"))
    if nvext.get("timeout_ms") is not None:
        pre.deadline = mint_deadline(nvext.get("timeout_ms"))
    if nvext.get("tenant") is not None:
        pre.tenant = parse_tenant(nvext.get("tenant"))
    if headers is not None:
        hp = headers.get(PRIORITY_HEADER)
        if hp is not None:
            pre.priority = parse_priority(hp)
        ht = headers.get(DEADLINE_HEADER)
        if ht is not None:
            d = mint_deadline(ht)
            if d is not None:
                pre.deadline = d
        hten = headers.get(TENANT_HEADER)
        if hten is not None:
            pre.tenant = parse_tenant(hten)
