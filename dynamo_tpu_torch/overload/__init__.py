"""Overload plane of the port (a copy of the JAX package's overload/):
request deadlines and priority classes minted at the frontend
(deadline.py), per-engine waiting-queue budgets with a load-derived
Retry-After (admission.py), the retriable ``EngineOverloadedError`` and
the mid-stream ``PreemptedError`` (errors.py), the KV router's live load
view (load.py) and the ``dynamo_overload_*`` families (metrics.py). The
engine enforces the budgets and preempts by priority; the frontend
answers a refused request with 429 and Retry-After."""
